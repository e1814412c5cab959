"""Host-side data layer: folder datasets, letterboxing, prefetching loader
(the port's own copy of the parts of `s3od_tpu/training/data.py` that the
test-mode training path uses).

Mirrors the reference data semantics (`model_training/dataset.py`):
- folder-per-dataset `images/` + `masks/` pairs, mask matched by stem
  (`dataset.py:100-109`)
- deterministic split: sorted file list, seed-shuffled, first val_split
  fraction is val (`dataset.py:75-98`)
- corrupt/mismatched samples replaced by a random other index
  (`dataset.py:130-144`) with a consecutive-error circuit breaker
- multiple roots concatenated (`dataset.py:369-401`)

The host decodes and letterboxes to the fixed canvas (uint8); a
thread-pool prefetcher keeps a small queue of ready batches, and
`device_prefetch` overlaps the upload with the running step.

Not ported yet: the host geometric augmentation and RandomResizedCrop
(they wait with the augmentation, ROADMAP Queue 1 item 8), the FLUX
feature dataset (teacher training), and the memmap cache, for which
`dataset.cache` raises `NotImplementedError`.
"""

from __future__ import annotations

import logging
import os
import queue
import random
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

VALID_EXTENSIONS = {".jpg", ".jpeg", ".png"}

def _resize_longest(img: np.ndarray, size: int, is_mask: bool) -> np.ndarray:
    h, w = img.shape[:2]
    scale = size / max(h, w)
    nh, nw = min(size, max(1, round(h * scale))), min(size, max(1, round(w * scale)))
    try:
        import cv2

        interp = cv2.INTER_NEAREST if is_mask else cv2.INTER_LINEAR
        return cv2.resize(img, (nw, nh), interpolation=interp)
    except ImportError:  # pragma: no cover
        from PIL import Image

        mode = Image.NEAREST if is_mask else Image.BILINEAR
        return np.array(Image.fromarray(img).resize((nw, nh), mode))


def letterbox(
    image: np.ndarray, mask: Optional[np.ndarray], size: int
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """LongestMaxSize + zero-pad to (size, size), top-left anchored padding
    split evenly (albumentations PadIfNeeded centers; we center too)."""
    img_r = _resize_longest(image, size, is_mask=False)
    h, w = img_r.shape[:2]
    top, left = (size - h) // 2, (size - w) // 2
    canvas = np.zeros((size, size, 3), dtype=np.uint8)
    canvas[top : top + h, left : left + w] = img_r
    mask_c = None
    if mask is not None:
        mask_r = _resize_longest(mask, size, is_mask=True)
        mask_c = np.zeros((size, size), dtype=mask.dtype)
        mask_c[top : top + h, left : left + w] = mask_r
    return canvas, mask_c



class MaskFolderDataset:
    """One `images/` + `masks/` root with a deterministic train/val split."""

    def __init__(
        self,
        root_dir: str,
        image_size: int,
        split: str = "train",
        val_split: float = 0.1,
        seed: int = 42,
        debug_subset_fraction: Optional[float] = None,
    ):
        self.root_dir = Path(root_dir)
        self.image_size = image_size
        self.split = split
        self.images_dir = self.root_dir / "images"
        self.masks_dir = self.root_dir / "masks"

        files = sorted(
            f
            for f in os.listdir(self.images_dir)
            if Path(f).suffix.lower() in VALID_EXTENSIONS
            and self._mask_path(f) is not None
        )
        rng = random.Random(seed)
        rng.shuffle(files)
        n_val = int(len(files) * val_split)
        self.files = files[:n_val] if split == "val" else files[n_val:]
        if debug_subset_fraction is not None:
            self.files = self.files[: int(len(self.files) * debug_subset_fraction)]
        self._consecutive_errors = 0

    def _mask_path(self, img_file: str) -> Optional[Path]:
        base = Path(img_file).stem
        for ext in (".png", ".jpg", ".jpeg"):
            p = self.masks_dir / (base + ext)
            if p.exists():
                return p
        return None

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (letterboxed uint8 image (S,S,3), float32 mask (S,S) in [0,1]).
        Corrupt samples are swallowed and replaced by a random index, with a
        10-consecutive-failure circuit breaker."""
        from PIL import Image

        for _ in range(11):
            try:
                f = self.files[idx]
                img = np.array(Image.open(self.images_dir / f).convert("RGB"))
                mask = np.array(Image.open(self._mask_path(f)).convert("L"))
                if img.shape[:2] != mask.shape[:2]:
                    raise ValueError("image/mask size mismatch")
                img_l, mask_l = letterbox(img, mask, self.image_size)
                self._consecutive_errors = 0
                return img_l, mask_l.astype(np.float32) / 255.0
            except Exception as e:  # noqa: BLE001
                logging.error("Error loading %s: %s", self.files[idx], e)
                self._consecutive_errors += 1
                if self._consecutive_errors > 10:
                    raise RuntimeError(
                        f"Too many consecutive dataset errors: {e}"
                    ) from e
                idx = random.randint(0, len(self) - 1)
        raise RuntimeError("unreachable")



class ConcatMaskDataset:
    def __init__(self, datasets: Sequence[MaskFolderDataset]):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def load(self, idx: int):
        d = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.datasets[d].load(idx - int(self.offsets[d]))



def build_dataset(
    dataset_paths: Sequence[str],
    image_size: int,
    split: str,
    val_split: float = 0.1,
    seed: int = 42,
    debug_subset_fraction: Optional[float] = None,
    cache: bool = False,
):
    """One `MaskFolderDataset` per root, concatenated."""
    if cache:
        raise NotImplementedError(
            "dataset.cache (the memmap letterbox cache) is not ported yet "
            "(ROADMAP, Queue 1, item 8)")
    parts = [
        MaskFolderDataset(p, image_size, split, val_split, seed,
                          debug_subset_fraction=debug_subset_fraction)
        for p in dataset_paths
    ]
    return parts[0] if len(parts) == 1 else ConcatMaskDataset(parts)


class PrefetchLoader:
    """Thread-pool batch loader.

    Yields {"images": uint8 (B,S,S,3), "masks": float32 (B,S,S) in [0,1]}
    numpy batches, with deterministic per-epoch shuffling from (seed,
    epoch). The JAX loader's host augmentations (RandomResizedCrop, the
    geometric warps) wait with the augmentation (ROADMAP, Queue 1, item 8).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 42,
        num_threads: int = 8,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch

    def _host_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = self._host_order(epoch)
        n_batches = len(self)

        def load_batch(b):
            idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
            imgs, masks = zip(*(self.dataset.load(int(i)) for i in idxs))
            return {"images": np.stack(imgs),
                    "masks": np.stack(masks).astype(np.float32)}

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # Bounded in-flight window: at most num_threads + prefetch batches
            # are ever submitted but undrained, so a slow consumer backs
            # pressure onto loading instead of accumulating completed batch
            # arrays in Future objects (tens of GB on large epochs).
            sentinel = None  # end-of-epoch; an Exception instance = failure
            try:
                window = self.num_threads + self.prefetch
                with ThreadPoolExecutor(self.num_threads) as pool:
                    inflight: "deque" = deque(
                        pool.submit(load_batch, b)
                        for b in range(min(window, n_batches))
                    )
                    next_b = len(inflight)
                    while inflight:
                        fut = inflight.popleft()
                        if stop.is_set():
                            for f2 in inflight:
                                f2.cancel()
                            return
                        result = fut.result()
                        if next_b < n_batches:
                            inflight.append(pool.submit(load_batch, next_b))
                            next_b += 1
                        while not stop.is_set():
                            try:
                                q.put(result, timeout=0.5)
                                break
                            except queue.Full:
                                continue
            except BaseException as e:  # noqa: BLE001 — surfaced in consumer
                # Without this, a loader error kills the producer thread
                # before the sentinel is enqueued and the training loop
                # blocks on q.get() forever.
                sentinel = e
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.5)
                    break
                except queue.Full:
                    continue

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def device_prefetch(iterator, put_fn, depth: int = 2):
    """Overlap the host->device upload with device compute: a worker
    thread pulls host batches from ``iterator``, runs ``put_fn(step_index,
    batch)`` (the upload), and keeps up to ``depth`` device-resident
    batches queued ahead of the consumer.

    Yields (step_index, device_batch) in order. The worker's uploads are
    queued on the device's default stream, in order with the steps the
    main thread launches there.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        sentinel = None
        try:
            for i, batch in enumerate(iterator):
                if stop.is_set():
                    return
                item = (i, put_fn(i, batch))
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 — surfaced in consumer
            sentinel = e
        while not stop.is_set():
            try:
                q.put(sentinel, timeout=0.5)
                break
            except queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()

