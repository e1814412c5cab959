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

The host decodes and letterboxes to the fixed canvas (uint8) and draws
each sample's geometric augmentation (RandomResizedCrop, Rotate and the
synthetic distortions) with the JAX loader's `random.Random` calls, in its
order; the device samples them (`s3od_torch.ops.warp.apply_host_geometry`),
so no OpenCV call sits on the augmentation path. A thread-pool prefetcher
keeps a small queue of ready batches, and `device_prefetch` overlaps the
upload (and the augmentation) with the running step.

Teacher training reads `FluxFeatureDataset`: bucket-resized images (no
letterbox) with their per-image FLUX features, one sample a batch; the
loader then collates dict samples leaf by leaf.
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
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from s3od_torch.parallel.mesh import shard_batch

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



def draw_random_resized_crop(rng: random.Random, size: int,
                             scale=(0.85, 1.0), ratio=(0.9, 1.1)
                             ) -> Tuple[int, int, int, int]:
    """RandomResizedCrop's box (y0, x0, ch, cw) on the letterboxed canvas
    (reference `transforms.py:35-40`), with the draws of the JAX loader's
    `_random_resized_crop` (`s3od_tpu/training/data.py:77-100`)."""
    area = size * size * rng.uniform(*scale)
    r = rng.uniform(*ratio)
    cw = min(size, int(round((area * r) ** 0.5)))
    ch = min(size, int(round((area / r) ** 0.5)))
    x0 = rng.randint(0, size - cw)
    y0 = rng.randint(0, size - ch)
    return y0, x0, ch, cw


def perspective_matrix(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 3x3 homography (float64, h22 = 1) taking the four (x, y) points
    `src` to `dst`, by the 8x8 linear solve of cv2.getPerspectiveTransform."""
    a = np.zeros((8, 8))
    rhs = np.zeros(8)
    for i in range(4):
        x, y = float(src[i, 0]), float(src[i, 1])
        u, v = float(dst[i, 0]), float(dst[i, 1])
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        rhs[i], rhs[i + 4] = u, v
    return np.append(np.linalg.solve(a, rhs), 1.0).reshape(3, 3)


def draw_host_geometry(rng: random.Random, h: int, w: int, mode: str,
                       p_rotate: float = 0.2, rotate_limit: float = 15.0,
                       p_distort: float = 0.4, distort_limit: float = 0.3,
                       grid_steps: int = 6) -> Dict:
    """The draws of the JAX loader's `host_geometric`
    (`s3od_tpu/training/data.py:103-201`), call for call: Rotate +-15 deg
    p=.2 (`transforms.py:41`), then in synthetic mode the distortion OneOf
    p=.4 — OpticalDistortion w=.3 / GridDistortion w=.3 / ElasticTransform
    w=.2 / Perspective w=.15 (`transforms.py:159-178`).

    Returns {"angle": degrees or None, "distort": None or (kind, params)}:
    ("optical", k), ("grid", (ys (h,), xs (w,)) float32 source rows and
    columns), ("elastic", (gh, gw, 2) float32 noise) or ("perspective",
    the 3x3 float64 matrix from output to source pixels). The device
    applies them (`s3od_torch.ops.warp.apply_host_geometry`).
    """
    out: Dict = {"angle": None, "distort": None}
    if rng.random() < p_rotate:
        out["angle"] = rng.uniform(-rotate_limit, rotate_limit)
    if mode == "synthetic" and rng.random() < p_distort:
        # normalized OneOf weights .3/.3/.2/.15
        r = rng.random() * 0.95
        if r < 0.30:
            out["distort"] = ("optical",
                              rng.uniform(-distort_limit, distort_limit))
        elif r < 0.60:
            def axis_map(n):
                stretch = np.array(
                    [1.0 + rng.uniform(-distort_limit, distort_limit)
                     for _ in range(grid_steps)])
                bounds = np.concatenate(
                    [[0.0], np.cumsum(stretch / stretch.sum())]) * (n - 1.0)
                t = np.arange(n, dtype=np.float32) / (n - 1.0) * grid_steps
                i0 = np.clip(np.floor(t).astype(int), 0, grid_steps - 1)
                frac = t - i0
                return (bounds[i0] + (bounds[i0 + 1] - bounds[i0]) * frac
                        ).astype(np.float32)
            out["distort"] = ("grid", (axis_map(h), axis_map(w)))
        elif r < 0.80:
            alpha, sigma = 1.0, 25.0
            gh = max(2, int(round(h / sigma)))
            gw = max(2, int(round(w / sigma)))
            nprng = np.random.default_rng(rng.getrandbits(32))
            out["distort"] = ("elastic", nprng.standard_normal(
                (gh, gw, 2)).astype(np.float32) * alpha)
        else:
            s = rng.uniform(0.05, 0.1)
            nprng = np.random.default_rng(rng.getrandbits(32))
            corners = np.array(
                [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], np.float32)
            jitter = nprng.standard_normal((4, 2)).astype(np.float32) * (
                s * np.array([w, h], np.float32))
            out["distort"] = ("perspective",
                              perspective_matrix(corners, corners + jitter))
    return out


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



class FluxFeatureDataset(MaskFolderDataset):
    """Dataset variant for FLUX-teacher training: images bucket-resized
    (`datagen/resizer.FluxResizer`, no letterbox), per-image `.npz`
    features (layer_0..3 + category/background concept maps, fp16) matched
    by stem with the dataset-prefix fallbacks; files without features are
    dropped (`s3od_tpu/training/data.py:274-330`, reference
    `model_training/dataset.py:147-250`). The trainer runs it at batch 1
    (the buckets differ in shape)."""

    DATASET_PREFIXES = ("DUTS-TR", "DIS-TR", "HRSOD-TR", "UHRSD-TR")

    def __init__(self, root_dir: str, image_size: int, split: str = "train",
                 val_split: float = 0.1, seed: int = 42,
                 flux_features_dir: Optional[str] = None,
                 feature_layers: Sequence[int] = (0, 1, 2, 3),
                 debug_subset_fraction: Optional[float] = None):
        super().__init__(root_dir, image_size, split, val_split, seed,
                         debug_subset_fraction)
        from s3od_torch.datagen.resizer import FluxResizer

        self.resizer = FluxResizer()
        self.feature_layers = list(feature_layers)
        self.feature_mapping: Dict[str, Path] = {}
        if flux_features_dir:
            feats = Path(flux_features_dir) / "features"
            available = ({p.stem: p for p in feats.glob("*.npz")}
                         if feats.is_dir() else {})
            for f in self.files:
                stem = Path(f).stem
                hit = available.get(stem)
                if hit is None:
                    for prefix in self.DATASET_PREFIXES:
                        hit = available.get(f"{prefix}_{stem}")
                        if hit is not None:
                            break
                if hit is not None:
                    self.feature_mapping[f] = hit
            before = len(self.files)
            self.files = [f for f in self.files if f in self.feature_mapping]
            logging.info(
                "FluxFeatureDataset: %d -> %d files with features (%.1f%%)",
                before, len(self.files),
                100.0 * len(self.files) / max(before, 1))

    def load(self, idx: int):
        """-> {"images": uint8 (th, tw, 3) at the bucket, "masks": float32
        (th, tw) in [0, 1], "transformer_features": [float32 (seq, dim)]
        per layer, "concept_maps": {"category", "background"} float32}."""
        from PIL import Image

        f = self.files[idx]
        img = np.array(Image.open(self.images_dir / f).convert("RGB"))
        mask = np.array(Image.open(self._mask_path(f)).convert("L"))
        img_r, (th, tw) = self.resizer.resize_image(img)
        mask_r = self.resizer.resize_mask(mask, (th, tw))
        out = {"images": img_r,
               "masks": mask_r.astype(np.float32) / 255.0}
        with np.load(self.feature_mapping[f]) as z:
            out["transformer_features"] = [
                z[f"layer_{i}"].astype(np.float32) for i in self.feature_layers]
            out["concept_maps"] = {
                "category": z["category"].astype(np.float32),
                "background": z["background"].astype(np.float32)}
        return out


def collate_dicts(samples: Sequence[Dict]) -> Dict:
    """Dict samples (`FluxFeatureDataset.load`) stacked leaf by leaf: the
    JAX loader's dict collation (`data.py:474-485`)."""
    first = samples[0]
    return {
        "images": np.stack([s["images"] for s in samples]),
        "masks": np.stack([s["masks"] for s in samples]).astype(np.float32),
        "transformer_features": [
            np.stack([s["transformer_features"][i] for s in samples])
            for i in range(len(first["transformer_features"]))],
        "concept_maps": {k: np.stack([s["concept_maps"][k] for s in samples])
                         for k in first["concept_maps"]},
    }


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
    flux_features_dir: Optional[str] = None,
    cache: bool = False,
    cache_root: Optional[str] = None,
):
    """One dataset per root, concatenated: `FluxFeatureDataset` when
    `flux_features_dir` is given (teacher training; no cache on that
    path, the bucket shapes vary), else `MaskFolderDataset`. ``cache=True``
    serves pre-decoded letterbox canvases from uint8 memmap shards
    (`s3od_torch.training.cache`): decode once per (root, image_size)
    instead of per epoch; masks then flow uint8 end to end."""
    if flux_features_dir:
        parts = [
            FluxFeatureDataset(p, image_size, split, val_split, seed,
                               flux_features_dir=flux_features_dir,
                               debug_subset_fraction=debug_subset_fraction)
            for p in dataset_paths
        ]
    elif cache:
        from s3od_torch.training.cache import CachedMaskFolderDataset

        parts = [
            CachedMaskFolderDataset(p, image_size, split, val_split, seed,
                                    debug_subset_fraction=debug_subset_fraction,
                                    cache_root=cache_root)
            for p in dataset_paths
        ]
    else:
        parts = [
            MaskFolderDataset(p, image_size, split, val_split, seed,
                              debug_subset_fraction=debug_subset_fraction)
            for p in dataset_paths
        ]
    return parts[0] if len(parts) == 1 else ConcatMaskDataset(parts)


class PrefetchLoader:
    """Thread-pool batch loader with the host's geometric draws.

    Yields {"images": uint8 (B,S,S,3), "masks": (B,S,S)} numpy batches —
    masks float32 in [0,1], or uint8 0..255 when the dataset is a
    memmap-cached one (`training/cache.py`) — with deterministic
    per-epoch shuffling from (seed, epoch). When it augments
    (`random_resized_crop_p` > 0 or a `geometric_mode`), a batch also
    carries "geometry": one dict per sample ({"crop": (y0, x0, ch, cw)}
    and/or `draw_host_geometry`'s keys), drawn from the JAX loader's
    per-batch `random.Random((seed * 1000 + epoch) * 100003 + b)` in its
    order: every crop gate and box, then every sample's rotation and
    distortion. A dataset of dict samples (`FluxFeatureDataset`) yields
    `collate_dicts` batches, never augmented.
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
        random_resized_crop_p: float = 0.0,
        geometric_mode: Optional[str] = None,
        process_shard: Optional[Tuple[int, int]] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.rrc_p = random_resized_crop_p
        # "regular" | "synthetic": draw the rotation / distortion per sample.
        self.geometric_mode = geometric_mode
        # Data parallelism: (rank, world). Every rank shuffles the same
        # global order (seed + epoch) and keeps the interleaved slice
        # r::world, truncated to a multiple of world so that every rank
        # yields as many batches (the JAX loader's `process_shard`,
        # `s3od_tpu/training/data.py:440-455`); batch_size is per rank.
        # Batch b of rank r is then rows r::world of the global batch b
        # that one process with batch_size * world would load, and the
        # geometry is drawn for that global batch and sliced the same way,
        # so the augmentation does not depend on the world size.
        self.process_shard = process_shard

    def _host_order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        if self.process_shard is not None:
            w = self.process_shard[1]
            order = shard_batch(order[: len(order) - len(order) % w],
                                self.process_shard)
        return order

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.process_shard is not None:
            n = n // self.process_shard[1]
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def draw_geometry(self, epoch: int, b: int, n: int, size: int):
        """Batch b's per-sample geometry (None when the loader does not
        augment)."""
        if not (self.rrc_p > 0 or self.geometric_mode):
            return None
        w = self.process_shard[1] if self.process_shard is not None else 1
        return shard_batch(self._draw(epoch, b, n * w, size),
                           self.process_shard)

    def _draw(self, epoch: int, b: int, n: int, size: int):
        rng = random.Random((self.seed * 1000 + epoch) * 100003 + b)
        geometry: List[Dict] = [{} for _ in range(n)]
        if self.rrc_p > 0:
            for g in geometry:
                if rng.random() < self.rrc_p:
                    g["crop"] = draw_random_resized_crop(rng, size)
        if self.geometric_mode:
            for g in geometry:
                g.update(draw_host_geometry(rng, size, size,
                                            self.geometric_mode))
        return geometry

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = self._host_order(epoch)
        n_batches = len(self)

        def load_batch(b):
            idxs = order[b * self.batch_size : (b + 1) * self.batch_size]
            samples = [self.dataset.load(int(i)) for i in idxs]
            if isinstance(samples[0], dict):
                return collate_dicts(samples)
            imgs, masks = zip(*samples)
            masks_arr = np.stack(masks)
            if masks_arr.dtype != np.uint8:
                masks_arr = masks_arr.astype(np.float32)
            out = {"images": np.stack(imgs), "masks": masks_arr}
            geometry = self.draw_geometry(epoch, b, len(imgs),
                                          imgs[0].shape[0])
            if geometry is not None:
                out["geometry"] = geometry
            return out

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

