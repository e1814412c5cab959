"""Pre-decoded letterbox cache: decode each dataset image ONCE, serve memmap
slices (the port's copy of `s3od_tpu/training/cache.py`; the shards have
the same layout, so a cache written by either package is read by the
other).

PNG decode + letterbox costs the host seconds per 1024px batch, every
epoch; the reference pays it through DataLoader workers
(`synth_sod/src/synth_sod/model_training/dataset.py:100-144`), which hide
it only with enough CPU cores. One build pass decodes + letterboxes every
image/mask of a root to the fixed canvas and writes uint8 memmap shards;
every epoch after that, a "load" is a page-cache memcpy.

Layout (per root, per canvas size), under ``<root>/.s3od_cache/s{size}/``:
  images.npy  uint8 (N, S, S, 3)  letterboxed canvases
  masks.npy   uint8 (N, S, S)     letterboxed masks (0..255)
  meta.json   {"version", "image_size", "files": [...]}

The cache is keyed by the sorted file list: adding/removing/renaming files
invalidates it (content changes with unchanged names are NOT detected —
matching the reference's assumption that dataset folders are immutable).
Builds are atomic (temp dir + rename), so concurrent SLURM-style shards
race benignly: one wins the rename, the rest use it.

Masks stay uint8 end-to-end: the loader ships them uint8 over the wire and
the train step decodes to [0,1] float on device (`train_step.preprocess`)
— caching float32 would quadruple both disk and upload bytes.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from s3od_torch.training.data import MaskFolderDataset, letterbox

CACHE_VERSION = 1

logger = logging.getLogger("s3od_torch.cache")


def _cache_dir(root_dir: Path, image_size: int,
               cache_root: Optional[str]) -> Path:
    base = Path(cache_root) if cache_root else root_dir / ".s3od_cache"
    return base / f"s{image_size}"


def _is_valid(cdir: Path, image_size: int, files) -> bool:
    meta_p = cdir / "meta.json"
    if not (meta_p.exists() and (cdir / "images.npy").exists()
            and (cdir / "masks.npy").exists()):
        return False
    try:
        meta = json.loads(meta_p.read_text())
    except (json.JSONDecodeError, OSError):
        return False
    return (meta.get("version") == CACHE_VERSION
            and meta.get("image_size") == image_size
            and meta.get("files") == list(files))


def build_cache(root_dir, image_size: int, files,
                cache_root: Optional[str] = None) -> Path:
    """Decode + letterbox every (image, mask) pair of ``files`` once into
    uint8 memmap shards. Returns the cache directory. No-op if a valid
    cache for this exact file list already exists."""
    from PIL import Image

    root = Path(root_dir)
    cdir = _cache_dir(root, image_size, cache_root)
    if _is_valid(cdir, image_size, files):
        return cdir

    cdir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".build-", dir=cdir.parent))
    n, s = len(files), image_size
    logger.info("building letterbox cache: %d images @%dpx -> %s "
                "(%.2f GB)", n, s, cdir, n * (s * s * 4) / 1e9)
    try:
        imgs = np.lib.format.open_memmap(
            tmp / "images.npy", mode="w+", dtype=np.uint8, shape=(n, s, s, 3))
        masks = np.lib.format.open_memmap(
            tmp / "masks.npy", mode="w+", dtype=np.uint8, shape=(n, s, s))
        helper = MaskFolderDataset.__new__(MaskFolderDataset)
        helper.masks_dir = root / "masks"
        for i, f in enumerate(files):
            img = np.array(Image.open(root / "images" / f).convert("RGB"))
            mask = np.array(Image.open(helper._mask_path(f)).convert("L"))
            img_l, mask_l = letterbox(img, mask, s)
            imgs[i] = img_l
            masks[i] = mask_l
            if (i + 1) % 500 == 0:
                logger.info("cache build: %d/%d", i + 1, n)
        imgs.flush()
        masks.flush()
        del imgs, masks
        (tmp / "meta.json").write_text(json.dumps({
            "version": CACHE_VERSION, "image_size": s, "files": list(files),
        }))
        try:
            os.replace(tmp, cdir)  # atomic: concurrent builders race safely
        except OSError:
            # Target exists (a stale cache, or a concurrent builder won the
            # rename). Clear a stale one and retry once; a valid one wins.
            if _is_valid(cdir, image_size, files):
                pass
            else:
                import shutil

                shutil.rmtree(cdir, ignore_errors=True)
                os.replace(tmp, cdir)
    finally:
        if tmp.exists():
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
    return cdir


class CachedMaskFolderDataset(MaskFolderDataset):
    """MaskFolderDataset that reads pre-decoded letterbox canvases from the
    memmap cache instead of decoding PNGs per epoch.

    Same deterministic split semantics as the parent (the cache indexes the
    FULL sorted file list; the split selects into it), same ``load``
    signature — except masks come back **uint8 (0..255)**, which the
    loader/train step handle natively (uint8 over the wire, decode on
    device). Corrupt-sample retry is unnecessary: every sample decoded
    successfully at build time.
    """

    def __init__(self, root_dir: str, image_size: int, split: str = "train",
                 val_split: float = 0.1, seed: int = 42,
                 debug_subset_fraction: Optional[float] = None,
                 cache_root: Optional[str] = None):
        super().__init__(root_dir, image_size, split, val_split, seed,
                         debug_subset_fraction)
        # The cache covers the full (split-independent) sorted file list.
        all_files = sorted(
            f for f in os.listdir(self.images_dir)
            if Path(f).suffix.lower() in {".jpg", ".jpeg", ".png"}
            and self._mask_path(f) is not None
        )
        self._cache_index = {f: i for i, f in enumerate(all_files)}
        cdir = build_cache(self.root_dir, image_size, all_files, cache_root)
        self._images_mm = np.load(cdir / "images.npy", mmap_mode="r")
        self._masks_mm = np.load(cdir / "masks.npy", mmap_mode="r")

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        i = self._cache_index[self.files[idx]]
        # np.array copies out of the mapping so downstream augmentation
        # can mutate freely.
        return np.array(self._images_mm[i]), np.array(self._masks_mm[i])
