"""Checkpoints: top-k by a monitored metric plus `last`, resume, and the
inference export (counterpart of `s3od_tpu/training/checkpoint.py`).

Each checkpoint is a directory (`last`, `epochNNNN`) holding `state.pt`,
written with `torch.save`: the model's state dict (fp32 weights and BN
running statistics), the optimizer's state, the update count `step` and
the `epoch`. `index.json` keeps the JAX package's schema:
{"best": [{"path", "score", "epoch"}, ...], "last": {"path", "epoch",
"metrics"}}. Saves are synchronous; `last` is written to `last.tmp` and
renamed into place, so `index.json` never names a partial checkpoint.
The random streams of a run are functions of (seed, epoch, step), so the
saved epoch and step restore them.

`export_inference` writes `s3od_final.npz` in the JAX package's native
layout (`save_native`), which both packages' `BackgroundRemoval` load.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, *, top_k: int = 3,
                 monitor: str = "val_dice", mode: str = "max"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.monitor = monitor
        self.mode = mode
        self.index_path = self.dir / "index.json"
        self.index: Dict[str, Any] = {"best": [], "last": None}
        if self.index_path.exists():
            self.index = json.loads(self.index_path.read_text())
        stale = self.dir / "last.tmp"
        if stale.exists():
            # A crash mid-save left an unreferenced (possibly partial) dir;
            # index.json still names the previous complete 'last'.
            shutil.rmtree(stale)

    def _write(self, path: Path, tree: Dict[str, Any]) -> None:
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(tree, path / STATE_FILE)

    def _qualifies(self, entries: List[Dict], score) -> bool:
        if score is None:
            return False
        sign = 1.0 if self.mode == "max" else -1.0
        return (len(entries) < self.top_k
                or sign * score > min(sign * e["score"] for e in entries))

    def save(self, tree: Dict[str, Any], *, epoch: int,
             metrics: Dict[str, float], save_last: bool = True) -> None:
        """Save `last` (unless `save_last=False`) and keep the top-k by
        the monitored metric; a top-k score always writes its
        `epochNNNN` checkpoint."""
        entries: List[Dict] = self.index["best"]
        score = metrics.get(self.monitor)
        if save_last:
            tmp, last = self.dir / "last.tmp", self.dir / "last"
            self._write(tmp, tree)
            if last.exists():
                shutil.rmtree(last)
            tmp.rename(last)
            self.index["last"] = {"path": "last", "epoch": epoch,
                                  "metrics": metrics}
        if self._qualifies(entries, score):
            name = f"epoch{epoch:04d}"
            sign = 1.0 if self.mode == "max" else -1.0
            self._write(self.dir / name, tree)
            entries.append({"path": name, "score": score, "epoch": epoch})
            entries.sort(key=lambda e: -sign * e["score"])
            while len(entries) > self.top_k:
                dropped = self.dir / entries.pop()["path"]
                if dropped.exists():
                    shutil.rmtree(dropped)
        self.index_path.write_text(json.dumps(self.index, indent=1))


def restore_external(path: str, *, steps_per_epoch: int = 1
                     ) -> Tuple[Dict[str, Any], int]:
    """Read the checkpoint directory `path` -> (tree, start_epoch). The
    epoch comes from the manager's index.json when the checkpoint is one
    of ours (the saved epoch + 1), else from step // steps_per_epoch
    (`s3od_tpu/training/train.py:ckpt_restore_external`)."""
    path_p = Path(path).resolve()
    tree = torch.load(path_p / STATE_FILE, map_location="cpu",
                      weights_only=False)
    start_epoch = int(tree["step"]) // max(1, steps_per_epoch)
    index_path = path_p.parent / "index.json"
    if index_path.exists():
        try:
            index = json.loads(index_path.read_text())
            for entry in [index.get("last")] + list(index.get("best", [])):
                if entry and entry.get("path") == path_p.name:
                    start_epoch = int(entry["epoch"]) + 1
                    break
        except (json.JSONDecodeError, KeyError, TypeError):
            pass
    return tree, start_epoch


def key_bias_max(model) -> torch.Tensor:
    """max |b_k| of each encoder block's fused-qkv key segment, (L,).
    Under FSDP2 each rank reads its shard and the maxima are reduced over
    the world, so every rank must call it."""
    from s3od_torch.parallel.mesh import is_dtensor, local_rows, unwrap

    out = []
    sharded = False
    for blk in unwrap(model).encoder.layer:
        bias = blk.attention.qkv.bias.detach()
        local, offset = local_rows(bias)
        c = bias.shape[0] // 3
        a, b = max(c - offset, 0), min(2 * c - offset, local.shape[0])
        part = local[a: b] if b > a else local[:0]
        out.append(part.abs().max() if part.numel()
                   else torch.zeros((), device=local.device))
        sharded = sharded or is_dtensor(bias)
    out = torch.stack(out).float()
    if sharded:
        torch.distributed.all_reduce(out, op=torch.distributed.ReduceOp.MAX)
    return out


def export_inference(model, out_path: str,
                     state_dict: Optional[Dict[str, Any]] = None,
                     key_bias: Optional[torch.Tensor] = None) -> None:
    """Weights-only export for `BackgroundRemoval`: the model's state dict
    in the JAX package's native `.npz` layout; a FLUX teacher's as
    (params, BN state) with its fusion levels, which `convert.load_teacher`
    and `SODTeacherPredictor` read. The fused-qkv key-bias segment must be
    zero (the reference layout has no key bias). A sharded model passes
    what every rank gathered: `state_dict` (`parallel.mesh.full_state_dict`)
    and `key_bias` (`key_bias_max`)."""
    from s3od_torch.convert import (
        convert_state_dict,
        save_native,
        teacher_tree_from_state_dict,
    )
    from s3od_torch.parallel.mesh import unwrap

    model = unwrap(model)
    if key_bias is None:
        key_bias = key_bias_max(model)
    for i, k_max in enumerate(key_bias.tolist()):
        if k_max > 1e-6:
            raise ValueError(
                f"layer {i}: fused-QKV key-bias segment is nonzero (max "
                f"|b_k| = {k_max:.2e}); train with the key-bias freeze")
    sd = state_dict if state_dict is not None else model.state_dict()
    if hasattr(model, "fusion"):
        params, state = teacher_tree_from_state_dict(sd)
    else:
        params, state, _ = convert_state_dict(sd, model.cfg)
    save_native(out_path, params, state)


class EarlyStopping:
    """Min/max early stopping with patience (reference `train.py:108-111`,
    `config/train_stage/dev_train.yaml`)."""

    def __init__(self, monitor: str, patience: int = 50, mode: str = "min",
                 min_delta: float = 1e-4):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.count = 0

    def update(self, metrics: Dict[str, float]) -> bool:
        """Returns True if training should stop."""
        val = metrics.get(self.monitor)
        if val is None:
            return False
        sign = -1.0 if self.mode == "min" else 1.0
        if self.best is None or sign * val > sign * self.best + self.min_delta:
            self.best = val
            self.count = 0
        else:
            self.count += 1
        return self.count >= self.patience
