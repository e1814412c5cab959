"""Training and evaluation steps (counterpart of
`s3od_tpu/training/train_step.py`).

One `train_step` is the JAX jitted step written out: decode the uint8
batch and normalize it (or take the batch the trainer augmented), split
it into `accum_steps` micro-batches, and for each draw the RoPE
coordinate scale, run the forward in training mode (batch-statistics BN,
per-block remat), the loss and the confusion sums, and backpropagate; the gradients, the loss and its parts are averaged
over the micro-batches, the sums added, and the BN running statistics
thread through the micro-batches in order. Then one optimizer update.
Results stay on the device (no host readback per step).

Under data parallelism `model` is the DDP / FSDP2 module
(`parallel.shard_module`) and `batch` this rank's rows of the global
batch (rows r::W): the gradients are reduced in the backward of the last
micro-batch only (`parallel.mesh.grad_sync`), and the returned sums are
this rank's (the trainer reduces them over the ranks once an epoch).

While a profiler records, the step and its phases are spans
(`profiling.span`): `s3od.train.step`, inside it `s3od.train.preprocess`
(once, where it runs), per micro-batch `s3od.train.forward`, `.loss`,
`.backward` and `.metrics`, then `s3od.train.optimizer`.

The FLUX teacher trains through the same steps with `forward=
teacher_forward`, which feeds it the batch's `transformer_features` and
`concept_maps` beside the images (JAX `make_train_step(forward_fn=)`,
`s3od_tpu/training/train.py:286-298`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from s3od_torch.models.dinov3 import sample_rope_coord_scale
from s3od_torch.parallel.mesh import grad_sync, unwrap
from s3od_torch.profiling import span

# ImageNet statistics (`s3od_tpu/ops/augment.py:normalize_imagenet`).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def preprocess(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """uint8 images (B, S, S, 3) -> ImageNet-normalized fp32; uint8 masks
    (B, S, S) -> [0, 1] fp32 (the test-mode transform: no augmentation)."""
    x = batch["images"].float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    masks = batch["masks"]
    if masks.dtype == torch.uint8:
        masks = masks.float() / 255.0
    return {**batch, "images": (x - mean) / std, "masks": masks}


@torch.no_grad()
def best_mask_metrics(outputs, targets) -> Dict[str, torch.Tensor]:
    """Confusion sums (tp, fp, fn) of the argmax-IoU mask against the
    targets thresholded at 0.5 (`_best_mask_metrics`)."""
    probs = torch.sigmoid(outputs["pred_masks"].float())
    best = outputs["pred_iou"].argmax(1)
    best_masks = probs[torch.arange(probs.shape[0], device=probs.device), best]
    pred = best_masks > 0.5
    gt = targets > 0.5
    return {"tp": (pred & gt).sum().float(), "fp": (pred & ~gt).sum().float(),
            "fn": (~pred & gt).sum().float()}


def segmentation_forward(model, batch, compute_dtype, training: bool, *,
                         rope_coord_scale=None, remat_policy=None,
                         bn_group=None):
    """The student model on a (micro-)batch's images."""
    return model(batch["images"].to(compute_dtype), training=training,
                 rope_coord_scale=rope_coord_scale,
                 remat_policy=remat_policy, bn_group=bn_group)


def teacher_forward(model, batch, compute_dtype, training: bool, **_):
    """The FLUX teacher (`models/flux_teacher.FluxTeacher`) on a batch's
    images, `transformer_features` and `concept_maps`; it casts them to the
    compute dtype itself, as `flux_teacher_forward` does. The RoPE scale,
    remat policy and BN group do not reach it (the JAX teacher forward
    takes none of them)."""
    return model(batch["images"].to(compute_dtype),
                 batch["transformer_features"], batch["concept_maps"],
                 training=training)


def _rows(tree, a: int, b: int):
    """Rows [a, b) of every tensor of a batch (lists and dicts too)."""
    if isinstance(tree, dict):
        return {k: _rows(v, a, b) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rows(v, a, b) for v in tree]
    return tree[a:b]


def train_step(model, optimizer, loss_module, batch, epoch: int, step: int,
               *, generator: torch.Generator, accum_steps: int = 1,
               compute_dtype: torch.dtype = torch.float32,
               remat_policy: Optional[str] = None,
               preprocessed: bool = False,
               bn_group=None, forward=segmentation_forward
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step over `batch` (leading dim accum_steps x micro
    batch, on the model's device). `step` is the number of updates so far
    (the schedules' count); `generator` draws the RoPE scales when the
    encoder config has `pos_embed_rescale`. `preprocessed`: the batch is
    already augmented and normalized (float images and masks, the
    trainer's `train_pre`); else `preprocess` decodes it. `bn_group`:
    the process group over which the batch is sharded, for the
    BatchNorms' global-batch statistics (None: this batch alone).
    `forward`: `segmentation_forward` or `teacher_forward`. Returns
    {"loss", *parts, "tp", "fp", "fn"} as 0-dim device tensors."""
    with span("s3od.train.step"):
        if not preprocessed:
            with span("s3od.train.preprocess"):
                batch = preprocess(batch)
        cfg = unwrap(model).cfg
        rescale = getattr(cfg, "base", cfg).encoder.pos_embed_rescale
        n = batch["images"].shape[0]
        if n % accum_steps:
            raise ValueError(f"batch {n} does not split into {accum_steps} "
                             "micro-batches")
        micro = n // accum_steps
        optimizer.zero_grad()
        out: Dict[str, torch.Tensor] = {}
        for j in range(accum_steps):
            mb = _rows(batch, j * micro, (j + 1) * micro)
            scale = None
            if rescale:
                # A Python float (the fp32 draw, exactly): FSDP2 moves tensor
                # arguments to the device, and the RoPE tables are built on
                # the host.
                scale = float(sample_rope_coord_scale(generator, rescale))
            with grad_sync(model, j == accum_steps - 1):
                with span("s3od.train.forward"):
                    outputs = forward(model, mb, compute_dtype, True,
                                      rope_coord_scale=scale,
                                      remat_policy=remat_policy,
                                      bn_group=bn_group)
                with span("s3od.train.loss"):
                    loss, parts = loss_module(outputs, mb, epoch)
                with span("s3od.train.backward"):
                    (loss / accum_steps).backward()
            with span("s3od.train.metrics"):
                terms = {"loss": loss.detach() / accum_steps,
                         **{k: v.detach() / accum_steps for k, v in parts.items()},
                         **best_mask_metrics(outputs, mb["masks"])}
                for k, v in terms.items():
                    out[k] = out[k] + v if k in out else v
        with span("s3od.train.optimizer"):
            optimizer.step(step)
    return out


@torch.no_grad()
def eval_step(model, loss_module, batch, epoch: int, *,
              compute_dtype: torch.dtype = torch.float32,
              forward=segmentation_forward) -> Dict[str, torch.Tensor]:
    """Forward with running-statistics BN, loss and confusion sums."""
    batch = preprocess(batch)
    outputs = forward(model, batch, compute_dtype, False)
    outputs = {k: v.float() for k, v in outputs.items()}
    loss, parts = loss_module(outputs, batch, epoch)
    return {"loss": loss, **parts, **best_mask_metrics(outputs, batch["masks"])}
