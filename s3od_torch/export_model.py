"""Export a checkpoint to the inference formats, with verification
(counterpart of `scripts/export_model.py`).

- the native `.npz` (the JAX package's `save_native` layout, which both
  packages' `BackgroundRemoval` load);
- with `--torch-output`, the reference-format `.pt` ({'state_dict': ...});
- with `--aot-output`, a serving bundle (`s3od_torch.aot`): the prepared
  weights and one `torch.export` graph per batch and payload.

`--verify` reloads each export and holds it to the source: the `.npz`
over random inputs to max-abs 1e-5, the `.pt` to 1e-4, and the bundle
through `aot.verify_bundle`. The forwards run on `--device` (the card by
default) in float32; the bundle is exported there in `--aot-dtype`.

    python -m s3od_torch.export_model --checkpoint CKPT --output s3od.npz \\
        [--torch-output s3od.pt] [--aot-output DIR] [--verify] [--device cpu]

CKPT is a `.npz`, a reference `.pt`, or a training checkpoint directory
of the port (`state.pt`, `s3od_torch/training/checkpoint.py`).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from s3od_torch.convert import (config_from_state_dict, convert_state_dict,
                                export_torch_state_dict, load_checkpoint,
                                load_native_segmentation, save_native,
                                state_dict_from_jax)
from s3od_torch.models.segmentation import S3ODSegmentation
from s3od_torch.ops.precision import set_exact_float32


def load_any(path: str):
    """(params, state, cfg) of a `.npz`, a reference `.pt`, or a training
    checkpoint directory of the port."""
    p = Path(path)
    if p.is_dir():
        from s3od_torch.training.checkpoint import STATE_FILE

        sd = torch.load(p / STATE_FILE, map_location="cpu",
                        weights_only=False)["model"]
        return convert_state_dict(sd, config_from_state_dict(sd))
    if p.suffix == ".npz":
        return load_native_segmentation(str(p))
    sd, cfg = load_checkpoint(p)
    return convert_state_dict(sd, cfg)


def build_model(params, state, cfg, device="cpu") -> S3ODSegmentation:
    """The float32 eval-mode model of a JAX-layout tree, on `device`."""
    model = S3ODSegmentation(cfg)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    return model.eval().to(device)


def save_torch_checkpoint(path: str, params, state) -> None:
    """Write a reference-format `{'state_dict': ...}` .pt file."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_torch_state_dict(params, state).items()}
    torch.save({"state_dict": sd}, path)


@torch.no_grad()
def max_output_diff(a: S3ODSegmentation, b: S3ODSegmentation, n: int,
                    size: int, seed: int) -> float:
    """Worst max-abs difference of the two models' masks and IoU logits
    over `n` random (1, size, size, 3) float32 inputs."""
    dev = next(a.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    worst = 0.0
    for _ in range(n):
        x = torch.randn((1, size, size, 3), generator=gen).to(dev)
        oa, ob = a(x), b(x)
        worst = max(worst,
                    float((oa["pred_masks"] - ob["pred_masks"]).abs().max()),
                    float((oa["pred_iou"] - ob["pred_iou"]).abs().max()))
    return worst


def verify_export(model, npz_path: str, n: int = 3, size: int = 256) -> float:
    """Reload the `.npz` and compare over random inputs (< 1e-5)."""
    dev = next(model.parameters()).device
    worst = max_output_diff(model, build_model(*load_native_segmentation(
        npz_path), device=dev), n, size, seed=0)
    print(f"verification max-abs-diff over {n} random inputs: {worst:.2e}")
    if not worst < 1e-5:
        raise AssertionError(f"export verification failed: {worst}")
    return worst


def verify_torch_export(model, pt_path: str, size: int = 128) -> float:
    """Reload the `.pt` through the converter and compare (< 1e-4)."""
    dev = next(model.parameters()).device
    sd, cfg = load_checkpoint(pt_path)
    other = S3ODSegmentation(cfg)
    other.load_state_dict(sd, strict=True)
    diff = max_output_diff(model, other.eval().to(dev), 1, size, seed=1)
    print(f"torch round-trip max-abs-diff: {diff:.2e}")
    if not diff < 1e-4:
        raise AssertionError(f"torch export verification failed: {diff}")
    return diff


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--output", required=True, help="native .npz output")
    ap.add_argument("--torch-output", default=None,
                    help="optional reference-format .pt output")
    ap.add_argument("--aot-output", default=None,
                    help="optional serving-bundle directory (torch.export "
                         "graphs + prepared weights, s3od_torch/aot.py)")
    ap.add_argument("--aot-image-size", type=int, default=1024)
    ap.add_argument("--aot-batches", type=int, nargs="+", default=[1, 16])
    ap.add_argument("--aot-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of the verification forwards and of the "
                         "bundle's export (default: cuda)")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu")
    set_exact_float32()
    params, state, cfg = load_any(args.checkpoint)
    save_native(args.output, params, state)
    print(f"wrote {args.output}")
    report = {}
    model = build_model(params, state, cfg, args.device)
    if args.verify:
        report["npz_diff"] = verify_export(model, args.output)
    if args.torch_output:
        save_torch_checkpoint(args.torch_output, params, state)
        print(f"wrote {args.torch_output}")
        if args.verify:
            report["pt_diff"] = verify_torch_export(model, args.torch_output)
    if args.aot_output:
        from s3od_torch.aot import (load_serving_bundle, save_serving_bundle,
                                    verify_bundle)

        out = save_serving_bundle(
            args.aot_output, model, image_size=args.aot_image_size,
            batches=tuple(args.aot_batches), dtype=args.aot_dtype,
            device=args.device)
        print(f"wrote serving bundle {out} "
              f"(batches {args.aot_batches} @ {args.aot_image_size}px)")
        if args.verify:
            worst = verify_bundle(load_serving_bundle(out, args.device))
            print(f"serving bundle verification max-abs-diff: {worst:.2e}")
            report["bundle_diff"] = worst
    return report


if __name__ == "__main__":
    main()
