"""Efficiency benchmark: FPS, parameter count, FLOPs, memory (counterpart
of `s3od_tpu/evaluation/test_efficiency.py`, the paper's protocol at
840 x 840).

- FPS by slope timing of the `SODPredictor` device forward (normalize ->
  sigmoid) on uint8 canvases: runs of 2 and 2 + `iterations` in-order
  forwards, each ended by one readback, differenced (the fallback to the
  larger run's mean when the slope is not positive is the JAX one);
- parameters: the prepared serving tree (BN folded, in the JAX layout,
  `aot.serving_tree`), as the JAX package counts its serving params;
- FLOPs: `torch.utils.flop_counter.FlopCounterMode` over one forward, with
  the wrappers sent through their `s3od::` ops (`_build.through_ops`) so
  that each kernel counts by its registered FLOP formula — without them
  the count would miss the encoder's products. The encoder's products
  are counted over the sequence the kernels run, padded to a multiple of
  64 (2709 tokens -> 2752 at 840^2), and only matrix products and
  convolutions count, as FlopCounterMode counts them;
- memory: `torch.cuda.max_memory_allocated` and `memory_stats` over one
  forward on the card ("not measured" on the CPU).

Writes `benchmark_results.txt`, naming the card and its power limit;
`--trace_dir` also profiles three forwards and prints the summary.

    python -m s3od_torch.evaluation.test_efficiency --checkpoint ckpt.npz \\
        [--input_size 840] [--iterations 40] [--batch 1] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch


def count_parameters(model) -> int:
    """Parameters of the prepared serving tree (the JAX layout's params,
    BN state excluded, as `s3od_tpu`'s `count_parameters` counts them)."""
    from s3od_torch.aot import serving_tree

    params = serving_tree(model)[0]

    def leaves(node):
        if isinstance(node, dict):
            return [x for v in node.values() for x in leaves(v)]
        if isinstance(node, (list, tuple)):
            return [x for v in node for x in leaves(v)]
        return [] if node is None else [node]

    return int(sum(np.asarray(x).size for x in leaves(params)))


def count_flops(predictor, x_u8: torch.Tensor):
    """(total, {op: FLOPs}) of one forward, the `s3od::` ops counted by
    their formulas."""
    from torch.utils.flop_counter import FlopCounterMode

    from s3od_torch import _build

    with _build.through_ops(), FlopCounterMode(display=False) as counter:
        predictor._forward_device(x_u8, "full")
    by_op = {str(k): int(v) for k, v in
             counter.get_flop_counts().get("Global", {}).items()}
    return int(counter.get_total_flops()), by_op


def run_benchmark(
    checkpoint: str = None,
    input_size: int = 840,
    iterations: int = 40,
    batch: int = 1,
    output_file: str = "benchmark_results.txt",
    trace_dir: str = None,
    device: str = "cuda",
    dtype: str = None,
    _predictor=None,
):
    from s3od_torch.evaluation.predictor import SODPredictor
    from s3od_torch.models.dinov3 import attn_seq_len
    from s3od_torch.profiling import (capture_trace, device_description,
                                      print_summary, summarize_trace)

    predictor = _predictor or SODPredictor(checkpoint, image_size=input_size,
                                           device=device, dtype=dtype)
    br = predictor.predictor
    dev = br.device
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(
        0, 255, (batch, input_size, input_size, 3), dtype=np.uint8)).to(dev)

    def fwd():
        return br._forward_device(images, "full")

    def readback(out):
        return float(out[0][..., ::64, ::64].float().sum() + out[1].sum())

    def run(n):
        t0 = time.perf_counter()
        for _ in range(n):
            out = fwd()
        readback(out)
        return time.perf_counter() - t0

    run(2)  # warm
    t1 = min(run(2) for _ in range(2))
    t2 = min(run(2 + iterations) for _ in range(2))
    # The slope can come out <= 0 for tiny models under host jitter; fall
    # back to the mean of the larger run (an upper bound of the latency).
    dt = (t2 - t1) / iterations
    if dt <= 0:
        dt = t2 / (2 + iterations)
    fps = batch / dt

    flops, flops_by_op = count_flops(br, images)
    s3od_flops = sum(v for k, v in flops_by_op.items() if k.startswith("s3od."))

    peak = stats = None
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()  # the reserved peak: this forward's alone
        torch.cuda.reset_peak_memory_stats(dev)
        readback(fwd())
        peak = torch.cuda.max_memory_allocated(dev)
        stats = torch.cuda.memory_stats(dev)

    summary = None
    if trace_dir:
        path = capture_trace(lambda: readback(fwd()), trace_dir, iters=3)
        summary = summarize_trace(path, iters=3)
        print(f"profiler trace written to {path}")
        print_summary(summary)

    cfg = br.cfg.encoder
    patches = (input_size // cfg.patch_size) ** 2
    tokens = patches + cfg.num_prefix_tokens
    route = "kernel" if br.compute_dtype == torch.bfloat16 else "exact"
    n_params = count_parameters(br.model)
    weight_bytes = sum(p.numel() * p.element_size() for p in br.model.parameters())
    lines = [
        "S3OD efficiency benchmark (s3od_torch)",
        f"device: {device_description(dev)}",
        f"dtype: {str(br.compute_dtype).removeprefix('torch.')} ({route} route)",
        f"input: {batch}x{input_size}x{input_size}x3 uint8",
        f"tokens: {tokens} ({attn_seq_len(tokens, route)} as run)",
        f"params: {n_params / 1e6:.2f} M",
        f"latency: {dt * 1000:.3f} ms/step",
        f"throughput: {fps:.3f} img/s",
        f"flops/step: {flops / 1e9:.1f} GFLOP ({s3od_flops / 1e9:.1f} in s3od:: ops)"
        + (f" -> {flops / dt / 1e12:.1f} TFLOP/s achieved" if dt > 0 else ""),
    ]
    if cuda:
        lines += [
            f"weights: {weight_bytes / 1e6:.1f} MB",
            f"peak allocated: {peak / 1e6:.1f} MB",
            f"peak reserved: {stats['reserved_bytes.all.peak'] / 1e6:.1f} MB",
        ]
    else:
        lines.append("memory: not measured on the CPU")
    if summary is not None:
        lines.append(f"{summary['source']} time in the trace: "
                     f"{summary['total_ms']:.3f} ms/step")
    report = "\n".join(lines)
    print(report)
    if output_file:
        Path(output_file).write_text(report + "\n")
    return {"fps": fps, "latency_ms": dt * 1000, "params": n_params,
            "flops": flops, "s3od_flops": s3od_flops, "flops_by_op": flops_by_op,
            "peak_bytes": peak, "tokens": tokens, "report": report,
            "trace_summary": summary}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--input_size", type=int, default=840)
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--output_file", default="benchmark_results.txt")
    ap.add_argument("--trace_dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    return run_benchmark(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
