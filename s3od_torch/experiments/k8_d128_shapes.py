"""K8 at D = 128: the designs of `csrc/flash_attention_bwd.cu`, side by side
on the card.

The entry point `s3od_flash_attention_bwd` runs a single pass at D = 128:
one kernel computes dK, dV and the dQ partials of a block of 128 keys (5
products), the partials reduce-added into an fp32 accumulator. Before it,
D = 128 ran the D = 64 design, a dkv and a dq kernel (7 products), whose
block shapes are kept here as the record of why they lost: the dkv kernel
either overlaps a tile's S^T, dP^T products with the previous tile's dV,
dK products (224 accumulator registers of 240) or gives each its own turn
(192); the dq kernel runs 3 consumer warpgroups (160 registers, 144 of
them accumulators) or 2 (240). The single pass is built at 2 and 3 ring
stages (the entry point takes 3), and once with its dQ staging and
reduce-adds cut (its dq is then wrong: a measurement of what they cost). This script builds every variant
from the repository's source (a small harness that includes
`flash_attention_bwd.cu` and calls its templated launchers), prints each
kernel's registers and spills as ptxas reports them, holds each variant
to K8's plain version at the MMDiT's shapes (24 heads of 128, 4608
tokens; 4480 with n_valid 4464) by relative norm, and times each between
CUDA events beside SDPA's backward:

    python -m s3od_torch.experiments.k8_d128_shapes [--iters 20]

Needs a card and nvcc; the build goes to `<build dir>/k8_d128_shapes/`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from s3od_torch import _build
from s3od_torch.ops import flash_attention as fa

# (dkv warpgroups, dq warpgroups, dkv overlap) of each split combination.
SHAPES = [(2, 3, True), (2, 3, False), (2, 2, True), (2, 2, False)]
# (ring stages, what is done with each dQ partial) of each single-pass
# variant: "reduce" (the entry point's), or "none" (dropped: the reduce's
# cost, measured once; dq is then wrong).
DQ_MODES = {"none": 0, "reduce": 1}
FUSED = [(2, "reduce"), (3, "reduce"), (fa.BWD_FUSED_STAGES, "none")]
CASES = [(24, 4608, 4608), (24, 4480, 4464)]

_HARNESS = """#include "flash_attention_bwd.cu"

extern "C" int k8_shape(int which, const void* q, const void* k, const void* v,
                        const void* o, const void* g, const void* lse, void* delta,
                        void* dq_acc, void* dq, void* dk, void* dv, int bh, int n, int n_valid,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const bf16*>(q);
  auto* kk = static_cast<const bf16*>(k);
  auto* vv = static_cast<const bf16*>(v);
  auto* gg = static_cast<const bf16*>(g);
  auto* ll = static_cast<const float*>(lse);
  auto* dd = static_cast<float*>(delta);
  auto* acc = static_cast<float*>(dq_acc);
  auto* oq = static_cast<bf16*>(dq);
  auto* ok = static_cast<bf16*>(dk);
  auto* ov = static_cast<bf16*>(dv);
  const int err = launch_delta<128>(static_cast<const bf16*>(o), gg, dd, bh, n, st);
  if (err) return err;
  switch (which) {
%s  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""


def variants() -> list[str]:
    """Names of the variants, in the harness's case order."""
    return ([f"split {shape}" for shape in SHAPES]
            + [f"single pass, {st} stages, dQ {mode}" for st, mode in FUSED])


def harness_source() -> str:
    cases = "".join(
        f"    case {i}: return wg::launch_wgmma<128, {kv}, {dq}, "
        f"{str(ov).lower()}>(qq, kk, vv, gg, ll, dd, oq, ok, ov, bh, n, "
        "n_valid, st);\n" for i, (kv, dq, ov) in enumerate(SHAPES))
    cases += "".join(
        f"    case {len(SHAPES) + i}: return wg::launch_fused<{st}, "
        f"{DQ_MODES[mode]}>(qq, kk, vv, gg, ll, dd, acc, oq, ok, ov, bh, n, "
        "n_valid, st);\n" for i, (st, mode) in enumerate(FUSED))
    return _HARNESS % cases


def build():
    """Compile the harness -> (ctypes library, ptxas lines of the D = 128
    wgmma kernels: name, registers, spills)."""
    out = _build.build_dir() / "k8_d128_shapes"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "k8_shapes.cu", out / "k8_shapes.so"
    src.write_text(harness_source())
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-shared", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed:\n" + proc.stderr[-4000:])
    lines = (proc.stdout + proc.stderr).splitlines()
    report = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and (
                "ILi128E" in line or "fused" in line):
            name = line.split("'")[1]
            report.append((name, [m.split(":", 1)[-1].strip()
                                  for m in lines[i + 1: i + 4]
                                  if "spill" in m or "registers" in m]))
    handle = ctypes.CDLL(str(lib))
    handle.k8_shape.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    handle.k8_shape.restype = ctypes.c_int
    return handle, report


def event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k8_d128_shapes needs a CUDA device")
    lib, report = build()
    for name, info in report:
        print(name[:100], *info, sep="\n    ")
    results = {"ptxas": report}
    for bh, n, nv in CASES:
        g = torch.Generator(device="cuda").manual_seed(0)
        rn = lambda: torch.randn(bh, n, 128, generator=g, device="cuda")
        q, k, v, go = (rn() * 128**-0.5).bfloat16(), *(
            rn().bfloat16() for _ in range(3))
        for t in (q, k, v, go):
            t[:, nv:] = 0
        o, lse = fa.flash_attention_online(q, k, v, nv)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, go, nv)
        delta = torch.empty(bh, n, device="cuda")
        row = {}
        for i, name in enumerate(variants()):
            grads = [torch.empty_like(q) for _ in range(3)]

            def call():  # the accumulator zeroed per call, as the wrapper does
                acc = torch.zeros(bh, n, 128, device="cuda")
                return lib.k8_shape(
                    i, *(t.data_ptr() for t in (q, k, v, o, go, lse, delta,
                                                acc, *grads)),
                    bh, n, nv, torch.cuda.current_stream().cuda_stream)

            _build.check(call(), "k8_shape")
            torch.cuda.synchronize()
            row[name] = {
                "rel_err": [rel(a[:, :nv], b[:, :nv])
                            for a, b in zip(grads, ref)],
                "ms": event_ms(call, args.iters)}
        qs, ks, vs = (t[:, :nv].reshape(1, bh, nv, 128).detach().clone()
                      .requires_grad_() for t in (q, k, v))
        os_ = F.scaled_dot_product_attention(qs, ks, vs, scale=1.0)
        gs = go[:, :nv].reshape(1, bh, nv, 128)
        row["sdpa_bwd_ms"] = event_ms(lambda: torch.autograd.grad(
            os_, (qs, ks, vs), gs, retain_graph=True), args.iters)
        results[f"{bh}x{n}x{nv}"] = row
        print(f"({bh}, {n}, 128), n_valid {nv}:")
        for key, val in row.items():
            print(f"  {key}: {val}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
