"""Builds and loads the port's CUDA kernels (K2-K10, and E1-E4 of
`s3od_torch/experiments/`).

Each `csrc/*.cu` file compiles with its own `nvcc` process, all started
together, and the objects link into ONE shared library with a plain C
interface, loaded through `ctypes` — no PyTorch headers, so the build
takes seconds instead of minutes. The library lands in the build
directory — `$S3OD_TORCH_BUILD_DIR` if set, else `build/s3od_torch_kernels/`
beside the package (the checkout's git-ignored `build/`) — named by a hash
of the sources and flags, and is rebuilt at first use whenever that hash
changes. Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check()` turns a nonzero code into an exception.

The Triton kernel (K1) needs no build step; while it launches (and so
compiles), `triton_cache()` points Triton's compile cache into the same
build directory, and restores the caller's setting afterwards.

The stream API launches from several threads at once, so the build runs
under a lock, and every wrapper counts its launches with `count_launch`,
under another.

Nothing here runs at import time.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parent.parent / "build"
                     / "s3od_torch_kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points: name -> argument types (every pointer and the stream as
# c_void_p, or ctypes would cut them to 32 bits).
_SIGNATURES = {
    # x, w, b, cos, sin, q, k, v, batch, n, c, heads, head_dim, scale, stream
    "s3od_qkv_project_rope": [_P] * 8 + [_I] * 5 + [_F, _P],
    # q, k, v, o, lse, bh, n, head_dim, n_valid, stream
    "s3od_flash_attention_fwd": [_P] * 5 + [_I] * 4 + [_P],
    # q, k, v, o, lse, bh, n, head_dim, n_valid, stream
    "s3od_flash_attention_online_fwd": [_P] * 5 + [_I] * 4 + [_P],
    # q, k, v, o, g, lse, delta, dq_acc, dq, dk, dv, bh, n, head_dim,
    # n_valid, stream
    "s3od_flash_attention_bwd": [_P] * 11 + [_I] * 4 + [_P],
    # a, wo, bo, x, ls, lw, lb, xn, h, batch, n, c, heads, head_dim, eps, stream
    "s3od_attn_epilogue": [_P] * 9 + [_I] * 5 + [_F, _P],
    # x, wu, bu, wd, bd, res, ls, out, h, rows, c, f, stream
    "s3od_mlp_fused": [_P] * 9 + [_I] * 3 + [_P],
    # x, w, bias, out, U scratch, V scratch, batch, c, h, w, k, chunk rows,
    # route, w strides (kernel row, kernel column, c, k), x strides
    # (b, h, w, c), out strides (b, h, w, k), stream
    "s3od_winograd_conv": [_P] * 6 + [_I] * 7 + [_L] * 12 + [_P],
    # x, w1, b1, w2, b2, U scratch, h scratch, V scratch, out, batch, c,
    # h, w, w1 strides, w2 strides, x strides, out strides, stream
    "s3od_winograd_rcu": [_P] * 9 + [_I] * 4 + [_L] * 16 + [_P],
    # x, w1, b1, w0, b0, k1, bk, out, batch, h, w, c_in, c_mid, n_out,
    # x strides (b, h, w, c), out strides (b, h, w, n), stream
    "s3od_mask_tail": [_P] * 8 + [_I] * 6 + [_L] * 8 + [_P],
    # q, k, v, bias, o, lse, bh, n, variant, mult, lo, hi, l_eps,
    # extra_keys, stream
    "s3od_exp_flash_fwd": [_P] * 6 + [_I] * 3 + [_F] * 4 + [_I, _P],
    # x, out, elems, programs, reps, variant, stream
    "s3od_exp_loop": [_P] * 2 + [_I] * 4 + [_P],
    # x, w, b, y, rows, c, eps, stream
    "s3od_ln_single_pass": [_P] * 4 + [_I] * 2 + [_F, _P],
}
_COUNT_LOCK = threading.Lock()
_TRITON_ENV_LOCK = threading.RLock()
_BUILD_LOCK = threading.Lock()
_LIBRARY: ctypes.CDLL | None = None


def build_dir() -> Path:
    return Path(os.environ.get("S3OD_TORCH_BUILD_DIR") or DEFAULT_BUILD_DIR)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library, once
    per process. The first launches may come from several stream workers
    at once; the lock makes one of them build while the others wait, so
    no two builds share the object files and the temporary library."""
    global _LIBRARY
    if _LIBRARY is None:
        with _BUILD_LOCK:
            if _LIBRARY is None:
                _LIBRARY = _build_and_load()
    return _LIBRARY


def _build_and_load() -> ctypes.CDLL:
    """One `nvcc -c` per source, run in parallel, then one link; each
    compile's output (with `-Xptxas -v`: registers, shared memory, spills)
    goes to `build.log`. Object and temporary names carry the pid, so
    processes building at once do not collide either."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / f"libs3od_kernels_{source_hash()}.so"
    if not lib_path.exists():
        tag = f"{source_hash()}.{os.getpid()}"
        nvcc = _nvcc()
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = out / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for cmd, _, proc in jobs:
            text = proc.communicate()[0]
            log.append(" ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(text[-4000:])
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            cmd = [nvcc, "-shared", "-o", str(tmp),
                   *[str(obj) for _, obj, _ in jobs]]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(proc.stderr[-4000:])
        (out / "build.log").write_text("\n".join(log))
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's launch count (thread-safe)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


@contextlib.contextmanager
def triton_cache():
    """Point Triton's compile cache into the build directory for the span
    of one launch of this package's kernel (Triton reads the variable when
    it compiles); the caller's own setting is restored afterwards. The
    scope is held under a lock, so launches from several threads cannot
    leave the variable set."""
    with _TRITON_ENV_LOCK:
        old = os.environ.get("TRITON_CACHE_DIR")
        os.environ["TRITON_CACHE_DIR"] = str(build_dir() / "triton")
        try:
            yield
        finally:
            if old is None:
                os.environ.pop("TRITON_CACHE_DIR", None)
            else:
                os.environ["TRITON_CACHE_DIR"] = old


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address, as TMA needs (a
    contiguous view can start anywhere in its storage)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, for the C entry points."""
    return torch.cuda.current_stream(t.device).cuda_stream
