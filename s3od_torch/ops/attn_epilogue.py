"""K4: attention epilogue — o_proj over the heads, + bias, x ls1,
+ residual, then LayerNorm(norm2) of the rounded new stream (CUDA) — and
its plain version.

Replaces the TPU kernel `s3od_tpu/ops/attn_epilogue.py:_kernel` (via
`attn_epilogue`). The kernel source and its design note are in
`s3od_torch/csrc/attn_epilogue.cu`.

Two kernels, chosen by an explicit dispatch on D in the C entry point
(`kernel_route`): at D = 64 (ViT-S/B/L) a TMA + wgmma GEMM whose 64-row
tiles are split along the columns over a 2-block cluster that shares the
LayerNorm statistics (`plan` mirrors its launch); at D = 32 (the tiny
checkpoints) the mma.sync kernel.

The kernel is also the registered op `s3od::attn_epilogue`
(`_build.via_ops`), whose implementation is `_attn_epilogue`, with the
FLOP formula of its product, 2 B N C^2.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build
from s3od_torch.ops.autograd import plain_vjp
from s3od_torch.ops.layernorm import layer_norm_plain

# The D = 64 kernel's launch (`csrc/attn_epilogue.cu`), mirrored so that
# the CPU tests can check it at the shapes the repo's configs give it.
ROW_TILE = 64                # rows (tokens of one batch element) a tile
K_TILE = 64                  # K a pipeline stage: one head
MAX_STAGES = 4
CLUSTER = 2                  # blocks of a cluster: a row's two halves
MAX_SMEM = 232448            # bytes of shared memory one H100 block may use
REGISTERS = 65536            # 32-bit registers of one SM
# C -> (consumer warpgroups, columns each): C / 2 a block, in warpgroups
# of at most 256 columns (a wgmma's widest), whole 64-column atoms.
WIDTHS = {128: (1, 64), 256: (1, 128), 384: (1, 192), 512: (1, 256),
          768: (2, 192), 1024: (2, 256)}


def kernel_route(d: int) -> str:
    """Which kernel the C entry point runs at head dim `d`."""
    return {64: "cluster wgmma", 32: "mma.sync"}.get(d, "none")


def regs(nc: int) -> tuple[int, int]:
    """Registers a producer and a consumer thread may hold beside `nc`
    consumer warpgroups: `setmaxnreg`'s split at two; at one there is no
    `setmaxnreg`, and each of the 256 threads may hold 255."""
    return {1: (255, 255), 2: (24, 240)}[nc]


def plan(b: int, n: int, c: int, d: int = 64) -> dict:
    """The launch at x (b, n, c) and head dim d. At D = 32 the mma.sync
    kernel (32 rows x all C a block, two cp.async stages). At D = 64 the
    cluster kernel: 64-row tiles (`row_tiles`), each split over a pair of
    blocks of `block_cols` columns (`blocks` in all before the persistent
    grid's cap), `consumers` warpgroups of `wn` columns a block; the
    ring's stages, shared memory (ring, x staging, the bf16 vectors, the
    statistics, the barriers), and Wo bytes read from L2 a row."""
    if kernel_route(d) == "mma.sync":
        rows_b, ldk = 32, 40
        return {"route": "mma.sync", "block_cols": c, "consumers": 0,
                "grid": b * n // rows_b,
                "smem": 2 * (2 * rows_b * ldk + 2 * (c + 16) * ldk),
                "wo_l2_bytes_a_row": 2 * c * c / rows_b}
    nc, wn = WIDTHS[c]
    bw = nc * wn
    stage = ROW_TILE * K_TILE * 2 + bw * K_TILE * 2
    tail = 4 * bw * 2 + 2 * nc * ROW_TILE * 8 + (2 * MAX_STAGES + 4) * 8
    fixed = 1024 + ROW_TILE * bw * 2 + tail
    stages = min(MAX_STAGES, (MAX_SMEM - fixed) // stage)
    row_tiles = b * n // ROW_TILE
    return {"route": "cluster wgmma", "block_cols": bw, "consumers": nc,
            "wn": wn, "stages": stages, "smem": fixed + stages * stage,
            "row_tiles": row_tiles, "blocks": CLUSTER * row_tiles,
            "acc_regs": wn // 2, "wo_l2_bytes_a_row": 2 * c * c / ROW_TILE}


def attn_epilogue_plain(a, wo, bo, x, ls, lw, lb, eps: float):
    """Plain version of K4. a (B*H, N, D) head-major attention output;
    wo (C, C) nn.Linear layout; x (B, N, C); bo, ls, lw, lb (C,).
    Returns (x', LayerNorm(x')), both in x's dtype."""
    b, n, c = x.shape
    h = a.shape[0] // b
    a2 = a.reshape(b, h, n, c // h).permute(0, 2, 1, 3).reshape(b, n, c)
    t = torch.matmul(a2.float(), wo.float().t()) + bo.float()
    xn = (x.float() + t * ls.float()).to(x.dtype)
    return xn, layer_norm_plain(xn, lw, lb, eps)[0]


def attn_epilogue(a, wo, bo, x, ls, lw, lb, eps: float):
    """(x', LayerNorm_norm2(x')) from the head-major attention output.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: all bf16, N a multiple of 64; D = 64 with C in `WIDTHS`, or
    D = 32 with C a multiple of 64 up to 1024 (`kernel_route`)."""
    if _build.via_ops():
        return torch.ops.s3od.attn_epilogue(a, wo, bo, x, ls, lw, lb,
                                            float(eps))
    return _attn_epilogue(a, wo, bo, x, ls, lw, lb, eps)


def _attn_epilogue(a, wo, bo, x, ls, lw, lb, eps: float):
    """`attn_epilogue`'s implementation, and its op's."""
    if x.device.type == "cpu":
        return attn_epilogue_plain(a, wo, bo, x, ls, lw, lb, eps)
    b, n, c = x.shape
    if a.shape[0] % b:
        raise ValueError("attn_epilogue kernel: B*H rows expected")
    h = a.shape[0] // b
    d = c // h
    tensors = (a, wo, bo, x, ls, lw, lb)
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise ValueError("attn_epilogue kernel: bf16 inputs only")
    route = kernel_route(d)
    width_ok = c in WIDTHS if route == "cluster wgmma" else c % 64 == 0 and c <= 1024
    if (n % 64 or not width_ok or d * h != c or route == "none"
            or a.shape != (b * h, n, d) or wo.shape != (c, c)
            or any(t.shape != (c,) for t in (bo, ls, lw, lb))):
        raise ValueError(
            f"attn_epilogue kernel: unsupported a={tuple(a.shape)} "
            f"x={tuple(x.shape)}")
    a, wo, bo, x, ls, lw, lb = (_build.aligned16(t) for t in tensors)
    with _build.launch(attn_epilogue):
        xn = torch.empty_like(x)
        hn = torch.empty_like(x)
        lib = _build.load_library()
        code = lib.s3od_attn_epilogue(
            a.data_ptr(), wo.data_ptr(), bo.data_ptr(), x.data_ptr(),
            ls.data_ptr(), lw.data_ptr(), lb.data_ptr(), xn.data_ptr(),
            hn.data_ptr(), b, n, c, h, d, float(eps), _build.stream_ptr(x),
        )
        _build.check(code, "attn_epilogue")
    return xn, hn


attn_epilogue.launches = 0


def _attn_epilogue_op(
        a: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor, x: torch.Tensor,
        ls: torch.Tensor, lw: torch.Tensor, lb: torch.Tensor, eps: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    return _build.op_outputs(_attn_epilogue(a, wo, bo, x, ls, lw, lb, eps))


def _attn_epilogue_fake(a, wo, bo, x, ls, lw, lb, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape)


_build.register_op("attn_epilogue", _attn_epilogue_op, _attn_epilogue_fake)


@register_flop_formula(torch.ops.s3od.attn_epilogue)
def _attn_epilogue_flops(a_shape, wo_shape, bo_shape, x_shape, *args,
                         out_shape=None, **kwargs):
    b, n, c = x_shape
    return 2 * b * n * c * wo_shape[0]


class _AttnEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, wo, bo, x, ls, lw, lb, eps):
        ctx.save_for_backward(a, wo, bo, x, ls, lw, lb)
        ctx.eps = eps
        return attn_epilogue(a, wo, bo, x, ls, lw, lb, eps)

    @staticmethod
    def backward(ctx, gx, gh):
        fn = lambda *args: attn_epilogue_plain(*args, ctx.eps)
        return (*plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:7],
                           (gx, gh)), None)


# Differentiable `attn_epilogue` -> (x', h): K4 forward, the plain
# version's vjp backward (`_bwd_rule`).
attn_epilogue_autograd = _AttnEpilogue.apply
