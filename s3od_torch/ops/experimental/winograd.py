"""K9a, the Winograd F(2x2, 3x3) conv, and K9b, the chained
ResidualConvUnit (CUDA), with their plain versions, eligibility rules and
gradients.

Replaces the TPU kernels `s3od_tpu/ops/experimental/winograd.py:_kernel`
(via `conv3x3_winograd`) and `:_rcu_kernel` (via `rcu_winograd`). The
kernel sources and their design notes are in `s3od_torch/csrc/winograd.cu`.

Layout: the public functions take the JAX layout — x (B, H, W, C) in NHWC
*logical* order with any strides, weights HWIO (3, 3, C, K). The decoder
hands in `x_nchw.permute(0, 2, 3, 1)`, a view: the kernels read and write
through strides, and the output is allocated in the input's memory order
(NCHW memory for an NCHW view), so no permute or copy runs around a call.

Rounding points (the TPU kernels'): the 4x4 input patches are widened to
fp32; V = B^T d B is computed in fp32 and rounded to the compute dtype;
U = G w G^T is computed in fp32 from the weights already cast to that
dtype, then rounded to it; each of the 16 products accumulates in fp32;
A^T M A folds into four fp32 accumulators, the bias (in the compute dtype,
widened) is added, and the result is rounded once. K9b reads relu(x),
rounds its intermediate relu(conv1 + b1) once and holds it at zero outside
the image, and sums conv2 + b2 + x in fp32 before one rounding. The plain
versions are the Winograd algorithm in torch ops, in the TPU kernel's
order of additions, not `F.conv2d`: in bf16 the two differ by up to twice
the conv's own error.

Eligibility (`winograd_available`, `rcu_winograd_available`, `_pick_rows`,
`_pick_rows_rcu`) is copied from the JAX package unchanged, VMEM budget
included. It decides which convs compute in the Winograd domain, which
in bf16 changes the rounding, so the port routes exactly the convs the JAX
package routes; the Hopper kernels pick their own tiling inside it.

Gradients mirror the JAX `custom_vjp` rules: K9a's dx is itself a 3x3
conv with the space-flipped, channel-transposed weights and goes through
K9a whenever the rule admits the gradient's shape; dw and db, and all of
K9b's backward, are the vjp of the plain `F.conv2d` reference.

Both kernels first transform the weights (U) with one launch a weight.
K9a then takes one of two routes (`conv_route`, `conv_plan`): a fused
launch that keeps V in shared memory, or an input transform into a V
scratch and a Winograd GEMM, in chunks of tile rows. K9b runs as two
convs on the second route, each an input transform and a Winograd GEMM
(`winograd_transform_plain` and `winograd_gemm_plain` are those launches'
plain halves); its intermediate h is rounded once and zero-padded by
conv2 as in the TPU kernel.

Both kernels are also registered ops, `s3od::winograd_conv` and
`s3od::winograd_rcu` (`_build.via_ops`), whose implementations are
`_winograd_conv` and `_winograd_rcu`; their outputs keep the input's
memory order on every device (`_in_layout`), and their FLOP formulas
count the products of the Winograd algorithm that the kernels and the
plain versions do: U's two small products and the 16 (P, C) x (C, K)
products over P = B (H/2) (W/2) tiles, 4/9 of a direct conv's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from s3od_torch import _build
from s3od_torch.ops.autograd import plain_vjp

# F(2x2, 3x3) transform matrices; B^T and A^T hold only 0 and +-1.
_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))

# The JAX package's VMEM budget for its block picker (`winograd.py:60-63`).
_VMEM_BUDGET = 11 * 1024 * 1024

MAX_SMEM = 232448  # bytes of shared memory one H100 block may use


_G_ON: dict = {}  # device -> G: one host-to-device copy, not one a call


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, K) HWIO -> (16, C, K) Winograd-domain weights, fp32.
    Under `torch.export` G is made in the graph, never cached: a cached
    fake tensor would reach the next eager call."""
    g = _G_ON.get(w.device)
    if g is None:
        g = torch.tensor(_G, dtype=torch.float32, device=w.device)
        if not torch.compiler.is_exporting():
            _G_ON[w.device] = g
    # G w over k, then G over l: two matmuls (an einsum lowered to far
    # slower kernels on the card), bit-identical to it on the CPU
    t = torch.matmul(g, w.float().reshape(3, -1)).reshape(4, 3, -1)
    return torch.matmul(g, t).reshape(16, w.shape[2], w.shape[3])


# ----------------------------------------------------------------------------
# Eligibility, as in the JAX package
# ----------------------------------------------------------------------------


def _pick_rows(h_tiles: int, w2p: int, c: int, k: int, dtype_bytes: int):
    """Largest row-block (divisor of h_tiles) whose VMEM footprint fits."""
    for th in (16, 8, 4, 2, 1):
        if h_tiles % th:
            continue
        x_bytes = (th + 1) * w2p * 4 * c * dtype_bytes
        u_bytes = 16 * c * k * dtype_bytes
        out_bytes = 2 * th * (w2p - 1) * 4 * k * dtype_bytes
        live = 8 * (w2p - 1) * max(c, k) * 4
        if x_bytes + u_bytes + out_bytes + live <= _VMEM_BUDGET:
            return th
    return None


def winograd_available(h: int, w: int, c: int, k: int,
                       dtype=torch.bfloat16) -> bool:
    """Whether a 3x3/s1/p1 conv of this shape computes in the Winograd
    domain (`winograd.py:167-179`)."""
    if h % 2 or w % 16 or h < 16 or w < 16:
        return False
    if c % 128 or k % 128:
        return False
    if w // 2 < 64:
        return False
    w2p = -(-(w // 2 + 1) // 8) * 8
    return _pick_rows(h // 2, w2p, c, k, dtype.itemsize) is not None


def _pick_rows_rcu(h_tiles: int, w2p: int, c: int, dtype_bytes: int):
    for th in (16, 8, 4, 2):
        if h_tiles % th:
            continue
        x_bytes = (th + 3) * w2p * 4 * c * dtype_bytes
        h_bytes = (th + 3) * w2p * 4 * c * dtype_bytes
        u_bytes = 2 * 16 * c * c * dtype_bytes
        out_bytes = 2 * th * (w2p - 1) * 4 * c * dtype_bytes
        live = 8 * (w2p - 1) * c * 4
        if x_bytes + h_bytes + u_bytes + out_bytes + live <= _VMEM_BUDGET:
            return th
    return None


def rcu_winograd_available(h: int, w: int, c: int,
                           dtype=torch.bfloat16) -> bool:
    """Whether a BN-folded RCU of this shape runs chained
    (`winograd.py:388-395`)."""
    if h % 2 or w % 16 or h < 16 or w < 16:
        return False
    if c % 128 or w // 2 < 64:
        return False
    w2p = -(-(w // 2 + 1) // 8) * 8
    return _pick_rows_rcu(h // 2, w2p, c, dtype.itemsize) is not None


# ----------------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------------


def winograd_transform_plain(x: torch.Tensor, relu: bool = False) -> torch.Tensor:
    """V = B^T d B of every 2x2 output tile's 4x4 input patch (zero
    padding 1), in the TPU kernel's order of additions, rounded to x's
    dtype: x (B, H, W, C) (H, W even) -> (16, B (H/2) (W/2), C), a row per
    tile in (b, tile row, tile col) order — the layout K9b's transform
    launch writes. With `relu`, x is ReLU'd first."""
    bsz, h, w, c = x.shape
    ht, wt = h // 2, w // 2
    xp = F.pad((torch.relu(x) if relu else x).float(), (0, 0, 1, 1, 1, 1))

    def slab(p, q):  # input-patch position (p, q) of every tile: (B, Ht, Wt, C)
        return xp[:, p: p + 2 * ht: 2, q: q + 2 * wt: 2]

    out = []
    for uu in range(4):
        t = []
        for q in range(4):
            s = None
            for p in range(4):
                cf = _BT[uu][p]
                if cf:
                    term = slab(p, q) if cf > 0 else -slab(p, q)
                    s = term if s is None else s + term
            t.append(s)
        for vv in range(4):
            v = None
            for q in range(4):
                cf = _BT[vv][q]
                if cf:
                    term = t[q] if cf > 0 else -t[q]
                    v = term if v is None else v + term
            out.append(v.to(x.dtype).reshape(-1, c))
    return torch.stack(out, 0)


def _fold(v: torch.Tensor, u: torch.Tensor, shape) -> torch.Tensor:
    """A^T (V U) A: v (16, P, C) and u (16, C, K) in the compute dtype,
    `shape` = (B, H, W) -> the fp32 accumulators (B, H, W, K), summed over
    uv in order (`_wino_row`)."""
    bsz, h, w = shape
    k = u.shape[-1]
    uf = u.float()
    acc = [[None, None], [None, None]]
    for uv in range(16):
        uu, vv = divmod(uv, 4)
        m = torch.matmul(v[uv].float(), uf[uv])
        for a in range(2):
            for b in range(2):
                cf = _AT[a][uu] * _AT[b][vv]
                if cf:
                    term = m if cf > 0 else -m
                    acc[a][b] = term if acc[a][b] is None else acc[a][b] + term
    y = torch.stack([torch.stack(row, 0) for row in acc], 0)  # (2, 2, P, K)
    y = y.reshape(2, 2, bsz, h // 2, w // 2, k).permute(2, 3, 0, 4, 1, 5)
    return y.reshape(bsz, h, w, k)


def _wino_fold(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """A^T (V U) A for every 2x2 output tile of a 3x3/s1/p1 conv: x (B, H,
    W, C) in the compute dtype (H, W even), u (16, C, K) rounded to it.
    Returns the fp32 accumulators as (B, H, W, K), in the TPU kernel's
    order of additions (`_wino_row`)."""
    return _fold(winograd_transform_plain(x), u, x.shape[:3])


def winograd_gemm_plain(v, u, shape, bias, res=None):
    """Plain version of K9b's GEMM launch: the fold of v (16, P, C) with u
    (16, C, K) for tiles of `shape` = (B, H, W), + bias; then ReLU (conv1)
    or, given `res` (B, H, W, K), + res (conv2); rounded once to v's dtype.
    """
    dt = v.dtype
    y = _fold(v, u, shape) + bias.to(dt).float()
    if res is None:
        return torch.relu(y).to(dt)
    return (y + res.float()).to(dt)


def _u(w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """U = G w G^T from the weights cast to the compute dtype, rounded to
    it (`conv.py:54` casts before `_forward` transforms)."""
    return transform_weights(w.to(dt)).to(dt)


def winograd_conv_plain(x, w, b):
    """Plain version of K9a: x (B, H, W, C), w (3, 3, C, K), b (K,) ->
    (B, H, W, K) in x's dtype."""
    dt = x.dtype
    return (_wino_fold(x, _u(w, dt)) + b.to(dt).float()).to(dt)


def winograd_rcu_plain(x, w1, b1, w2, b2):
    """Plain version of K9b: x + conv2(relu(conv1(relu(x)) + b1)) + b2,
    both convs C -> C; x (B, H, W, C), w HWIO (3, 3, C, C)."""
    dt = x.dtype
    h = (_wino_fold(torch.relu(x), _u(w1, dt)) + b1.to(dt).float())
    h = torch.relu(h).to(dt)
    y = _wino_fold(h, _u(w2, dt)) + b2.to(dt).float()
    return (y + x.float()).to(dt)


def _reference(x, w, b):
    """The direct conv + bias in x's dtype (`winograd.py:_reference`), NHWC
    / HWIO: what the gradients differentiate."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1) + b.to(x.dtype)


def _rcu_reference(x, w1, b1, w2, b2):
    h = _reference(torch.relu(x), w1, b1)
    return _reference(torch.relu(h), w2, b2) + x


# ----------------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------------


def _empty_like_layout(x: torch.Tensor, k: int) -> torch.Tensor:
    """A (B, H, W, k) NHWC-logical output in x's memory order: NCHW memory
    when x is a permuted NCHW tensor, else NHWC."""
    bsz, h, w, _ = x.shape
    if x.permute(0, 3, 1, 2).is_contiguous():
        return torch.empty(bsz, k, h, w, dtype=x.dtype,
                           device=x.device).permute(0, 2, 3, 1)
    return torch.empty(bsz, h, w, k, dtype=x.dtype, device=x.device)


# The launches of `csrc/winograd.cu` that K9a and K9b share, mirrored for
# the CPU tests: the input transform's blocks (32 tiles of one tile row x
# 64 channels) and the Winograd GEMM's (64 tiles x 128 output channels,
# 64-channel stages in a 6-deep ring; a producer and two consumer
# warpgroups, registers a thread after setmaxnreg).
TRANSFORM_TILES = 32
TRANSFORM_CHANNELS = 64
GEMM_TILES = 64
GEMM_CHANNELS = 128
GEMM_STAGE_CHANNELS = 64
GEMM_STAGES = 6
CONSUMER_REGS, PRODUCER_REGS = 232, 40
GRID_YZ = 65535  # a grid's y and z extents

# K9a's V scratch on the two-launch route: a conv runs in chunks of tile
# rows whose V (16, tiles, C) bf16 takes at most this many bytes, so that
# a batch of any size holds one bounded buffer. Chunks small enough to
# stay in L2 (16-64 MiB) ran slower on the H100.
V_SCRATCH_BYTES = 256 << 20


def _gemm_smem() -> int:
    """The GEMM's dynamic shared memory (`G_SMEM`): 1024 bytes of
    alignment slack, the ring of V (64 x 64) and U (64 x 128) bf16 tiles,
    13 mbarriers, two offsets a tile, K9b conv2's bf16 tile of x (128
    channels x 256 pixels)."""
    return (1024 + GEMM_STAGES * (GEMM_TILES + GEMM_CHANNELS)
            * GEMM_STAGE_CHANNELS * 2 + (2 * GEMM_STAGES + 1) * 8
            + GEMM_TILES * 16 + GEMM_CHANNELS * 4 * GEMM_TILES * 2)


def _transform_grid(rows: int, ht: int, wt: int, c: int) -> tuple:
    """The transform's grid over a chunk of `rows` tile rows (fewer than
    ht, or whole images: then one image's ht rows a grid row)."""
    rows_y = min(rows, ht)
    return (-(-wt // TRANSFORM_TILES), rows_y,
            -(-rows // rows_y) * (c // TRANSFORM_CHANNELS))


def rcu_plan(b: int, h: int, w: int, c: int) -> dict:
    """K9b's launches at x (b, h, w, c), each conv one chunk of the
    whole batch: the transform's grid, the GEMM's block count, its dynamic
    shared memory and the registers a consumer thread holds in fp32 (M, a
    stage's product and the four output accumulators, 64 x 64 each per
    warpgroup); the scratch the wrapper allocates: U1 and U2 (2, 16, c,
    c), V (16, P, c) and the intermediate h (b, h, w, c), bf16."""
    ht, wt = h // 2, w // 2
    p = b * ht * wt
    return {
        "transform_grid": _transform_grid(b * ht, ht, wt, c),
        "gemm_blocks": -(-p // GEMM_TILES) * (c // GEMM_CHANNELS),
        "smem": _gemm_smem(),
        "acc_regs": 6 * 64 * 64 // 128,
        "u_shape": (2, 16, c, c),
        "v_shape": (16, p, c),
        "h_shape": (b, h, w, c),
    }


# K9a's routes (`s3od_winograd_conv`): the input transform and the GEMM,
# two launches a chunk of tile rows through a V scratch; or one fused
# launch, V computed in shared memory (blocks of 2 x 32 tiles x 128 output
# channels; x's 6 x 80 pixel x 64 channel region by TMA).
TWO_LAUNCH, FUSED = 0, 1
FUSED_TILE_ROWS, FUSED_TILE_COLS = 2, 32
FUSED_SMEM = (1024 + 2 * 8 * GEMM_TILES * GEMM_STAGE_CHANNELS * 2
              + 2 * GEMM_STAGE_CHANNELS * GEMM_CHANNELS * 2
              + (2 * FUSED_TILE_ROWS + 2) * 80 * GEMM_STAGE_CHANNELS * 2 + 9 * 8)
FUSED_PRODUCERS = 2  # producer warpgroups: one thread loads U, the rest transform
FUSED_CONSUMER_REGS, FUSED_PRODUCER_REGS = 200, 56


def tma_layout(x: torch.Tensor) -> bool:
    """Whether TMA can read x (B, H, W, C) as the fused route does: NCHW
    or NHWC memory (W or C contiguous), the other strides multiples of 16
    bytes, at a 16-byte aligned address (the transform's chunked modes)."""
    sb, sh, sw, sc = x.stride()
    if sw == 1:
        minor_ok = x.shape[2] % 8 == 0 and sc % 8 == 0
    elif sc == 1:
        minor_ok = sw % 8 == 0
    else:
        return False
    return minor_ok and sh % 8 == 0 and sb % 8 == 0 and x.data_ptr() % 16 == 0


def conv_route(k: int, tma: bool = True) -> int:
    """K9a's route at k output channels: fused where TMA can read x and
    the transform runs at most twice a tile (k <= 256: one block owns 128
    output channels), so V stays out of device memory; else the two
    launches, which transform once for all k / 128 channel blocks of the
    GEMM. Measured on the H100 at every gated shape: the fused route
    matched the two launches at k = 256 and beat them at k = 128 (0.39
    against 0.58 ms at 512^2 x 256 -> 128); at k = 512 the two launches
    won (1.28 against 1.55 ms)."""
    return FUSED if tma and k <= 2 * GEMM_CHANNELS else TWO_LAUNCH


def conv_plan(b: int, h: int, w: int, c: int, k: int, tma: bool = True) -> dict:
    """K9a's launches at x (b, h, w, c) -> k channels. Both routes first
    transform the weights (U, (16, c, k) bf16 scratch, one launch).
    Two launches: the batch's b (h/2) tile rows in chunks of `chunk_rows`
    (whole images where one image's V fits `V_SCRATCH_BYTES`, else a part of
    one), each an input transform into the V scratch and the Winograd
    GEMM with the bias epilogue; the grids of a full chunk, the scratch V
    (16, chunk tiles, c) bf16. Fused: one launch of 2 x 32 tiles x 128
    channels a block, no V scratch. With the GEMM's shared memory and the
    consumers' fp32 accumulator registers (a stage's product and the four
    output accumulators; the two-launch GEMM also holds M)."""
    route = conv_route(k, tma)
    ht, wt = h // 2, w // 2
    u_bytes = 16 * c * k * 2
    if route == FUSED:
        return {
            "route": FUSED, "chunk_rows": b * ht, "chunks": 1,
            "grid": (-(-wt // FUSED_TILE_COLS), -(-ht // FUSED_TILE_ROWS),
                     b * (k // GEMM_CHANNELS)),
            "smem": FUSED_SMEM, "acc_regs": 5 * 64 * 64 // 128,
            "v_shape": (0,), "u_shape": (16, c, k),
            "scratch_bytes": u_bytes,
        }
    row_bytes = 16 * wt * c * 2
    if ht * row_bytes <= V_SCRATCH_BYTES:
        rows = ht * min(b, V_SCRATCH_BYTES // (ht * row_bytes))
    else:
        rows = max(1, min(ht - 1, V_SCRATCH_BYTES // row_bytes))
    tiles = rows * wt
    return {
        "route": TWO_LAUNCH,
        "chunk_rows": rows,
        "chunks": -(-(b * ht) // rows),
        "transform_grid": _transform_grid(rows, ht, wt, c),
        "gemm_blocks": -(-tiles // GEMM_TILES) * (k // GEMM_CHANNELS),
        "smem": _gemm_smem(),
        "acc_regs": 6 * 64 * 64 // 128,
        "v_shape": (16, tiles, c),
        "u_shape": (16, c, k),
        "scratch_bytes": 16 * tiles * c * 2 + u_bytes,
    }


def check_rcu_inputs(x, w1, b1, w2, b2) -> None:
    """Raise on inputs the K9b kernel does not take: bf16 x (B, H, W, C)
    with H and W even and C a multiple of 128 (the copied rule admits only
    such widths), w1, w2 (3, 3, C, C), b1, b2 (C,), and the grid's limits."""
    bsz, h, wd, c = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError("winograd_rcu kernel: bf16 inputs only")
    if (any(tuple(t.shape) != (3, 3, c, c) for t in (w1, w2))
            or any(tuple(t.shape) != (c,) for t in (b1, b2))
            or h % 2 or wd % 2 or c % GEMM_CHANNELS or not x.numel()):
        raise ValueError(f"winograd_rcu kernel: unsupported x={tuple(x.shape)} "
                         f"w1={tuple(w1.shape)} w2={tuple(w2.shape)}")
    plan = rcu_plan(bsz, h, wd, c)
    if (max(plan["transform_grid"][1:]) > GRID_YZ
            or plan["gemm_blocks"] > 2**31 - 1):
        raise ValueError(f"winograd_rcu kernel: x={tuple(x.shape)} exceeds the grid")


def check_conv_inputs(x, w, b) -> dict:
    """Raise on inputs the K9a kernel does not take — bf16 x (B, H, W, C)
    with H and W even and C a multiple of 64, w (3, 3, C, K) with K a
    multiple of 128, b (K,), and the grid's limits — else return its
    `conv_plan`. The copied rule admits only C and K multiples of 128."""
    bsz, h, wd, c = x.shape
    k = w.shape[-1]
    if x.dtype != torch.bfloat16:
        raise ValueError("winograd_conv kernel: bf16 inputs only")
    if (tuple(w.shape) != (3, 3, c, k) or tuple(b.shape) != (k,)
            or h % 2 or wd % 2 or c % TRANSFORM_CHANNELS or k % GEMM_CHANNELS
            or not x.numel()):
        raise ValueError(f"winograd_conv kernel: unsupported x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} b={tuple(b.shape)}")
    plan = conv_plan(bsz, h, wd, c, k, tma=tma_layout(x))
    grid = plan["grid" if plan["route"] == FUSED else "transform_grid"]
    if max(grid[1:]) > GRID_YZ or bsz * (h // 2) * (wd // 2) > 2**31 - 1:
        raise ValueError(f"winograd_conv kernel: x={tuple(x.shape)} exceeds the grid")
    return plan


def _in_layout(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`out` (B, H, W, K) in the memory order `_empty_like_layout` gives
    for x: the layout the kernels write and the ops' fake implementations
    describe (a copy only where a plain version wrote another)."""
    dst = _empty_like_layout(x, out.shape[-1])
    return out if dst.stride() == out.stride() else dst.copy_(out)


def winograd_conv(x, w, b):
    """K9a: the 3x3/s1/p1 conv + bias through the Winograd domain: U's
    transform, then either one fused launch (k = 128) or, in chunks of
    tile rows, an input transform into a bounded V scratch and the TMA +
    wgmma Winograd GEMM (`conv_plan`).

    CPU tensors take the plain version. CUDA tensors launch the kernels or
    raise (`check_conv_inputs`)."""
    if _build.via_ops():
        return torch.ops.s3od.winograd_conv(x, w, b)
    return _winograd_conv(x, w, b)


def _winograd_conv(x, w, b):
    """`winograd_conv`'s implementation, and its op's."""
    if x.device.type == "cpu":
        return winograd_conv_plain(x, w, b)
    plan = check_conv_inputs(x, w, b)
    bsz, h, wd, c = x.shape
    k = w.shape[-1]
    w = w.to(x.dtype)
    bias = b.to(x.dtype).contiguous()
    with _build.launch(winograd_conv):
        ubuf = torch.empty(plan["u_shape"], dtype=x.dtype, device=x.device)
        vbuf = torch.empty(plan["v_shape"], dtype=x.dtype, device=x.device)
        out = _empty_like_layout(x, k)
        lib = _build.load_library()
        code = lib.s3od_winograd_conv(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            ubuf.data_ptr(), vbuf.data_ptr(), bsz, c, h, wd, k, plan["chunk_rows"],
            plan["route"], *w.stride(), *x.stride(), *out.stride(),
            _build.stream_ptr(x))
        _build.check(code, "winograd_conv")
    return out


winograd_conv.launches = 0


def winograd_rcu(x, w1, b1, w2, b2):
    """K9b: x + conv2(relu(conv1(relu(x)) + b1)) + b2, one call of six
    device launches (U1 and U2, then each conv's input transform and
    Winograd GEMM); the intermediate goes through a bf16 scratch tensor.

    CPU tensors take the plain version. CUDA tensors launch the kernels or
    raise (`check_rcu_inputs`)."""
    if _build.via_ops():
        return torch.ops.s3od.winograd_rcu(x, w1, b1, w2, b2)
    return _winograd_rcu(x, w1, b1, w2, b2)


def _winograd_rcu(x, w1, b1, w2, b2):
    """`winograd_rcu`'s implementation, and its op's."""
    if x.device.type == "cpu":
        return winograd_rcu_plain(x, w1, b1, w2, b2)
    check_rcu_inputs(x, w1, b1, w2, b2)
    bsz, h, wd, c = x.shape
    w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
    b1, b2 = b1.to(x.dtype).contiguous(), b2.to(x.dtype).contiguous()
    plan = rcu_plan(bsz, h, wd, c)
    with _build.launch(winograd_rcu):
        ubuf = torch.empty(plan["u_shape"], dtype=x.dtype, device=x.device)
        hbuf = torch.empty(plan["h_shape"], dtype=x.dtype, device=x.device)
        vbuf = torch.empty(plan["v_shape"], dtype=x.dtype, device=x.device)
        out = _empty_like_layout(x, c)
        lib = _build.load_library()
        code = lib.s3od_winograd_rcu(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), ubuf.data_ptr(), hbuf.data_ptr(), vbuf.data_ptr(),
            out.data_ptr(), bsz, c, h, wd, *w1.stride(), *w2.stride(),
            *x.stride(), *out.stride(), _build.stream_ptr(x))
        _build.check(code, "winograd_rcu")
    return out


winograd_rcu.launches = 0


def _winograd_conv_op(x: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    return _in_layout(_winograd_conv(x, w, b), x)


def _winograd_conv_fake(x, w, b):
    return _empty_like_layout(x, w.shape[-1])


_build.register_op("winograd_conv", _winograd_conv_op, _winograd_conv_fake)


def _winograd_rcu_op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    return _in_layout(_winograd_rcu(x, w1, b1, w2, b2), x)


def _winograd_rcu_fake(x, w1, b1, w2, b2):
    return _empty_like_layout(x, x.shape[-1])


_build.register_op("winograd_rcu", _winograd_rcu_op, _winograd_rcu_fake)


def winograd_flops(x_shape, k: int) -> int:
    """Products of one Winograd conv of x (B, H, W, C) -> k channels: U
    (G w: 4 x 3 x 3Ck, then G over the other axis: 4 x (4 x 3 x Ck)) and
    the 16 (P, C) x (C, k) products."""
    bsz, h, w, c = x_shape
    p = bsz * (h // 2) * (w // 2)
    return 2 * 16 * p * c * k + (72 + 96) * c * k


@register_flop_formula(torch.ops.s3od.winograd_conv)
def _winograd_conv_flops(x_shape, w_shape, *args, out_shape=None, **kwargs):
    return winograd_flops(x_shape, w_shape[-1])


@register_flop_formula(torch.ops.s3od.winograd_rcu)
def _winograd_rcu_flops(x_shape, *args, out_shape=None, **kwargs):
    return 2 * winograd_flops(x_shape, x_shape[-1])


# ----------------------------------------------------------------------------
# Gradients (`_bwd_rule`, `_rcu_bwd`) and the public functions
# ----------------------------------------------------------------------------


class _WinogradConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return winograd_conv(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad
        db = g.sum((0, 1, 2)).to(b.dtype) if need_b else None
        dw = (plain_vjp(_reference, (x, w, b), (False, True, False), (g,))[1]
              if need_w else None)
        dx = None
        if need_x:
            _, h, wd, _ = g.shape
            c, k = w.shape[2], w.shape[3]
            w_t = w.flip(0, 1).transpose(2, 3)  # (3, 3, K, C)
            zero = torch.zeros(c, dtype=g.dtype, device=g.device)
            if winograd_available(h, wd, k, c, g.dtype):
                dx = winograd_conv(g, w_t, zero)
            else:
                dx = _reference(g, w_t, zero)
            dx = dx.to(x.dtype)
        return dx, dw, db


class _WinogradRCU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return winograd_rcu(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return plain_vjp(_rcu_reference, ctx.saved_tensors,
                         ctx.needs_input_grad, (g,))


winograd_conv_autograd = _WinogradConv.apply
winograd_rcu_autograd = _WinogradRCU.apply


def conv3x3_winograd(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Drop-in for a 3x3/s1/p1 conv + optional bias (zeros when absent):
    x (B, H, W, C), p = {kernel: (3, 3, C, K), bias?: (K,)}. The caller
    checks `winograd_available` first."""
    w = p["kernel"]
    b = p.get("bias")
    if b is None:
        b = torch.zeros(w.shape[-1], dtype=x.dtype, device=x.device)
    return winograd_conv_autograd(x, w, b)


def rcu_winograd(x: torch.Tensor, p1: dict, p2: dict) -> torch.Tensor:
    """The whole BN-folded ResidualConvUnit in one kernel: x (B, H, W, C),
    p1, p2 = {kernel: (3, 3, C, C), bias: (C,)}. The caller checks
    `rcu_winograd_available` first."""
    return winograd_rcu_autograd(x, p1["kernel"], p1["bias"], p2["kernel"],
                                 p2["bias"])
