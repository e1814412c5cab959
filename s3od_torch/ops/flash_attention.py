"""K3 and K6: attention forward under the static softmax bound (CUDA) and
its plain version; K7, the forward with the exact row-max (online)
softmax that the MMDiT runs (CUDA, `csrc/flash_attention_online.cu`: TMA,
wgmma and warp specialisation), with its plain version; K8, the backward
of both (CUDA, `csrc/flash_attention_bwd.cu`, D in {32, 64, 128}), with
its plain version; and the two `autograd.Function`s that join each
forward to K8, as the JAX package's one `custom_vjp` does.

One CUDA kernel replaces two TPU kernels of `s3od_tpu/ops/flash_attention.py`
(both via `_flash_forward(static_bound=True)`):
- K3 `_fwd_kernel_single`, all keys in one VMEM block — the 1024^2 path
  (4101 tokens, padded to 4160 here);
- K6 `_fwd_kernel_stream_static`, streaming over K blocks — the 2048^2
  path (16389 tokens, padded to 16448 here; 16896 on the TPU).
Under the static bound the two compute the same thing: the kernel streams
key tiles with no running max and no rescale at every length. At D = 64
it is K7's warp-specialised TMA + wgmma kernel (`csrc/flash_fwd_ws.cuh`)
with the static bound; at D = 32 (the tiny checkpoints) the first,
mma.sync kernel, by an explicit dispatch on D (`kernel_route`). The design
note is in `s3od_torch/csrc/flash_attention.cu`; K8's, with the same
dispatch, in `s3od_torch/csrc/flash_attention_bwd.cu`.

The softmax subtracts the constant SOFTMAX_BOUND_HI instead of the row max
after clipping the logits to [LO, HI]: exact by shift invariance while the
row maxima sit inside the window (validated for DINOv3 ViTs in the JAX
package), and finite for any finite input. The scale is folded into q by
K2, so this op has none.

The port pads the token sequence to a multiple of 64 (`flash_seq_len`),
the kernel's tile; the TPU's block rule (`_pick_blocks`, a VMEM limit) is
not ported. Padding is transparent: padded keys are masked through
`n_valid` and padded tokens carry identity RoPE rows.
"""

from __future__ import annotations

import torch

from s3od_torch import _build

SOFTMAX_BOUND_HI = 40.0
SOFTMAX_BOUND_LO = -40.0
NEG_INF = -1e30
SEQ_MULTIPLE = 64


def flash_seq_len(n: int) -> int:
    """Sequence length the kernel route pads `n` tokens to."""
    return -(-n // SEQ_MULTIPLE) * SEQ_MULTIPLE


# Elements of one fp32 (BH, rows, N) logit chunk in the plain versions:
# 2^27 (512 MiB) keeps the 2048^2 shape (12 x 16448^2, 13 GB a tensor
# unchunked) inside device memory.
CHUNK_ELEMS = 1 << 27


def query_chunk(bh: int, n: int, chunk_elems: int = CHUNK_ELEMS) -> int:
    """Query rows per chunk so that one (bh, rows, n) tensor holds at most
    `chunk_elems` elements (at least one row)."""
    return max(1, chunk_elems // max(1, bh * n))


def row_chunks(n: int, chunk: int):
    """Split n rows into equal chunks of at most `chunk` rows. Equal
    chunks leave no one-row tail, which a CPU BLAS would run as a
    matrix-vector product with another summation order."""
    parts = -(-n // chunk)
    size = -(-n // parts)
    return [(i, min(n, i + size)) for i in range(0, n, size)]


def flash_attention_plain(q, k, v, n_valid: int, chunk: int = 0):
    """Plain version of K3/K6. q, k, v (BH, N, D) -> (o (BH, N, D) in q's
    dtype, lse (BH, N) fp32). Keys at or past n_valid are masked. Query
    rows are independent, so they run in chunks of at most `chunk` rows
    (default `query_chunk`): the numbers do not depend on the chunking."""
    bh, n = q.shape[:2]
    chunk = chunk or query_chunk(bh, k.shape[1])
    kt, vf = k.float().transpose(1, 2), v.float()
    bias = None
    if n_valid < k.shape[1]:
        bias = torch.zeros(k.shape[1], device=q.device, dtype=torch.float32)
        bias[n_valid:] = NEG_INF
    outs, lses = [], []
    for i, j in row_chunks(n, chunk):
        s = torch.matmul(q[:, i: j].float(), kt)
        if bias is not None:
            s = s + bias
        p = torch.exp(s.clamp(SOFTMAX_BOUND_LO, SOFTMAX_BOUND_HI)
                      - SOFTMAX_BOUND_HI)
        del s
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vf) / l
        outs.append(o.to(q.dtype))
        lses.append(SOFTMAX_BOUND_HI + torch.log(l[..., 0]))
    return torch.cat(outs, 1), torch.cat(lses, 1)


def kernel_route(d: int) -> str:
    """The kernel that serves head dimension d in K3/K6 and K8: the
    TMA + wgmma kernels at D = 64 (and K8's single pass at D = 128,
    `bwd_plan`), the mma.sync ones at D = 32 (the C entry points dispatch
    on D the same way)."""
    return {128: "wgmma", 64: "wgmma", 32: "mma.sync"}[d]


def flash_attention(q, k, v, n_valid: int):
    """Static-bound attention forward -> (o, lse).

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: bf16 (BH, N, D) with N a multiple of 64 and D in {32, 64}."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, n_valid)
    bh, n, d = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: bf16 q, k, v only")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention kernel: q, k, v shapes differ")
    if n % SEQ_MULTIPLE or d not in (32, 64) or not 0 < n_valid <= n:
        raise ValueError(
            f"flash_attention kernel: unsupported N={n} D={d} "
            f"n_valid={n_valid}")
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), device=q.device, dtype=torch.float32)
    lib = _build.load_library()
    code = lib.s3od_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, n, d, n_valid, _build.stream_ptr(q),
    )
    _build.check(code, "flash_attention")
    _build.count_launch(flash_attention)
    return o, lse


flash_attention.launches = 0


def flash_attention_bwd_plain(q, k, v, o, lse, g, n_valid: int):
    """Plain version of K8: the gradients (dq, dk, dv) of `o` from
    `flash_attention` against its cotangent g, in q's dtype.

    The semantics of `_bwd_*_kernel` (`s3od_tpu/ops/flash_attention.py`,
    scale 1): delta = rowsum(o g) in fp32; p = exp(min(s - lse, 0)) with
    keys at or past n_valid masked; ds = p (g v^T - delta); p and ds are
    rounded to q's dtype before the products dv = p^T g, dk = ds^T q and
    dq = ds k, which sum in fp32. Query rows run in chunks of
    `query_chunk` rows, so dk and dv sum over chunks."""
    bh, n = q.shape[:2]
    dt = q.dtype
    chunk = query_chunk(bh, k.shape[1])
    delta = (o.float() * g.float()).sum(-1, keepdim=True)
    kf, vf = k.float(), v.float()
    bias = None
    if n_valid < k.shape[1]:
        bias = torch.zeros(k.shape[1], device=q.device, dtype=torch.float32)
        bias[n_valid:] = NEG_INF
    dk = torch.zeros(k.shape, device=q.device, dtype=torch.float32)
    dv = torch.zeros(v.shape, device=q.device, dtype=torch.float32)
    dqs = []
    for i, j in row_chunks(n, chunk):
        qi, gi = q[:, i: j].float(), g[:, i: j].float()
        s = torch.matmul(qi, kf.transpose(1, 2))
        if bias is not None:
            s = s + bias
        p = torch.exp((s - lse[:, i: j, None]).clamp_max(0.0))
        del s
        dv += torch.matmul(p.to(dt).float().transpose(1, 2), gi)
        ds = p * (torch.matmul(gi, vf.transpose(1, 2)) - delta[:, i: j])
        del p
        ds = ds.to(dt).float()
        dqs.append(torch.matmul(ds, kf).to(dt))
        dk += torch.matmul(ds.transpose(1, 2), qi)
    return torch.cat(dqs, 1), dk.to(dt), dv.to(dt)


def flash_attention_bwd(q, k, v, o, lse, g, n_valid: int):
    """K8: (dq, dk, dv) of the attention forward (K3/K6 or K7).

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: bf16 (BH, N, D) q, k, v, o, g with N a multiple of 64 and D in
    {32, 64, 128}, fp32 (BH, N) lse, K3/K6's or K7's (with K7's exact
    lse the clamp min(s - lse, 0) changes nothing). delta = rowsum(o g) in
    fp32, which the JAX package computes outside its kernels, is the
    kernel's first pass, into a scratch allocated here. At D = 128 one
    kernel then computes dk, dv and dq in a single pass (5 products): dq
    is summed across key blocks into a zeroed fp32 (BH, N, 128) scratch
    allocated here, and a last pass rounds it to bf16, so dq's sum order
    varies from run to run while dk and dv stay one block's sums. D = 64
    runs a dkv and a dq kernel, D = 32 their mma.sync forms."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, g, n_valid)
    bh, n, d = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, o, g)):
        raise ValueError("flash_attention_bwd kernel: bf16 q, k, v, o, g only")
    if any(t.shape != q.shape for t in (k, v, o, g)):
        raise ValueError("flash_attention_bwd kernel: shapes differ")
    if lse.shape != (bh, n) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd kernel: fp32 (BH, N) lse")
    if n % SEQ_MULTIPLE or d not in (32, 64, 128) or not 0 < n_valid <= n:
        raise ValueError(
            f"flash_attention_bwd kernel: unsupported N={n} D={d} "
            f"n_valid={n_valid}")
    q, k, v, o, g, lse = (_build.aligned16(t) for t in (q, k, v, o, g, lse))
    delta = torch.empty((bh, n), device=q.device, dtype=torch.float32)
    dq_acc = (torch.zeros((bh, n, d), device=q.device, dtype=torch.float32)
              if d == 128 else None)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _build.load_library()
    code = lib.s3od_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
        None if dq_acc is None else dq_acc.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, n, d, n_valid, _build.stream_ptr(q),
    )
    _build.check(code, "flash_attention_bwd")
    _build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_attention_online_plain(q, k, v, n_valid: int):
    """Plain version of K7: the exact row-max softmax, as
    `_fwd_kernel_single(static_bound=False)` computes it in one block.
    q, k, v (BH, N, D) -> (o (BH, N, D) in q's dtype, lse (BH, N) fp32).
    Keys at or past n_valid get the bias -1e30; m is the row max,
    p = exp(s - m) is rounded to v's dtype for P V while l sums the fp32
    p; o = (P V) / l and lse = m + log l. Query rows run in chunks of
    `query_chunk` rows."""
    bh, n = q.shape[:2]
    chunk = query_chunk(bh, k.shape[1])
    kt, vf = k.float().transpose(1, 2), v.float()
    bias = None
    if n_valid < k.shape[1]:
        bias = torch.zeros(k.shape[1], device=q.device, dtype=torch.float32)
        bias[n_valid:] = NEG_INF
    outs, lses = [], []
    for i, j in row_chunks(n, chunk):
        s = torch.matmul(q[:, i: j].float(), kt)
        if bias is not None:
            s = s + bias
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        del s
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vf) / l
        outs.append(o.to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    return torch.cat(outs, 1), torch.cat(lses, 1)


# The tile plan of `csrc/flash_attention_online.cu` (K7), mirrored so that
# the CPU tests can check it at every shape the MMDiT and ViT-L give it.
ONLINE_BLOCK_Q = 128    # query rows of a block (two consumer warpgroups)
ONLINE_BLOCK_K = 128    # keys of one K or V tile
ONLINE_STAGES = 2       # depth of the K ring and of the V ring
ONLINE_THREADS = 384    # producer warpgroup + two consumer warpgroups
ONLINE_PRODUCER_REGS, ONLINE_CONSUMER_REGS = 24, 240
MAX_SMEM = 232448       # bytes of shared memory one H100 block may use


def online_plan(bh: int, n: int, d: int, n_valid: int) -> dict:
    """K7's launch at (bh, n, d): the grid (query blocks, heads), the key
    tiles each block walks, dynamic shared memory (1024 bytes of
    alignment slack, Q and the two K and V stages as 128 x 64 bf16 atoms,
    9 mbarriers) and the registers a consumer thread holds for the S
    (64 x 128) and O (64 x d) fp32 accumulators and the bf16 P fragment."""
    atom_bytes = ONLINE_BLOCK_K * 64 * 2
    return {
        "grid": (-(-n // ONLINE_BLOCK_Q), bh),
        "key_tiles": -(-n_valid // ONLINE_BLOCK_K),
        "smem": 1024 + (1 + 2 * ONLINE_STAGES) * (d // 64) * atom_bytes + 9 * 8,
        "acc_regs": ONLINE_BLOCK_K // 2 + d // 2 + ONLINE_BLOCK_K // 4,
    }


# K3/K6's D = 64 launch: the kernel of `csrc/flash_fwd_ws.cuh` with the
# static bound and three consumer warpgroups (K7 has two).
STATIC_WARPGROUPS = 3
STATIC_BLOCK_Q = 64 * STATIC_WARPGROUPS   # query rows of a block
STATIC_THREADS = 128 * (STATIC_WARPGROUPS + 1)
STATIC_PRODUCER_REGS, STATIC_CONSUMER_REGS = 32, 160


def static_plan(bh: int, n: int, d: int, n_valid: int) -> dict:
    """K3/K6's D = 64 launch at (bh, n, d): the grid (blocks of 192 query
    rows, heads), the 128-key tiles it walks — to N and not to n_valid,
    since keys in [n_valid, N) weigh e^-80, the last one reaching past N
    where N is an odd multiple of 64 — dynamic shared memory (1024 bytes
    of alignment slack, Q, the two K and V stages, 9 mbarriers) and the
    registers a consumer thread holds for S (64 x 128) and O (64 x d) in
    fp32 and the bf16 P fragment."""
    atoms = d // 64
    return {
        "grid": (-(-n // STATIC_BLOCK_Q), bh),
        "key_tiles": -(-n // ONLINE_BLOCK_K),
        "smem": 1024 + atoms * (STATIC_BLOCK_Q + 2 * ONLINE_STAGES
                                * ONLINE_BLOCK_K) * 64 * 2 + 9 * 8,
        "acc_regs": ONLINE_BLOCK_K // 2 + d // 2 + ONLINE_BLOCK_K // 4,
    }


# The tile plan of K8's wgmma kernels (`csrc/flash_attention_bwd.cu`),
# mirrored for the CPU tests. At D = 64 a dkv kernel of two consumer
# warpgroups (240 registers each) that overlaps a tile's S^T, dP^T products
# with the previous tile's dV, dK products, and a dq kernel of three (160
# each): 7 products. At D = 128 one kernel of two (240 each), FlashAttention-
# 3's single pass: 5 products, the dQ partials reduce-added into an fp32
# accumulator in device memory.
BWD_TILE = 64                       # rows of a streamed tile: queries (dkv), keys (dq)
BWD_STAGES = 4                      # depth of each D = 64 kernel's ring
BWD_FUSED_STAGES = 3                # depth of the D = 128 single pass's ring
BWD_BLOCK_KEYS = 128                # keys of a dkv or single-pass block
BWD_WARPGROUPS = {64: {"dkv": 2, "dq": 3}, 128: {"fused": 2}}
BWD_OVERLAP = {64: True, 128: False}
BWD_PRODUCER_REGS = {2: 24, 3: 32}  # by consumer warpgroups, as `ws_producer_regs`
BWD_CONSUMER_REGS = {2: 240, 3: 160}


def bwd_plan(bh: int, n: int, d: int, n_valid: int) -> dict:
    """K8's launches at (bh, n, d): for each wgmma kernel the grid (blocks
    of 64 x warpgroups rows — keys in dkv and the single pass, queries in
    dq — and heads), the tiles it walks (dkv and the single pass: every
    64-row query tile, none crossing N; dq: the 64-key tiles up to
    n_valid), dynamic shared memory (1024 bytes of alignment slack, the
    block's two resident tiles, the ring, the mbarriers; the single pass
    also two bf16 dS^T buffers of 128 x 64 and a 64 x 128 fp32 dQ
    staging), the consumer warpgroups and their registers, and the
    registers a consumer thread holds at once: fp32 accumulators of
    64 x 64 (S^T, dP^T or S, dP; the single pass's dQ half) and of 64 x d
    (dK, dV; dq: dQ), and the bf16 A fragments (P^T and dS^T, which
    replace S^T and dP^T where the dkv kernel does not overlap; dq: dS).
    D = 64: "dkv" and "dq", 7 products (s and dp in both). D = 128:
    "fused", 5 products, and `dq_acc_bytes`, the fp32 accumulator the dQ
    partials are reduce-added into."""
    tile_bytes = BWD_TILE * d * 2
    lse_delta = 2 * BWD_TILE * 4
    sq, acc, frag = BWD_TILE * BWD_TILE // 128, BWD_TILE * d // 128, BWD_TILE // 4
    if d == 128:
        wgs = BWD_WARPGROUPS[d]["fused"]
        stages = BWD_FUSED_STAGES
        return {"products": 5, "dq_acc_bytes": 4 * bh * n * d, "fused": {
            "grid": (-(-n // BWD_BLOCK_KEYS), bh), "rows": BWD_BLOCK_KEYS,
            "tiles": n // BWD_TILE, "warpgroups": wgs, "stages": stages,
            "smem": 1024 + 2 * BWD_BLOCK_KEYS * d * 2
            + stages * (2 * tile_bytes + lse_delta)
            + 2 * BWD_BLOCK_KEYS * BWD_TILE * 2 + BWD_TILE * d * 4
            + (1 + 2 * stages) * 8,
            # dK, dV with P^T, dS^T and the dQ half (S^T, dP^T dead)
            "acc_regs": 2 * acc + 2 * frag + sq,
            "regs": BWD_CONSUMER_REGS[wgs],
            "producer_regs": BWD_PRODUCER_REGS[wgs]}}
    plan = {"products": 7}
    for kernel, ring, tiles, regs in (
            ("dkv", 2 * tile_bytes + lse_delta, n // BWD_TILE,
             2 * sq + 2 * acc + (2 * frag if BWD_OVERLAP[d] else 0)),
            ("dq", 2 * tile_bytes, -(-n_valid // BWD_TILE), 2 * sq + acc + frag)):
        wgs = BWD_WARPGROUPS[d][kernel]
        rows = 64 * wgs
        plan[kernel] = {"grid": (-(-n // rows), bh), "rows": rows,
                        "tiles": tiles, "warpgroups": wgs,
                        "smem": 1024 + 2 * rows * d * 2 + BWD_STAGES * ring
                        + (1 + 2 * BWD_STAGES) * 8,
                        "acc_regs": regs,
                        "regs": BWD_CONSUMER_REGS[wgs],
                        "producer_regs": BWD_PRODUCER_REGS[wgs]}
    return plan


def flash_attention_online(q, k, v, n_valid: int):
    """K7: attention forward with the online (row-max) softmax -> (o, lse);
    kernel source and design note in `s3od_torch/csrc/flash_attention_online.cu`.

    CPU tensors take the plain version. CUDA tensors launch the kernel or
    raise: bf16 (BH, N, D) with N a multiple of 64 and D in {64, 128}.
    The raw forward: `flash_attention_online_autograd` adds K8 as its
    backward."""
    if q.device.type == "cpu":
        return flash_attention_online_plain(q, k, v, n_valid)
    bh, n, d = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError("flash_attention_online kernel: bf16 q, k, v only")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_attention_online kernel: q, k, v shapes differ")
    if n % SEQ_MULTIPLE or d not in (64, 128) or not 0 < n_valid <= n:
        raise ValueError(
            f"flash_attention_online kernel: unsupported N={n} D={d} "
            f"n_valid={n_valid}")
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), device=q.device, dtype=torch.float32)
    lib = _build.load_library()
    code = lib.s3od_flash_attention_online_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, n, d, n_valid, _build.stream_ptr(q),
    )
    _build.check(code, "flash_attention_online")
    _build.count_launch(flash_attention_online)
    return o, lse


flash_attention_online.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K3/K6 forward, K8 backward; saves (q, k, v, o, lse) as the JAX
    forward rule does (`flash_attention.py:652-667`). On CPU tensors both
    wrappers take their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, n_valid):
        o, lse = flash_attention(q, k, v, n_valid)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.n_valid = n_valid
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, g, ctx.n_valid), None)


# Differentiable `flash_attention` -> o (the lse stays internal).
flash_attention_autograd = _FlashAttention.apply


class _FlashAttentionOnline(torch.autograd.Function):
    """K7 forward, K8 backward on K7's lse: the JAX package's one
    `custom_vjp` (`flash_attention.py:643-682`) with the online softmax.
    Saves (q, k, v, o, lse) as `_fwd_rule` does."""

    @staticmethod
    def forward(ctx, q, k, v, n_valid):
        o, lse = flash_attention_online(q, k, v, n_valid)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.n_valid = n_valid
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, g, ctx.n_valid), None)


# Differentiable `flash_attention_online` -> o.
flash_attention_online_autograd = _FlashAttentionOnline.apply
