"""The MMDiT's step from each stream's qkv linear output to K7's inputs:
q/k RMSNorm, 3-axis RoPE, q's softmax scale and the (B*H, N_pad, D)
head layout, as one Triton pass (`qk_norm_rope`), with its backward as a
second (`qk_norm_rope_bwd`), and the plain versions of both.

Replaces no TPU kernel: the JAX package leaves the chain
(`s3od_tpu/models/mmdit.py:_qkv_heads`, `apply_rope`, then
`ops/attention.py`'s `q * scale` and head transposes) to XLA, which fuses
it. Eager PyTorch runs it as ~25 fp32 ops a stream (upcasts, the RMS
statistic, the strided pair rotation, casts back, three transposes and a
pad), each a round trip through device memory, and autograd keeps fp32
copies for the backward.

Bound on the H100: memory. At FLUX.1-dev's 1024^2 step (4608 tokens, 24
heads of 128) the forward reads the (B, N, 3HD) bf16 linear output once
(85 MB) and writes q, k, v once (85 MB); the backward reads dq, dk, dv
(85 MB) and the pre-norm q, k (57 MB) and writes dqkv (85 MB): ~0.4 GB a
block, ~0.12 ms at 3.35 TB/s. One program is a block of 16 tokens of
one head: it loads each token's q, k and v row of D values once, takes
the RMS statistic over D in registers, splits each row into its (even,
odd) rotation pairs in registers (`tl.split`) and writes the three
outputs head-major. The RoPE tables (fp32, (N, D)) are shared by the 24
heads' programs of a token block through the L2. On an H100 80GB (700 W)
at that shape the forward takes ~0.069 ms (75% of its bytes bound) and
the backward ~0.088 ms (78%); a first design that read each partner by a
second load took 0.12 / 0.13 ms, and blocks of 32 or 64 tokens ran
slower still.

The forward rounds where the eager chain rounds: to bf16 after the norm,
after the rotation and after q's bf16 scale (`scale_in_dtype`), so its
outputs equal the chain's to within one bf16 ulp (the rsqrt's last fp32
bits, and a fused multiply-add where eager rounds two products). The
backward works in fp32 throughout (q's scale, RoPE's transpose, the
RMSNorm's input gradient from the statistic recomputed from the saved
bf16 pre-norm q and k) and rounds dqkv once; a norm weight's gradient,
where one is asked for, comes from per-program fp32 column sums summed
after, not atomics.

`triton` is imported only when a kernel launches. CPU tensors take the
plain versions.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import torch

from s3od_torch import _build
from s3od_torch.ops.attention import scale_in_dtype, to_bhnd

# tokens of one program, and its warps (both passes)
TOKENS, WARPS = 16, 8
EPS = 1e-6

Source = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


# ----------------------------------------------------------------------------
# The eager chain (plain versions)
# ----------------------------------------------------------------------------


def rms_norm(x, weight, eps=EPS):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(x.dtype)


def rotate_pairs(x):
    """(-x1, x0, -x3, x2, ...) interleaved rotation."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], -1).reshape(x.shape)


def apply_rope(q, k, cos, sin):
    """q, k (B, N, H, D); cos/sin (N, D). fp32 rotation, cast back."""
    c, s = cos[None, :, None, :], sin[None, :, None, :]

    def rot(t):
        tf = t.float()
        return (tf * c + rotate_pairs(tf) * s).to(t.dtype)

    return rot(q), rot(k)


def qk_norm_heads(qkv, q_weight, k_weight, head_dim: int):
    """A stream's (B, N, 3HD) qkv linear output, laid out (3, H, D) ->
    q, k RMS-normalised and v, each (B, N, H, D)."""
    y = qkv.reshape(*qkv.shape[:-1], 3, -1, head_dim)
    q, k, v = y.unbind(-3)
    return rms_norm(q, q_weight), rms_norm(k, k_weight), v


def qk_norm_rope_plain(sources: Sequence[Source], cos, sin, scale: float,
                       n_pad: int):
    """Plain version of `qk_norm_rope`: `qk_norm_heads` of each source,
    concatenated in token order, `apply_rope`, q times `scale` rounded to
    its dtype, then `to_bhnd` -> q, k, v (B*H, n_pad, D)."""
    d = cos.shape[-1]
    parts = [qk_norm_heads(qkv, wq, wk, d) for qkv, wq, wk in sources]
    q, k, v = (torch.cat(t, 1) if len(t) > 1 else t[0] for t in zip(*parts))
    q, k = apply_rope(q, k, cos, sin)
    q = q * scale_in_dtype(scale, q.dtype)
    return to_bhnd(q, n_pad), to_bhnd(k, n_pad), to_bhnd(v, n_pad)


def qk_norm_rope_bwd_plain(grads, sources: Sequence[Source], cos, sin,
                           scale: float, weight_grads: bool):
    """Plain version of `qk_norm_rope_bwd`, in fp32. grads: dq, dk, dv
    (B*H, n_pad, D), the cotangents of `qk_norm_rope`'s outputs. Returns
    ([dqkv of each source, (B, N_s, 3HD) in its dtype], [(dw_q, dw_k) of
    each source in the weights' dtype] or None): dn = RoPE's transpose of
    the cotangent (q's times the bf16 scale), then the RMSNorm's input
    gradient r u - x r^3 mean(u x) with u = dn w and the statistic r
    recomputed from the pre-norm x; dw = the sum of dn x r."""
    gq, gk, gv = grads
    b, d = sources[0][0].shape[0], cos.shape[-1]
    n = cos.shape[0]
    h = gq.shape[0] // b
    c, s = cos.float()[None, :, None, :], sin.float()[None, :, None, :]

    def heads(t):
        return t[:, :n].reshape(b, h, n, d).transpose(1, 2).float()

    def unrope(g):
        return g * c - rotate_pairs(g * s)

    dn_q = unrope(heads(gq) * scale_in_dtype(scale, torch.bfloat16))
    dn_k, dv = unrope(heads(gk)), heads(gv)
    dqkv, dws, n0 = [], [], 0
    for qkv, wq, wk in sources:
        n_s = qkv.shape[1]
        x = qkv.reshape(b, n_s, 3, h, d).float()
        rows = slice(n0, n0 + n_s)
        outs, dw = [], []
        for i, (dn, w) in enumerate(((dn_q, wq), (dn_k, wk))):
            xi, dni = x[:, :, i], dn[:, rows]
            r = torch.rsqrt(xi.square().mean(-1, keepdim=True) + EPS)
            u = dni * w.float()
            outs.append(r * u - xi * r**3 * (u * xi).mean(-1, keepdim=True))
            dw.append((dni * xi * r).sum((0, 1, 2)).to(w.dtype))
        outs.append(dv[:, rows])
        dqkv.append(torch.stack(outs, 2).reshape(qkv.shape).to(qkv.dtype))
        dws.append(tuple(dw))
        n0 += n_s
    return dqkv, dws if weight_grads else None


# ----------------------------------------------------------------------------
# The Triton passes
# ----------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _triton_kernels():
    import triton
    import triton.language as tl

    # Both kernels: program (token block, b * H + head). A token of the
    # concatenated sequence lies in source 0 below N0 and in source 1
    # from N0 to N (TWO); each load or store of a source's row is masked
    # to the rows of that source. W is the (4, D) fp32 stack of the norm
    # weights (q_0, k_0, q_1, k_1).

    @triton.jit
    def _rows(COS, SIN, N0, N, H, BLOCK_N: tl.constexpr, D: tl.constexpr):
        """The program's token block of (b, head): its tokens ns, the
        columns j, each source's row mask and row offsets, the rows of
        the sequence, and the (even, odd) halves of its tables."""
        bh = tl.program_id(1)
        b, hh = bh // H, bh % H
        ns = tl.program_id(0) * BLOCK_N + tl.arange(0, BLOCK_N)
        j = tl.arange(0, D)
        m0 = (ns < N0)[:, None]
        m1 = ((ns >= N0) & (ns < N))[:, None]
        row0 = ((b * N0 + ns).to(tl.int64) * (3 * H * D))[:, None]
        row1 = ((b * (N - N0) + ns - N0).to(tl.int64) * (3 * H * D))[:, None]
        valid = (ns < N)[:, None]
        tab = ns.to(tl.int64)[:, None] * D + j[None, :]
        ce, co = tl.split(tl.reshape(
            tl.load(COS + tab, mask=valid, other=0.0), (BLOCK_N, D // 2, 2)))
        se, so = tl.split(tl.reshape(
            tl.load(SIN + tab, mask=valid, other=0.0), (BLOCK_N, D // 2, 2)))
        return bh, hh, ns, j, m0, m1, row0, row1, valid, ce, co, se, so

    @triton.jit
    def _pre_norm(QKV0, QKV1, W, row0, row1, m0, m1, which, hh, j, H,
                  TWO: tl.constexpr, D: tl.constexpr):
        """The pre-norm q (which 0) or k (1) of the block's rows, fp32,
        from their sources, with each row's norm weight, and the columns
        they lie at in a source's row."""
        cj = ((which * H + hh) * D + j)[None, :]
        x = tl.load(QKV0 + row0 + cj, mask=m0, other=0.0).to(tl.float32)
        w = tl.load(W + which * D + j)[None, :]
        if TWO:
            x += tl.load(QKV1 + row1 + cj, mask=m1, other=0.0).to(tl.float32)
            w = tl.where(m0, w, tl.load(W + (2 + which) * D + j)[None, :])
        return cj, x, w

    @triton.jit
    def _fwd(QKV0, QKV1, W, COS, SIN, Q, K, V, N0, N, NP, H, scale, eps,
             TWO: tl.constexpr, BLOCK_N: tl.constexpr, D: tl.constexpr):
        bh, hh, ns, j, m0, m1, row0, row1, valid, ce, co, se, so = _rows(
            COS, SIN, N0, N, H, BLOCK_N, D)
        out = (bh * NP + ns).to(tl.int64)[:, None] * D + j[None, :]
        keep = (ns < NP)[:, None]
        for which in tl.static_range(2):       # q, k
            cj, x, w = _pre_norm(QKV0, QKV1, W, row0, row1, m0, m1, which,
                                 hh, j, H, TWO, D)
            r = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / D + eps)[:, None]
            nrm = (x * r * w).to(tl.bfloat16).to(tl.float32)
            ne, no = tl.split(tl.reshape(nrm, (BLOCK_N, D // 2, 2)))
            re = (ne * ce + (-no) * se).to(tl.bfloat16)
            ro = (no * co + ne * so).to(tl.bfloat16)
            rot = tl.reshape(tl.join(re, ro), (BLOCK_N, D))
            if which == 0:
                rot = (rot.to(tl.float32) * scale).to(tl.bfloat16)
                tl.store(Q + out, rot, mask=keep)
            else:
                tl.store(K + out, rot, mask=keep)
        cv = (2 * H * D + hh * D + j)[None, :]
        v = tl.load(QKV0 + row0 + cv, mask=m0, other=0.0)
        if TWO:
            v += tl.load(QKV1 + row1 + cv, mask=m1, other=0.0)
        tl.store(V + out, v, mask=keep)

    @triton.jit
    def _bwd(GQ, GK, GV, QKV0, QKV1, W, COS, SIN, DQKV0, DQKV1, PART,
             N0, N, NP, H, scale, eps, TWO: tl.constexpr, WGRAD: tl.constexpr,
             BLOCK_N: tl.constexpr, D: tl.constexpr):
        bh, hh, ns, j, m0, m1, row0, row1, valid, ce, co, se, so = _rows(
            COS, SIN, N0, N, H, BLOCK_N, D)
        grow = (bh * NP + ns).to(tl.int64)[:, None] * D + j[None, :]
        pid = tl.program_id(0) * tl.num_programs(1) + bh
        programs = tl.num_programs(0) * tl.num_programs(1)
        for which in tl.static_range(2):       # q, k
            if which == 0:
                g = tl.load(GQ + grow, mask=valid, other=0.0).to(tl.float32)
                g = g * scale
            else:
                g = tl.load(GK + grow, mask=valid, other=0.0).to(tl.float32)
            ge, go = tl.split(tl.reshape(g, (BLOCK_N, D // 2, 2)))
            # RoPE's transpose
            dn = tl.reshape(tl.join(ge * ce + go * so, go * co - ge * se),
                            (BLOCK_N, D))
            cj, x, w = _pre_norm(QKV0, QKV1, W, row0, row1, m0, m1, which,
                                 hh, j, H, TWO, D)
            r = 1.0 / tl.sqrt(tl.sum(x * x, axis=1) / D + eps)[:, None]
            u = dn * w
            dot = tl.sum(u * x, axis=1)[:, None] / D
            dx = (r * u - x * (r * r * r * dot)).to(tl.bfloat16)
            tl.store(DQKV0 + row0 + cj, dx, mask=m0)
            if TWO:
                tl.store(DQKV1 + row1 + cj, dx, mask=m1)
            if WGRAD:
                dw = dn * x * r
                tl.store(PART + (which * programs + pid) * D + j,
                         tl.sum(tl.where(m0, dw, 0.0), axis=0))
                if TWO:
                    tl.store(PART + ((2 + which) * programs + pid) * D + j,
                             tl.sum(tl.where(m1, dw, 0.0), axis=0))
        cv = (2 * H * D + hh * D + j)[None, :]
        gv = tl.load(GV + grow, mask=valid, other=0.0)
        tl.store(DQKV0 + row0 + cv, gv, mask=m0)
        if TWO:
            tl.store(DQKV1 + row1 + cv, gv, mask=m1)

    return triton, _fwd, _bwd


def _layout(sources: Sequence[Source], cos, sin):
    """(B, H, D, N, N_0) of the sources, after the checks the kernels need:
    one or two bf16 contiguous (B, N_s, 3HD) sources of one batch and
    width, (D,) weights, fp32 (N, D) tables, D a power of two."""
    if not 1 <= len(sources) <= 2:
        raise ValueError("qk_norm_rope kernel: one or two sources")
    n, d = cos.shape
    b, _, width = sources[0][0].shape
    h = width // (3 * d)
    for qkv, wq, wk in sources:
        if (qkv.dtype != torch.bfloat16 or not qkv.is_contiguous()
                or qkv.dim() != 3 or qkv.shape[0] != b
                or qkv.shape[2] != 3 * h * d
                or wq.shape != (d,) or wk.shape != (d,)):
            raise ValueError("qk_norm_rope kernel: unsupported source "
                             f"{qkv.dtype} {tuple(qkv.shape)}")
    if (d & (d - 1) or d < 2 or sin.shape != (n, d)
            or cos.dtype != torch.float32 or sin.dtype != torch.float32
            or sum(t[0].shape[1] for t in sources) != n):
        raise ValueError(f"qk_norm_rope kernel: unsupported tables {n} x {d}")
    return b, h, d, n, sources[0][0].shape[1]


def _pointers(sources: Sequence[Source]):
    """qkv_0, qkv_1 (the first source twice where there is one) and the
    (4, D) fp32 stack of the norm weights (q_0, k_0, q_1, k_1)."""
    (q0, wq0, wk0), (q1, wq1, wk1) = sources[0], sources[-1]
    return q0, q1, torch.stack([w.float() for w in (wq0, wk0, wq1, wk1)])


def qk_norm_rope(sources: Sequence[Source], cos, sin, scale: float,
                 n_pad: int):
    """The eager chain of `qk_norm_rope_plain` as one Triton pass: sources
    are one or two (qkv, q_weight, k_weight) in token order, qkv a
    contiguous (B, N_s, 3HD) bf16 linear output laid out (3, H, D), the
    weights the stream's `QKNorm.q` / `.k`; cos, sin the (N, D) fp32
    tables of the concatenated sequence. Returns q (RMS-normalised,
    rotated, times the bf16 scale), k (normalised, rotated) and v, each
    contiguous (B*H, n_pad, D) bf16 with the padded rows zero. CPU tensors
    take the plain version."""
    if sources[0][0].device.type == "cpu":
        return qk_norm_rope_plain(sources, cos, sin, scale, n_pad)
    b, h, d, n, n0 = _layout(sources, cos, sin)
    if n_pad < n:
        raise ValueError(f"qk_norm_rope kernel: n_pad {n_pad} < N {n}")
    cos, sin = cos.contiguous(), sin.contiguous()
    dev = cos.device
    with _build.launch(qk_norm_rope):
        q, k, v = (torch.empty((b * h, n_pad, d), device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        triton, kernel, _ = _triton_kernels()
        with _build.triton_cache():
            kernel[(triton.cdiv(n_pad, TOKENS), b * h)](
                *_pointers(sources), cos, sin, q, k, v, n0, n, n_pad, h,
                scale_in_dtype(scale, torch.bfloat16), EPS,
                TWO=len(sources) == 2, BLOCK_N=TOKENS, D=d,
                num_warps=WARPS)
    return q, k, v


qk_norm_rope.launches = 0


def qk_norm_rope_bwd(grads, sources: Sequence[Source], cos, sin,
                     scale: float, weight_grads: bool):
    """`qk_norm_rope`'s backward, `qk_norm_rope_bwd_plain` as one Triton
    pass on CUDA tensors: reads dq, dk, dv (B*H, n_pad, D) bf16 and the
    pre-norm q, k of the sources, writes each source's dqkv (B, N_s, 3HD)
    bf16, and with `weight_grads` the norm weights' gradients from
    per-program fp32 column sums (none are computed without)."""
    if sources[0][0].device.type == "cpu":
        return qk_norm_rope_bwd_plain(grads, sources, cos, sin, scale,
                                      weight_grads)
    b, h, d, n, n0 = _layout(sources, cos, sin)
    gq, gk, gv = (g.contiguous() for g in grads)
    n_pad = gq.shape[1]
    if (any(g.shape != (b * h, n_pad, d) or g.dtype != torch.bfloat16
            for g in (gq, gk, gv)) or n_pad < n):
        raise ValueError(f"qk_norm_rope_bwd kernel: unsupported g "
                         f"{gq.dtype} {tuple(gq.shape)}")
    cos, sin = cos.contiguous(), sin.contiguous()
    dev = cos.device
    two = len(sources) == 2
    with _build.launch(qk_norm_rope_bwd):
        triton, _, kernel = _triton_kernels()
        grid = (triton.cdiv(n_pad, TOKENS), b * h)
        dqkv = [torch.empty_like(src[0]) for src in sources]
        part = torch.empty((4 if two else 2, grid[0] * grid[1], d)
                           if weight_grads else (1,),
                           device=dev, dtype=torch.float32)
        with _build.triton_cache():
            kernel[grid](gq, gk, gv, *_pointers(sources), cos, sin,
                         dqkv[0], dqkv[-1], part, n0, n, n_pad, h,
                         scale_in_dtype(scale, torch.bfloat16), EPS,
                         TWO=two, WGRAD=weight_grads, BLOCK_N=TOKENS,
                         D=d, num_warps=WARPS)
    dws = None
    if weight_grads:
        sums = part.sum(1)
        dws = [(sums[2 * i].to(wq.dtype), sums[2 * i + 1].to(wk.dtype))
               for i, (_, wq, wk) in enumerate(sources)]
    return dqkv, dws


qk_norm_rope_bwd.launches = 0


class _QKNormRope(torch.autograd.Function):
    """`qk_norm_rope` forward, `qk_norm_rope_bwd` backward. Saves the
    sources (the bf16 linear outputs, whose first two thirds are the
    pre-norm q and k, and the weights) and the tables: no fp32 copy."""

    @staticmethod
    def forward(ctx, cos, sin, scale, n_pad, *flat):
        sources = [tuple(flat[i: i + 3]) for i in range(0, len(flat), 3)]
        ctx.save_for_backward(cos, sin, *flat)
        ctx.scale = scale
        return qk_norm_rope(sources, cos, sin, scale, n_pad)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        if any(ctx.needs_input_grad[:2]):
            raise NotImplementedError(
                "qk_norm_rope: the RoPE tables take no gradient")
        cos, sin, *flat = ctx.saved_tensors
        sources = [tuple(flat[i: i + 3]) for i in range(0, len(flat), 3)]
        needs = ctx.needs_input_grad[4:]
        weight_grads = any(needs[i] for i in range(len(needs)) if i % 3)
        dqkv, dws = qk_norm_rope_bwd((gq, gk, gv), sources, cos, sin,
                                     ctx.scale, weight_grads)
        out: List[Optional[torch.Tensor]] = [None] * 4
        for i, dy in enumerate(dqkv):
            dw = dws[i] if dws is not None else (None, None)
            out += [dy, dw[0], dw[1]]
        return tuple(g if need else None
                     for g, need in zip(out, ctx.needs_input_grad))


def qk_norm_rope_autograd(sources: Sequence[Source], cos, sin, scale: float,
                          n_pad: int):
    """Differentiable `qk_norm_rope` -> q, k, v (B*H, n_pad, D)."""
    flat = [t for src in sources for t in src]
    return _QKNormRope.apply(cos, sin, scale, n_pad, *flat)
