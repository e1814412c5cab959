"""Attention dispatch (counterpart of `s3od_tpu/ops/attention.py`).

`attention` is the exact full-softmax attention of the float32 route
(`_xla_attention`): plain tensor code, no kernel, as the JAX package
leaves it to XLA. `multi_head_attention` keeps the JAX package's rule for
when the flash kernels run (bf16 and at least 1024 tokens): K7, the
online-softmax kernel, or K3/K6 when the caller asks for the static
softmax bound, each with K8 as its backward. `flash_attention_heads` is
K7's route for callers that hand over q, k, v already scaled, head-major
and padded (the MMDiT's `ops/qk_norm_rope`). On CPU tensors the kernel
wrappers take their plain versions; on CUDA tensors they launch or raise.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from s3od_torch.ops.flash_attention import (
    flash_attention_autograd,
    flash_attention_online_autograd,
    flash_seq_len,
    query_chunk,
    row_chunks,
)

IMPLS = ("auto", "xla", "flash")


def attention(q, k, v, scale: float, n_valid: int = 0, chunk: int = 0):
    """q, k, v (B, N, H, D) -> (B, N, H, D). Logits and softmax in fp32;
    keys at or past n_valid (when nonzero) are masked with -1e30; the
    probabilities are rounded to v's dtype before the product. Runs one
    batch element and one chunk of at most `chunk` query rows (default
    `query_chunk`) at a time, which bounds the (H, rows, N) logit memory at
    2048^2 and changes no number: query rows are independent."""
    out = []
    h, n = q.shape[2], k.shape[1]
    chunk = chunk or query_chunk(h, n)
    for i in range(q.shape[0]):
        ki, vi = k[i].float(), v[i]
        rows = []
        for j0, j1 in row_chunks(q.shape[1], chunk):
            logits = torch.einsum("nhd,mhd->hnm", q[i, j0: j1].float(), ki)
            logits = logits * scale
            if n_valid and n_valid < n:
                logits[..., n_valid:] = -1e30
            probs = torch.softmax(logits, dim=-1).to(v.dtype)
            del logits
            rows.append(torch.einsum("hnm,mhd->nhd", probs, vi))
        out.append(torch.cat(rows))
    return torch.stack(out)


def scale_in_dtype(scale: float, dtype: torch.dtype) -> float:
    """The softmax scale rounded once to `dtype`, on the host. `q * it`
    equals `q * torch.tensor(scale, dtype=dtype)` bit for bit (both
    multiply in fp32 and round once) without a host-to-device copy on
    every attention call."""
    return float(torch.tensor(scale, dtype=dtype))


def resolve_attn_impl(n: int, dtype: torch.dtype, impl: str = "auto") -> str:
    """"auto" -> "flash" for bf16 and N >= 1024 (`ops/attention.py:52-59`:
    the flash kernels' products are bf16-precision, so float32 keeps the
    exact route), else "xla"."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl != "auto":
        return impl
    return "flash" if n >= 1024 and dtype == torch.bfloat16 else "xla"


def multi_head_attention(q, k, v, *, scale: Optional[float] = None,
                         impl: str = "auto", n_valid: int = 0,
                         static_softmax_bound: bool = False):
    """Multi-head attention over (B, N, H, D) tensors -> (B, N, H, D).

    "flash": q is scaled IN ITS DTYPE (as `flash_attention.py:743` folds
    the scale into bf16 q; `scale_in_dtype`), the heads go to (B*H, N,
    D), the sequence is padded to a multiple of 64 with `n_valid`
    masking the padded keys, K7
    (or K3/K6 under `static_softmax_bound`) runs, and the padded query
    rows are sliced off. Differentiable: K8 is the backward of either
    forward, and autograd through the scaling gives dq its factor, as the
    JAX package's `q * scale` chain does. "xla": the exact attention
    above. `n_valid`: the true token count when the sequence carries
    trailing padding rows (0: all N)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if resolve_attn_impl(q.shape[1], q.dtype, impl) == "xla":
        return attention(q, k, v, scale, n_valid)
    b, n, h, d = q.shape
    q = q * scale_in_dtype(scale, q.dtype)
    n_pad = flash_seq_len(n)
    kernel = (flash_attention_autograd if static_softmax_bound
              else flash_attention_online_autograd)
    o = kernel(to_bhnd(q, n_pad), to_bhnd(k, n_pad), to_bhnd(v, n_pad),
               n_valid or n)
    return o[:, :n].reshape(b, h, n, d).transpose(1, 2)


def to_bhnd(t, n_pad: int):
    """(B, N, H, D) -> (B*H, n_pad, D), the padded rows zero: the flash
    kernels' input form."""
    b, n, h, d = t.shape
    t = t.transpose(1, 2).reshape(b * h, n, d)
    return F.pad(t, (0, 0, 0, n_pad - n)) if n_pad != n else t


def flash_attention_heads(q, k, v, batch: int, n: int):
    """K7 (K8 its backward) over q, k, v already in the flash route's
    form, (B*H, n_pad, D) with q scaled and the rows past `n` zero (as
    `ops/qk_norm_rope.qk_norm_rope` writes them) -> (B, N, H, D), what
    `multi_head_attention` returns on its flash route: the padded keys
    masked by `n_valid` = n, the padded query rows sliced off."""
    bh, n_pad, d = q.shape
    if n_pad != flash_seq_len(n):
        raise ValueError(f"flash_attention_heads: {n} tokens padded to "
                         f"{n_pad}, not {flash_seq_len(n)}")
    o = flash_attention_online_autograd(q, k, v, n)
    return o[:, :n].reshape(batch, bh // batch, n, d).transpose(1, 2)
