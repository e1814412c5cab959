"""Exact full-softmax attention of the float32 route (counterpart of
`s3od_tpu/ops/attention.py:_xla_attention`). Plain tensor code, no kernel:
the JAX package leaves it to XLA too."""

from __future__ import annotations

import torch


def attention(q, k, v, scale: float, n_valid: int = 0):
    """q, k, v (B, N, H, D) -> (B, N, H, D). Logits and softmax in fp32;
    keys at or past n_valid (when nonzero) are masked with -1e30. Runs one
    batch element at a time to bound the (H, N, N) logit memory."""
    out = []
    n = k.shape[1]
    for i in range(q.shape[0]):
        logits = torch.einsum("nhd,mhd->hnm", q[i].float(), k[i].float())
        logits = logits * scale
        if n_valid and n_valid < n:
            logits[..., n_valid:] = -1e30
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out.append(torch.einsum("hnm,mhd->nhd", probs, v[i]))
    return torch.stack(out)
