"""Exact full-softmax attention of the float32 route (counterpart of
`s3od_tpu/ops/attention.py:_xla_attention`). Plain tensor code, no kernel:
the JAX package leaves it to XLA too."""

from __future__ import annotations

import torch

from s3od_torch.ops.flash_attention import query_chunk, row_chunks


def attention(q, k, v, scale: float, n_valid: int = 0, chunk: int = 0):
    """q, k, v (B, N, H, D) -> (B, N, H, D). Logits and softmax in fp32;
    keys at or past n_valid (when nonzero) are masked with -1e30. Runs one
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
