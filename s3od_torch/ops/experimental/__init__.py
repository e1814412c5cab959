"""The decoder's gated kernels (counterpart of `s3od_tpu/ops/experimental/`).

- `winograd`: K9a, the Winograd F(2x2, 3x3) conv, and K9b, the chained
  BN-folded ResidualConvUnit; routed by `ops/conv.py` and `models/dpt.py`
  when `S3OD_WINOGRAD=1`.
- `mask_tail`: K10, the fused mask-head tail; routed by `models/dpt.py`
  when `MASK_TAIL_FUSED` is set.

Both gates are off by default, as in the JAX package. The JAX package
turned them off on TPU v5e measurements; the H100 times of these kernels
are in `PERF.md`.
"""
