"""K3: attention forward under the static softmax bound (CUDA) and its plain
version.

Replaces the TPU kernel `s3od_tpu/ops/flash_attention.py:_fwd_kernel_single`
(via `_flash_forward(static_bound=True)`). The kernel source and its design
note are in `s3od_torch/csrc/flash_attention.cu`.

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


def flash_attention_plain(q, k, v, n_valid: int):
    """Plain version of K3. q, k, v (BH, N, D) -> (o (BH, N, D) in q's
    dtype, lse (BH, N) fp32). Keys at or past n_valid are masked."""
    n = k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2))
    if n_valid < n:
        bias = torch.zeros(n, device=s.device, dtype=torch.float32)
        bias[n_valid:] = NEG_INF
        s = s + bias
    p = torch.exp(s.clamp(SOFTMAX_BOUND_LO, SOFTMAX_BOUND_HI)
                  - SOFTMAX_BOUND_HI)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), SOFTMAX_BOUND_HI + torch.log(l[..., 0])


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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((bh, n), device=q.device, dtype=torch.float32)
    lib = _build.load_library()
    code = lib.s3od_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, n, d, n_valid, _build.stream_ptr(q),
    )
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
