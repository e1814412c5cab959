"""The attention forward that E1, E3a and E4 share: its softmax variants,
its CUDA launch (`s3od_torch/csrc/exp_flash_variants.cu`, design note
there: the warp-specialised TMA + wgmma body of K3/K6/K7 at D = 64) and
its plain version.

A `Softmax` names what the three experiments vary: the row max against a
static bound, base e against base 2, exp2 on bf16 operands, the multiplier
applied to q k^T inside the kernel and the epsilon on the denominator. The
experiment modules turn their variants into one and count their own
launches; this module holds no wrapper of its own.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from s3od_torch import _build
from s3od_torch.ops.flash_attention import MAX_SMEM, NEG_INF, query_chunk, row_chunks

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)
HEAD_DIM = 64


@dataclasses.dataclass(frozen=True)
class Softmax:
    """p as a function of the logits s = (q k^T) * mult + bias.

    online: p = exp(s - m) with m the row max, kept running over key blocks
      with the rescale alpha = exp(m_prev - m_new); else the static bound:
      p = exp(clip(s, lo, hi) - hi) and m = hi (lo = -inf: min(s, hi) - hi).
    base2: exp2 in place of exp; lse = m ln 2 + ln l.
    bf16_arg: p = exp2(bf16(s - m)), itself bf16; l sums the bf16 p.
    l_eps: added to the denominator l before o = acc / l."""

    online: bool
    base2: bool = False
    bf16_arg: bool = False
    mult: float = 1.0
    lo: float = -math.inf
    hi: float = 0.0
    l_eps: float = 0.0

    @property
    def code(self) -> int:
        """The kernel's template switch: static | base2 << 1 | bf16 << 2."""
        return int(not self.online) | int(self.base2) << 1 | int(self.bf16_arg) << 2


# The template instances `csrc/exp_flash_variants.cu` holds.
KERNEL_CODES = (0, 1, 2, 3, 6)

# Its launch, mirrored for the CPU tests: blocks of 192 query rows (three
# consumer warpgroups of 64 beside a TMA producer), 128-key tiles in
# two-stage K and V rings.
BLOCK_Q, BLOCK_K, STAGES = 192, 128, 2


def kernel_instance(sm: Softmax) -> tuple:
    """The template arguments (ONLINE, BASE2, BF16_ARG) of the instance
    that computes `sm` (the C entry point's switch on `sm.code`)."""
    if sm.code not in KERNEL_CODES:
        raise ValueError(f"exp_flash kernel: no instance for {sm}")
    code = sm.code
    return (not code & 1, bool(code & 2), bool(code & 4))


def plan(bh: int, n: int) -> dict:
    """The launch at (bh, n, 64): the grid, the key tiles a block walks
    (to n: keys past n in the last one get p = 0) and the dynamic shared
    memory (1024 bytes of alignment slack, Q, the K and V rings, 9
    mbarriers)."""
    return {"grid": (-(-n // BLOCK_Q), bh), "key_tiles": -(-n // BLOCK_K),
            "smem": 1024 + (BLOCK_Q + 2 * STAGES * BLOCK_K) * HEAD_DIM * 2 + 9 * 8}


def attention_plain(q, k, v, bias, sm: Softmax, block_k: int = 0):
    """Plain version of the forward, in the TPU kernels' order of
    operations. q, k, v (BH, N, D), bias (N,) fp32 or None -> (o (BH, N, D)
    in q's dtype, lse (BH, N) fp32). Keys run in blocks of `block_k`
    (default all N) with the online update of E1's kernel: for the static
    bound the blocks simply add. p is rounded to v's dtype for P V while l
    sums the fp32 p (the bf16 p under bf16_arg). Query rows run in chunks
    of `query_chunk` rows."""
    bh, n, d = q.shape
    nk = k.shape[1]
    block_k = block_k or nk
    ex = torch.exp2 if sm.base2 else torch.exp
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for i, j in row_chunks(n, query_chunk(bh, block_k)):
        qi = q[:, i: j].float()
        m = torch.full((bh, j - i, 1), NEG_INF if sm.online else sm.hi,
                       device=q.device)
        l = torch.zeros((bh, j - i, 1), device=q.device)
        acc = torch.zeros((bh, j - i, d), device=q.device)
        for k0 in range(0, nk, block_k):
            s = torch.matmul(qi, kf[:, k0: k0 + block_k].transpose(1, 2)) * sm.mult
            if bias is not None:
                s = s + bias[k0: k0 + block_k]
            if sm.online:
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                arg = s - m_new
                alpha = ex(m - m_new)
            else:
                m_new, alpha = m, None
                arg = s.clamp(min=sm.lo, max=sm.hi) - sm.hi
            del s
            p = ex(arg.to(torch.bfloat16)) if sm.bf16_arg else ex(arg)
            del arg
            ps = p.float().sum(-1, keepdim=True)
            pv = torch.matmul(p.to(v.dtype).float(), vf[:, k0: k0 + block_k])
            del p
            if alpha is None:
                l, acc = l + ps, acc + pv
            else:
                l, acc = l * alpha + ps, acc * alpha + pv
            m = m_new
        l = l + sm.l_eps
        outs.append((acc / l).to(q.dtype))
        lses.append((m * (LN2 if sm.base2 else 1.0) + torch.log(l))[..., 0])
    return torch.cat(outs, 1), torch.cat(lses, 1)


def errors(got, ref) -> dict:
    """max|got - ref| and max|got - ref| / max|ref|, in fp32 (NaN where
    either holds a NaN)."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    return {"max_abs_err": err,
            "rel_vs_plain": err / max(float(ref.abs().max()), 1e-30)}


def check_inputs(name, q, k, v, bias=None):
    """Raise on CUDA inputs the kernel does not take: bf16 (BH, N, 64) q,
    k, v of one shape; bias fp32 (N,) or None."""
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"{name} kernel: bf16 q, k, v only")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name} kernel: q, k, v must share one (BH, N, D) shape")
    if q.shape[2] != HEAD_DIM:
        raise ValueError(f"{name} kernel: D = {HEAD_DIM} only, got {q.shape[2]}")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (q.shape[1],)):
        raise ValueError(f"{name} kernel: bias must be fp32 (N,)")


def launch(q, k, v, bias, sm: Softmax, *, want_lse: bool, extra_keys: int = 0):
    """One launch of the CUDA forward on checked CUDA inputs -> (o, lse or
    None). The caller counts the launch."""
    kernel_instance(sm)
    bh, n, _ = q.shape
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bias = None if bias is None else bias.contiguous()
    o = torch.empty_like(q)
    lse = (torch.empty((bh, n), device=q.device, dtype=torch.float32)
           if want_lse else None)
    lib = _build.load_library()
    code = lib.s3od_exp_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, n, sm.code, sm.mult,
        sm.lo, sm.hi, sm.l_eps, extra_keys, _build.stream_ptr(q))
    _build.check(code, "exp_flash")
    return o, lse
