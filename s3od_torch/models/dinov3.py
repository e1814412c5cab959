"""DINOv3 ViT encoder in PyTorch (counterpart of `s3od_tpu/models/dinov3.py`).

Parameter names follow the reference checkpoint (`encoder.*` keys of
`s3od_tpu.convert.export_torch_state_dict`), so a reference `.pt` state
dict loads with `strict=True`. Only blocks 0..max(taps)-1 run; the final
block and final LayerNorm exist for the checkpoint layout only.

A block runs one of two routes:
- "kernel" (bf16): K1 LayerNorm -> K2 QKV + RoPE -> K3/K6 static-bound
  attention -> K4 o_proj + residual + norm2 -> K5 fused MLP + residual,
  the JAX block's fused route (`dinov3.py:244-267`); the sequence is
  padded once to `flash_seq_len` (a multiple of 64). On CPU tensors every
  kernel wrapper takes its plain version, so this route also runs there.
- "exact" (float32): LayerNorm -> fused qkv matmul -> RoPE -> exact
  softmax attention -> o_proj -> residual -> LayerNorm -> MLP, unpadded —
  the JAX package's exact mode (`dinov3.py:174-204, 268-273`).

Training runs the same routes under autograd: every kernel is wrapped in
a `torch.autograd.Function` (K3/K6 with the K8 backward kernel, K2, K4
and K5 with their vjps written out in bf16 products, K1 with the vjp of
its plain version; `ops/autograd.py`), parameters are cast to
the compute dtype at use by a differentiable `.to()` (fp32 master weights,
as JAX's `.astype(x.dtype)`), each block is checkpointed
(`torch.utils.checkpoint`, the JAX `remat`, with its policies in
`ops/remat.py`), and the RoPE coordinates may be rescaled per step
(`sample_rope_coord_scale`, `pos_embed_rescale`).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

from s3od_torch.configs import EncoderConfig
from s3od_torch.ops.attention import attention
from s3od_torch.ops.attn_epilogue import attn_epilogue_autograd
from s3od_torch.ops.flash_attention import flash_attention_autograd, flash_seq_len
from s3od_torch.ops.layernorm import layer_norm_autograd, layer_norm_exact
from s3od_torch.ops.mlp_fused import mlp_fused_autograd
from s3od_torch.ops.qkv_project import qkv_project_rope_autograd, rotate_half
from s3od_torch.ops.remat import context_fn as remat_context
from s3od_torch.profiling import span

ROUTES = ("kernel", "exact")


def rope_cos_sin(nh: int, nw: int, head_dim: int, theta: float,
                 coord_scale: Optional[torch.Tensor] = None):
    """fp32 (nh*nw, head_dim) RoPE tables over patch centres in [-1, 1],
    in the same fp32 operation order as `s3od_tpu` `rope_cos_sin`.
    `coord_scale` (an fp32 scalar, a 0-dim tensor or its float) rescales
    the coordinates: the training augmentation `pos_embed_rescale`."""
    dim4 = head_dim // 4
    inv_freq = 1.0 / theta ** np.arange(0, 1, 1.0 / dim4, dtype=np.float64)
    coords_h = (np.arange(0.5, nh, dtype=np.float64) / nh) * 2 - 1
    coords_w = (np.arange(0.5, nw, dtype=np.float64) / nw) * 2 - 1
    hh, ww = np.meshgrid(coords_h, coords_w, indexing="ij")
    coords = np.stack([hh.reshape(-1), ww.reshape(-1)], axis=-1)
    coords = torch.tensor(coords, dtype=torch.float32)
    if coord_scale is not None:
        coords = coords * coord_scale
    inv = torch.tensor(inv_freq, dtype=torch.float32)
    angles = 2.0 * math.pi * coords[:, :, None] * inv[None, None, :]
    angles = angles.reshape(angles.shape[0], -1).repeat(1, 2)
    return torch.cos(angles), torch.sin(angles)


def sample_rope_coord_scale(generator: torch.Generator,
                            rescale: float) -> torch.Tensor:
    """Log-uniform coordinate rescale in [1/rescale, rescale], an fp32
    scalar (training augmentation; `s3od_tpu` `sample_rope_coord_scale`
    draws it from a JAX key, this from `generator`)."""
    log_r = math.log(rescale)
    u = torch.empty((), dtype=torch.float32).uniform_(-log_r, log_r,
                                                      generator=generator)
    return torch.exp(u)


@functools.lru_cache(maxsize=16)
def _full_tables(nh, nw, head_dim, theta, n_prefix, n_run, device):
    """Tables over the whole (padded) sequence: identity rows (cos 1,
    sin 0) for the CLS/register prefix and the padding tail. Cached:
    unscaled tables only (see `rope_tables`). Built outside inference
    mode, so that a table first made by a serving call can still be saved
    for backward by a training forward."""
    with torch.inference_mode(False):
        return _tables(nh, nw, head_dim, theta, n_prefix, n_run, device)


def rope_tables(nh, nw, head_dim, theta, n_prefix, n_run, device,
                coord_scale: Optional[torch.Tensor] = None):
    """`_full_tables`, or tables built anew for a rescaled step. While
    `torch.export` traces, the tables are built in the graph and not
    cached: the cache would hand the trace's fake tensors to the next
    eager call. Tables built anew (on the host, then uploaded) are the
    span `s3od.encoder.rope_tables`."""
    if coord_scale is None and not torch.compiler.is_exporting():
        return _full_tables(nh, nw, head_dim, theta, n_prefix, n_run, device)
    with span("s3od.encoder.rope_tables"):
        return _tables(nh, nw, head_dim, theta, n_prefix, n_run, device,
                       coord_scale)


def _tables(nh, nw, head_dim, theta, n_prefix, n_run, device,
            coord_scale=None):
    cos, sin = rope_cos_sin(nh, nw, head_dim, theta, coord_scale)
    tail = n_run - n_prefix - cos.shape[0]
    ones = lambda k: torch.ones(k, head_dim)
    zeros = lambda k: torch.zeros(k, head_dim)
    cos = torch.cat([ones(n_prefix), cos, ones(tail)])
    sin = torch.cat([zeros(n_prefix), sin, zeros(tail)])
    return cos.to(device), sin.to(device)


def encoder_tables(cfg: EncoderConfig, height: int, width: int, route: str,
                   device):
    """The RoPE tables the encoder builds for (height, width) images on
    `route`: the `rope_tables` argument of its forward. The serving graphs
    take them as inputs, made once by this call outside the trace."""
    p = cfg.patch_size
    nh, nw = height // p, width // p
    n_run = attn_seq_len(cfg.num_prefix_tokens + nh * nw, route)
    return rope_tables(nh, nw, cfg.head_dim, cfg.rope_theta,
                       cfg.num_prefix_tokens, n_run, device)


def attn_seq_len(n: int, route: str) -> int:
    """Length the encoder pads `n` tokens to: the kernel tile multiple on
    the kernel route, `n` on the exact route."""
    return flash_seq_len(n) if route == "kernel" else n


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        c = cfg.hidden_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, c))  # unused here
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, c))
        self.patch_embeddings = nn.Conv2d(
            3, c, cfg.patch_size, stride=cfg.patch_size)


class LayerScale(nn.Module):
    def __init__(self, c: int, value: float):
        super().__init__()
        self.lambda1 = nn.Parameter(torch.full((c,), float(value)))


class Attention(nn.Module):
    """q, k and v are stored fused, as in the JAX params and as the kernels
    read them: one nn.Linear `qkv` with a (3C, C) weight and a (3C,) bias.
    The state dict keeps the reference names (q_proj / k_proj / v_proj):
    the hooks below split the fused tensors on save and fuse them on load.
    Absent biases are zero segments. DINOv3 has no key bias at all: RoPE
    rotates keys after the projection, so a key bias would not be
    softmax-invariant."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        c = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.has_bias = {"q_proj": cfg.query_bias, "k_proj": False,
                         "v_proj": cfg.value_bias}
        self.qkv = nn.Linear(c, 3 * c)
        with torch.no_grad():
            for i, has in enumerate(self.has_bias.values()):
                if not has:
                    self.qkv.bias[i * c: (i + 1) * c].zero_()
        self.o_proj = nn.Linear(c, c, bias=cfg.proj_bias)
        self.register_state_dict_post_hook(_split_qkv)
        self.register_load_state_dict_pre_hook(_fuse_qkv)


def _split_qkv(module, state_dict, prefix, local_metadata):
    w = state_dict.pop(prefix + "qkv.weight")
    b = state_dict.pop(prefix + "qkv.bias")
    for name, wi, bi in zip(module.has_bias, w.chunk(3), b.chunk(3)):
        state_dict[f"{prefix}{name}.weight"] = wi
        if module.has_bias[name]:
            state_dict[f"{prefix}{name}.bias"] = bi


def _fuse_qkv(module, state_dict, prefix, *args):
    if prefix + "q_proj.weight" not in state_dict:
        return  # missing keys are reported by the strict load
    ws, bs = [], []
    for name, has in module.has_bias.items():
        w = state_dict.pop(f"{prefix}{name}.weight")
        ws.append(w)
        bs.append(state_dict.pop(f"{prefix}{name}.bias") if has
                  else w.new_zeros(w.shape[0]))
    state_dict[prefix + "qkv.weight"] = torch.cat(ws)
    state_dict[prefix + "qkv.bias"] = torch.cat(bs)


class MLP(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        if cfg.use_gated_mlp:
            raise NotImplementedError("gated MLP is not in any served config")
        self.up_proj = nn.Linear(cfg.hidden_size, cfg.intermediate_size,
                                 bias=cfg.mlp_bias)
        self.down_proj = nn.Linear(cfg.intermediate_size, cfg.hidden_size,
                                   bias=cfg.mlp_bias)

    def forward(self, x):
        return self.down_proj(F.gelu(self.up_proj(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        c = cfg.hidden_size
        self.eps = cfg.layer_norm_eps
        self.norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.attention = Attention(cfg)
        self.layer_scale1 = LayerScale(c, cfg.layerscale_value)
        self.norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = MLP(cfg)
        self.layer_scale2 = LayerScale(c, cfg.layerscale_value)

    def forward(self, x, cos, sin, n_valid: int, route: str):
        if route == "kernel":
            x, h = self._attention_kernels(x, cos, sin, n_valid)
            up, down = self.mlp.up_proj, self.mlp.down_proj
            dt = x.dtype
            return mlp_fused_autograd(
                h, up.weight.to(dt), _bias(up, dt), down.weight.to(dt),
                _bias(down, dt), x, self.layer_scale2.lambda1.to(dt))
        x, h = self._attention_exact(x, cos, sin, n_valid)
        return x + self.mlp(h) * self.layer_scale2.lambda1

    def _attention_kernels(self, x, cos, sin, n_valid):
        b, n, c = x.shape
        dt = x.dtype
        att = self.attention
        heads = att.num_heads
        d = c // heads
        h = layer_norm_autograd(x, self.norm1.weight.to(dt),
                                self.norm1.bias.to(dt), self.eps)
        q, k, v = qkv_project_rope_autograd(
            h, att.qkv.weight.to(dt), att.qkv.bias.to(dt), cos, sin, heads,
            d**-0.5)
        o = flash_attention_autograd(q.reshape(b * heads, n, d),
                                     k.reshape(b * heads, n, d),
                                     v.reshape(b * heads, n, d), n_valid)
        return attn_epilogue_autograd(
            o, att.o_proj.weight.to(dt), _bias(att.o_proj, dt), x,
            self.layer_scale1.lambda1.to(dt), self.norm2.weight.to(dt),
            self.norm2.bias.to(dt), self.eps)

    def _attention_exact(self, x, cos, sin, n_valid):
        b, n, c = x.shape
        att = self.attention
        heads = att.num_heads
        d = c // heads
        h = layer_norm_exact(x, self.norm1.weight, self.norm1.bias, self.eps)
        q, k, v = att.qkv(h).view(b, n, 3, heads, d).unbind(2)
        cos_ = cos.to(x.dtype)[None, :, None, :]
        sin_ = sin.to(x.dtype)[None, :, None, :]
        q = q * cos_ + rotate_half(q) * sin_
        k = k * cos_ + rotate_half(k) * sin_
        o = attention(q, k, v, d**-0.5, n_valid).reshape(b, n, c)
        x = x + att.o_proj(o) * self.layer_scale1.lambda1
        return x, layer_norm_exact(x, self.norm2.weight, self.norm2.bias,
                                   self.eps)


def _bias(linear: nn.Linear, dtype: torch.dtype):
    """A Linear's bias in `dtype`, or zeros of its output width when it
    has none."""
    if linear.bias is not None:
        return linear.bias.to(dtype)
    return linear.weight.new_zeros(linear.out_features, dtype=dtype)


class DINOv3Encoder(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layer = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        # Final LayerNorm: dead for the DPT taps, kept for the checkpoint.
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, images, tap_layers: Sequence[int], route: str, *,
                rope_coord_scale: Optional[torch.Tensor] = None,
                remat: bool = False,
                remat_policy: Optional[str] = None,
                tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                ) -> List[torch.Tensor]:
        """images (B, H, W, 3) normalized, in the compute dtype -> one
        (B, h*w, C) patch-token tensor per tap (prefix tokens stripped).
        Tap t is the output of block t - 1.

        `remat=True` checkpoints each block while gradients are recorded:
        the backward recomputes the block. `remat_policy` chooses what the
        block keeps for it (`s3od_torch.ops.remat`): None / "none"
        nothing, "flash" K3's out and lse (the recompute skips K3),
        "dots_flash" also every matrix product's output on the exact
        route; an unknown name raises `ValueError`. `tables`: the RoPE
        (cos, sin) of `encoder_tables` for these images, given instead of
        built (the serving graphs take them as inputs)."""
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES}, got {route!r}")
        cfg = self.cfg
        b, hh, ww, _ = images.shape
        p = cfg.patch_size
        nh, nw = hh // p, ww // p
        x = images[:, : nh * p, : nw * p].permute(0, 3, 1, 2)
        emb = self.embeddings
        pe = emb.patch_embeddings
        x = F.conv2d(x, pe.weight.to(x.dtype), pe.bias.to(x.dtype),
                     stride=pe.stride)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat([emb.cls_token.to(x.dtype).expand(b, -1, -1),
                       emb.register_tokens.to(x.dtype).expand(b, -1, -1), x],
                      dim=1)
        n_prefix = cfg.num_prefix_tokens
        n_valid = x.shape[1]
        n_run = attn_seq_len(n_valid, route)
        if n_run != n_valid:
            x = F.pad(x, (0, 0, 0, n_run - n_valid))
        if tables is not None:
            cos, sin = tables
        else:
            cos, sin = rope_tables(nh, nw, cfg.head_dim, cfg.rope_theta,
                                   n_prefix, n_run, x.device, rope_coord_scale)
        keep = remat_context(remat_policy, route) if remat else None
        remat = remat and torch.is_grad_enabled()
        taps = {}
        for i in range(max(tap_layers)):
            if remat:
                x = checkpoint(self.layer[i], x, cos, sin, n_valid, route,
                               use_reentrant=False,
                               context_fn=keep or noop_context_fn)
            else:
                x = self.layer[i](x, cos, sin, n_valid, route)
            if i + 1 in tap_layers:
                taps[i + 1] = x
        return [taps[t][:, n_prefix: n_prefix + nh * nw] for t in tap_layers]
