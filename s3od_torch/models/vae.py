"""Convolutional image autoencoder (FLUX AutoencoderKL, 16 latent channels)
in PyTorch (counterpart of `s3od_tpu/models/vae.py`).

Resnet blocks with GroupNorm + SiLU, a mid block with single-head
self-attention, 4 down/up stages (8x spatial). The public functions keep
the JAX package's NHWC layout; the modules run NCHW, every conv through
`ops/conv.conv2d` (cuDNN, or K9a under `S3OD_WINOGRAD=1`). Parameters
mirror the JAX `{enc, dec}` trees path for path (`down.0.resnets.0.conv1.
weight` <-> `down/0/resnets/0/conv1/kernel`, HWIO -> OIHW).

Dtypes follow the JAX functions exactly: a conv casts its weights to the
input's dtype; the mid attention multiplies by the float32 weights
WITHOUT a cast, so in a bf16 run it promotes to float32 and everything
after it (the decoder's up stages, the encoder's output) runs in float32,
as `jnp.matmul(bf16, f32)` promotes in the JAX package. The mid attention
(16384 tokens at 1024^2, c = 512, one head) is plain chunked torch: XLA
runs it in JAX, not a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from s3od_torch.ops.conv import conv2d
from s3od_torch.ops.flash_attention import query_chunk, row_chunks
from s3od_torch.ops.precision import default_dtype
from s3od_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 16
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)
    layers_per_block: int = 2
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    groups: int = 32


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(latent_channels=4, base_channels=16,
                     channel_mults=(1, 2), layers_per_block=1, groups=4)


def _conv(mod: nn.Conv2d, x, stride: int = 1, padding: int = 0):
    """Through `ops/conv.conv2d`, as the JAX VAE calls its `conv2d`: with
    `S3OD_WINOGRAD=1` an eligible bf16 3x3 conv runs K9a."""
    return conv2d(x, mod.weight, mod.bias, stride, padding)


def _group_norm(x, gn: nn.GroupNorm, groups: int, eps: float = 1e-6):
    y = F.group_norm(x.float(), groups, gn.weight.float(), gn.bias.float(), eps)
    return y.to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.norm1 = nn.GroupNorm(1, cin, **kw)
        self.conv1 = nn.Conv2d(cin, cout, 3, **kw)
        self.norm2 = nn.GroupNorm(1, cout, **kw)
        self.conv2 = nn.Conv2d(cout, cout, 3, **kw)
        if cin != cout:
            self.shortcut = nn.Conv2d(cin, cout, 1, **kw)

    def forward(self, x, groups: int):
        h = _conv(self.conv1, F.silu(_group_norm(x, self.norm1, groups)), padding=1)
        h = _conv(self.conv2, F.silu(_group_norm(h, self.norm2, groups)), padding=1)
        if hasattr(self, "shortcut"):
            x = _conv(self.shortcut, x)
        return x + h


class MidAttention(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.norm = nn.GroupNorm(1, c, **kw)
        self.q = nn.Linear(c, c, **kw)
        self.k = nn.Linear(c, c, **kw)
        self.v = nn.Linear(c, c, **kw)
        self.proj = nn.Linear(c, c, **kw)

    def forward(self, x, groups: int):
        b, c, hh, ww = x.shape
        flat = _group_norm(x, self.norm, groups).flatten(2).transpose(1, 2)
        dt = torch.promote_types(flat.dtype, self.q.weight.dtype)
        flat = flat.to(dt)
        lin = lambda m, t: F.linear(t, m.weight.to(dt), m.bias.to(dt))
        q, k, v = lin(self.q, flat), lin(self.k, flat), lin(self.v, flat)
        kt = k.transpose(1, 2)
        rows = []
        for i, j in row_chunks(q.shape[1], query_chunk(b, k.shape[1])):
            logits = torch.matmul(q[:, i: j], kt) * (c**-0.5)
            attn = torch.softmax(logits.float(), -1).to(v.dtype)
            del logits
            rows.append(torch.matmul(attn, v))
        out = lin(self.proj, torch.cat(rows, 1))
        return x + out.transpose(1, 2).reshape(b, c, hh, ww)


class Mid(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.res1 = ResnetBlock(c, c, **kw)
        self.attn = MidAttention(c, **kw)
        self.res2 = ResnetBlock(c, c, **kw)

    def forward(self, x, groups: int):
        return self.res2(self.attn(self.res1(x, groups), groups), groups)


class Stage(nn.Module):
    def __init__(self, cins, cout: int, resample: Optional[str], **kw):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(ci, cout, **kw) for ci in cins)
        if resample is not None:
            setattr(self, resample, nn.Conv2d(cout, cout, 3, **kw))


def _chans(cfg: VAEConfig):
    return [cfg.base_channels * m for m in cfg.channel_mults]


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        self.cfg = cfg
        chans, n = _chans(cfg), cfg.layers_per_block
        self.conv_in = nn.Conv2d(3, cfg.base_channels, 3, **kw)
        stages, c_prev = [], cfg.base_channels
        for i, c in enumerate(chans):
            stages.append(Stage([c_prev] + [c] * (n - 1), c,
                                "downsample" if i < len(chans) - 1 else None,
                                **kw))
            c_prev = c
        self.down = nn.ModuleList(stages)
        self.mid = Mid(chans[-1], **kw)
        self.norm_out = nn.GroupNorm(1, chans[-1], **kw)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, **kw)

    def forward(self, images):
        """images (B, H, W, 3) in [-1, 1] -> latent mean (B, H/8, W/8, C),
        scaled and shifted for the diffusion model."""
        cfg, g = self.cfg, self.cfg.groups
        x = _conv(self.conv_in, images.permute(0, 3, 1, 2), padding=1)
        for stage in self.down:
            for r in stage.resnets:
                x = r(x, g)
            if hasattr(stage, "downsample"):
                x = _conv(stage.downsample, F.pad(x, (0, 1, 0, 1)), stride=2)
        x = self.mid(x, g)
        x = _conv(self.conv_out, F.silu(_group_norm(x, self.norm_out, g)),
                  padding=1)
        mean = x[:, : cfg.latent_channels]  # drop the logvar half
        return ((mean - cfg.shift_factor) * cfg.scaling_factor).permute(0, 2, 3, 1)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, **kw):
        super().__init__()
        self.cfg = cfg
        chans, n = _chans(cfg), cfg.layers_per_block
        self.conv_in = nn.Conv2d(cfg.latent_channels, chans[-1], 3, **kw)
        self.mid = Mid(chans[-1], **kw)
        stages, c_prev = [], chans[-1]
        for i, c in enumerate(reversed(chans)):
            stages.append(Stage([c_prev] + [c] * n, c,
                                "upsample" if i < len(chans) - 1 else None,
                                **kw))
            c_prev = c
        self.up = nn.ModuleList(stages)
        self.norm_out = nn.GroupNorm(1, chans[0], **kw)
        self.conv_out = nn.Conv2d(chans[0], 3, 3, **kw)

    def forward(self, latents):
        """latents (B, h, w, C), scaled -> images (B, 8h, 8w, 3) in ~[-1, 1]."""
        cfg, g = self.cfg, self.cfg.groups
        z = latents.permute(0, 3, 1, 2) / cfg.scaling_factor + cfg.shift_factor
        x = self.mid(_conv(self.conv_in, z, padding=1), g)
        for stage in self.up:
            for r in stage.resnets:
                x = r(x, g)
            if hasattr(stage, "upsample"):
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = _conv(stage.upsample, x, padding=1)
        x = _conv(self.conv_out, F.silu(_group_norm(x, self.norm_out, g)),
                  padding=1)
        return x.permute(0, 2, 3, 1)


class VAE:
    """The pipeline's VAE: uint8 images <-> latents on the device (default
    "cuda"). The modules keep their float32 weights; the input runs in
    `dtype`, by default bf16 on the card (the JAX wrapper's) and float32
    on the CPU."""

    def __init__(self, enc: VAEEncoder, dec: VAEDecoder, cfg: VAEConfig,
                 dtype: Optional[torch.dtype] = None, device=None):
        self.device = resolve_device(device)
        dtype = dtype or default_dtype(self.device)
        self.enc = enc.to(self.device).eval()
        self.dec = dec.to(self.device).eval()
        self.cfg, self.dtype = cfg, dtype

    @torch.inference_mode()
    def encode(self, images_u8) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images_u8), device=self.device)
        x = x.float() / 127.5 - 1.0
        if x.ndim == 3:
            x = x[None]
        return self.enc(x.to(self.dtype)).float().cpu().numpy()

    @torch.inference_mode()
    def decode(self, latents) -> np.ndarray:
        """latents (B, h, w, C), numpy or a tensor -> uint8 (8h, 8w, 3), or
        (B, 8h, 8w, 3) for B > 1."""
        if not isinstance(latents, torch.Tensor):
            latents = torch.from_numpy(np.array(latents, np.float32))
        img = self.dec(latents.to(self.device, self.dtype)).float()
        img = ((img + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).cpu().numpy()
        return img[0] if img.shape[0] == 1 else img


@torch.no_grad()
def init_vae(cfg: VAEConfig, generator: torch.Generator, device=None):
    """Seeded random weights in the JAX `init_vae_params` scheme: convs
    N(0, 1/(cin k^2)), attention linears N(0, 1/c), biases zero, GroupNorms
    (1, 0). -> (encoder, decoder) in float32."""
    mods = []
    for cls in (VAEEncoder, VAEDecoder):
        m = cls(cfg, device="meta").to_empty(device=device or generator.device)
        for mod in m.modules():
            if isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, fan_in**-0.5, generator=generator)
                mod.bias.zero_()
        mods.append(m.eval())
    return tuple(mods)


def load_vae(path: str, cfg: Optional[VAEConfig] = None, **kw) -> VAE:
    """A VAE from a converted `.npz` ({'enc', 'dec'} trees in params, the
    JAX package's `convert_flux.py` format). The configuration defaults to
    the one stored beside the weights, else the FLUX VAE."""
    from s3od_torch.convert import load_vae_modules

    enc, dec, cfg = load_vae_modules(path, cfg)
    return VAE(enc, dec, cfg, **kw)
