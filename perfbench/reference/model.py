"""Plain float32 reference of the two benchmarked models: the S3OD
segmentation model (DINOv3 ViT encoder + DPT decoder with mask and IoU
heads) and the FluxDPT teacher (the same, with FLUX-feature fusion at
every pyramid level).

Written from the architecture, on a state dict in the published
checkpoint's layout (`encoder.*`, `seg_head.*`, `fusion.*` keys): plain
`torch` operations, float32, no kernel, cache or batching trick. It
imports nothing of the program under test. TF32 must be off while it runs
(`exact_float32()`).

`Numerics(fp8=True)` rounds both operands of every matrix product and
convolution to float8 e4m3 (one scale a tensor) before the product: the
benchmark's lower-precision control, the step below the bfloat16 that the
configurations state.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matmuls and cuDNN convolutions, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


FP8_MAX = 448.0  # largest finite float8 e4m3fn


@dataclass(frozen=True)
class Numerics:
    fp8: bool = False

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x as the products read it: itself, or rounded to float8 e4m3
        under one scale for the whole tensor."""
        if not self.fp8:
            return x
        amax = x.detach().abs().amax().clamp_min(1e-12)
        s = amax / FP8_MAX
        y = (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s
        # Straight-through: the backward sees the identity, as a training
        # step at that precision would.
        return x + (y - x).detach()


PLAIN = Numerics()


def linear(x, w, b, nm: Numerics):
    return F.linear(nm.q(x), nm.q(w), b)


def conv(x, w, b, nm: Numerics, stride: int = 1, padding: int = 0):
    return F.conv2d(nm.q(x), nm.q(w), b, stride, padding)


def conv_t(x, w, b, nm: Numerics, stride: int, padding: int = 0):
    return F.conv_transpose2d(nm.q(x), nm.q(w), b, stride, padding)


def rope_cos_sin(nh: int, nw: int, head_dim: int, theta: float,
                 scale: Optional[float], device):
    """(nh*nw, head_dim) RoPE tables: patch centres in [-1, 1] on both
    axes (times `scale`, the training rescale), a quarter of the head's
    dims a frequency axis each for rows and columns, theta^(-k/(D/4))
    frequencies, angles 2 pi coord freq; the halves repeat."""
    dim4 = head_dim // 4
    inv = theta ** -(torch.arange(dim4, dtype=torch.float64) / dim4)
    ch = (torch.arange(nh, dtype=torch.float64) + 0.5) / nh * 2 - 1
    cw = (torch.arange(nw, dtype=torch.float64) + 0.5) / nw * 2 - 1
    hh, ww = torch.meshgrid(ch, cw, indexing="ij")
    coords = torch.stack([hh.reshape(-1), ww.reshape(-1)], -1)
    if scale is not None:
        coords = coords * float(scale)
    ang = (2 * math.pi * coords[:, :, None] * inv).reshape(coords.shape[0], -1)
    ang = torch.cat([ang, ang], -1)
    return (ang.cos().float().to(device), ang.sin().float().to(device))


def _rotate(t):
    half = t.shape[-1] // 2
    return torch.cat([-t[..., half:], t[..., :half]], -1)


def attention(q, k, v, chunk_elems: int):
    """softmax(q k^T / sqrt(D)) v over (B, H, N, D), in query chunks of at
    most `chunk_elems` logits (rows are independent: no number changes)."""
    b, h, n, d = q.shape
    rows = max(1, chunk_elems // max(1, b * h * n))
    if rows >= n:
        return torch.softmax((q @ k.transpose(-1, -2)) * d ** -0.5, -1) @ v
    outs = []
    for i in range(0, n, rows):
        s = (q[:, :, i: i + rows] @ k.transpose(-1, -2)) * d ** -0.5
        outs.append(torch.softmax(s, -1) @ v)
    return torch.cat(outs, 2)


def encoder_block(x, sd, pre: str, cfg: dict, cos, sin, nm: Numerics,
                  chunk_elems: int):
    b, n, c = x.shape
    heads = cfg["num_attention_heads"]
    d = c // heads
    eps = cfg["layer_norm_eps"]
    g = lambda k: sd.get(pre + k)
    h = F.layer_norm(x, (c,), g("norm1.weight"), g("norm1.bias"), eps)
    att = "attention."
    q = linear(h, g(att + "q_proj.weight"), g(att + "q_proj.bias"), nm)
    k = linear(h, g(att + "k_proj.weight"), g(att + "k_proj.bias"), nm)
    v = linear(h, g(att + "v_proj.weight"), g(att + "v_proj.bias"), nm)
    q, k, v = (t.reshape(b, n, heads, d).transpose(1, 2) for t in (q, k, v))
    q = q * cos + _rotate(q) * sin
    k = k * cos + _rotate(k) * sin
    o = attention(nm.q(q), nm.q(k), nm.q(v), chunk_elems)
    o = o.transpose(1, 2).reshape(b, n, c)
    x = x + linear(o, g(att + "o_proj.weight"), g(att + "o_proj.bias"),
                   nm) * g("layer_scale1.lambda1")
    h = F.layer_norm(x, (c,), g("norm2.weight"), g("norm2.bias"), eps)
    up = linear(h, g("mlp.up_proj.weight"), g("mlp.up_proj.bias"), nm)
    down = linear(F.gelu(up), g("mlp.down_proj.weight"),
                  g("mlp.down_proj.bias"), nm)
    return x + down * g("layer_scale2.lambda1")


def encoder(images, sd, cfg: dict, nm: Numerics = PLAIN,
            rope_scale: Optional[float] = None, remat: bool = False,
            chunk_elems: int = 1 << 28) -> List[torch.Tensor]:
    """images (B, H, W, 3) normalized fp32 -> the tap outputs (B, h*w, C),
    prefix tokens dropped. Tap t is the output of block t - 1; blocks past
    the last tap do not run."""
    p = cfg["patch_size"]
    b, hh, ww, _ = images.shape
    nh, nw = hh // p, ww // p
    x = images[:, : nh * p, : nw * p].permute(0, 3, 1, 2)
    x = conv(x, sd["encoder.embeddings.patch_embeddings.weight"],
             sd["encoder.embeddings.patch_embeddings.bias"], nm, stride=p)
    x = x.flatten(2).transpose(1, 2)
    c = x.shape[-1]
    prefix = torch.cat([sd["encoder.embeddings.cls_token"],
                        sd["encoder.embeddings.register_tokens"]], 1)
    n_prefix = prefix.shape[1]
    x = torch.cat([prefix.expand(b, -1, -1), x], 1)
    d = c // cfg["num_attention_heads"]
    cos, sin = rope_cos_sin(nh, nw, d, cfg["rope_theta"], rope_scale,
                            images.device)
    one = torch.ones(n_prefix, d, device=images.device)
    cos = torch.cat([one, cos])
    sin = torch.cat([torch.zeros_like(one), sin])
    taps = cfg["tap_layers"]
    out = {}
    for i in range(max(taps)):
        pre = f"encoder.layer.{i}."
        if remat and torch.is_grad_enabled():
            x = checkpoint(encoder_block, x, sd, pre, cfg, cos, sin, nm,
                           chunk_elems, use_reentrant=False)
        else:
            x = encoder_block(x, sd, pre, cfg, cos, sin, nm, chunk_elems)
        if i + 1 in taps:
            out[i + 1] = x[:, n_prefix:]
    return [out[t] for t in taps]


def batch_norm(x, sd, pre: str, training: bool, eps: float = 1e-5):
    """BatchNorm2d: the batch's statistics (biased variance) in training,
    the running ones otherwise."""
    if training:
        mean = x.mean((0, 2, 3))
        var = x.var((0, 2, 3), unbiased=False)
    else:
        mean, var = sd[pre + "running_mean"], sd[pre + "running_var"]
    scale = sd[pre + "weight"] / torch.sqrt(var + eps)
    return (x - mean[:, None, None]) * scale[:, None, None] + sd[pre + "bias"][:, None, None]


def rcu(x, sd, pre, cfg, training, nm):
    use_bn = cfg["use_bn"]
    out = conv(F.relu(x), sd[pre + "conv1.weight"], sd[pre + "conv1.bias"], nm,
               padding=1)
    if use_bn:
        out = batch_norm(out, sd, pre + "bn1.", training)
    out = conv(F.relu(out), sd[pre + "conv2.weight"], sd[pre + "conv2.bias"],
               nm, padding=1)
    if use_bn:
        out = batch_norm(out, sd, pre + "bn2.", training)
    return out + x


def up(x, hw):
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def down_aa(x, hw):
    """Bilinear resize with the antialiasing triangle filter on downscales."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False, antialias=True)


def neck(taps, sd, cfg, nm: Numerics):
    """Project and resize each tap to strides 4, 8, 16, 32 of the patch
    grid's pixels, then the 3x3 scratch convs."""
    ph, pw = cfg["_grid"]
    out = []
    for i, t in enumerate(taps):
        b, _, c = t.shape
        x = t.transpose(1, 2).reshape(b, c, ph, pw)
        x = conv(x, sd[f"seg_head.projects.{i}.weight"],
                 sd[f"seg_head.projects.{i}.bias"], nm)
        rw, rb = (sd.get(f"seg_head.resize_layers.{i}.weight"),
                  sd.get(f"seg_head.resize_layers.{i}.bias"))
        if i == 0:
            x = conv_t(x, rw, rb, nm, stride=4)
        elif i == 1:
            x = conv_t(x, rw, rb, nm, stride=2)
        elif i == 3:
            x = conv(x, rw, rb, nm, stride=2, padding=1)
        x = conv(x, sd[f"seg_head.scratch.layer{i + 1}_rn.weight"], None, nm,
                 padding=1)
        out.append(x)
    return out


def decode(rn, sd, cfg, training: bool, nm: Numerics):
    """Refinenets 4..1, then the IoU head (mean pool -> 64 -> n) and the
    mask head: (B, n, H, W) mask logits and (B, n) IoU logits."""
    s = "seg_head.scratch."

    def fuse(i, x, res, hw):
        pre = f"{s}refinenet{i}."
        if res is not None:
            x = x + rcu(res, sd, pre + "resConfUnit1.", cfg, training, nm)
        x = rcu(x, sd, pre + "resConfUnit2.", cfg, training, nm)
        x = conv(x, sd[pre + "out_conv.weight"], sd[pre + "out_conv.bias"], nm)
        return up(x, hw)

    hw = lambda t: t.shape[-2:]
    path = fuse(4, rn[3], None, hw(rn[2]))
    path = fuse(3, path, rn[2], hw(rn[1]))
    path = fuse(2, path, rn[1], hw(rn[0]))
    path1 = fuse(1, path, rn[0], (2 * rn[0].shape[-2], 2 * rn[0].shape[-1]))

    pooled = path1.mean((2, 3))
    ch = "seg_head.classifier_head."
    iou = linear(F.relu(linear(pooled, sd[ch + "2.weight"], sd[ch + "2.bias"],
                               nm)), sd[ch + "4.weight"], sd[ch + "4.bias"], nm)
    mh = "seg_head.mask_head."
    f = conv(path1, sd[mh + "output_conv1.weight"], sd[mh + "output_conv1.bias"],
             nm, padding=1)
    f = F.relu(conv_t(f, sd[mh + "upsample_2x.0.weight"],
                      sd[mh + "upsample_2x.0.bias"], nm, stride=2, padding=1))
    f = F.relu(conv(f, sd[mh + "upsample_2x.2.weight"],
                    sd[mh + "upsample_2x.2.bias"], nm, padding=1))
    ph, pw = cfg["_grid"]
    p = cfg["patch_size"]
    f = down_aa(f, (ph * p, pw * p))
    masks = []
    for i in range(cfg["num_outputs"]):
        pre = f"{mh}mask_heads.{i}."
        hdn = F.relu(conv(f, sd[pre + "0.weight"], sd[pre + "0.bias"], nm,
                          padding=1))
        masks.append(conv(hdn, sd[pre + "2.weight"], sd[pre + "2.bias"], nm))
    return torch.cat(masks, 1), iou


def _grid(cfg, images):
    p = cfg["patch_size"]
    return {**cfg, "_grid": (images.shape[1] // p, images.shape[2] // p)}


def segmentation(images, sd, cfg: dict, *, training: bool = False,
                 nm: Numerics = PLAIN, rope_scale: Optional[float] = None,
                 remat: bool = False, chunk_elems: int = 1 << 28):
    """The S3OD model: images (B, H, W, 3) normalized -> (mask logits
    (B, n, H, W), IoU logits (B, n)). `training`: BatchNorms on the
    batch's statistics."""
    cfg = _grid(cfg, images)
    taps = encoder(images, sd, cfg, nm, rope_scale, remat, chunk_elems)
    return decode(neck(taps, sd, cfg, nm), sd, cfg, training, nm)


def _proj_bn_relu(x, sd, pre, training, nm, padding=0):
    x = conv(x, sd[pre + "conv.weight"], sd[pre + "conv.bias"], nm,
             padding=padding)
    return F.relu(batch_norm(x, sd, pre + "bn.", training))


def teacher(images, flux_features: Sequence[torch.Tensor],
            concept: Dict[str, torch.Tensor], sd, cfg: dict, *,
            training: bool = False, nm: Numerics = PLAIN,
            remat: bool = False, chunk_elems: int = 1 << 28):
    """The FluxDPT teacher: per pyramid level, [DINO scratch features |
    FLUX features (B, seq, flux_dim) at stride 16, resized | concept maps
    (category, background) resized] -> 1x1 / 1x1 / 3x3 projections with
    BN + ReLU -> 3x3 + BN + ReLU -> 1x1 + BN -> 1x1 over [DINO | fused];
    then the segmentation model's refinenets and heads."""
    cfg = _grid(cfg, images)
    ph, pw = cfg["_grid"]
    taps = encoder(images, sd, cfg, nm, None, remat, chunk_elems)
    rn = neck(taps, sd, cfg, nm)
    cmap = torch.stack([concept["category"], concept["background"]], 1)
    fused = []
    for i, x in enumerate(rn):
        pre = f"fusion.{i}."
        hw = x.shape[-2:]
        fl = flux_features[i]
        fl = fl.transpose(1, 2).reshape(fl.shape[0], fl.shape[2], ph, pw)
        parts = [_proj_bn_relu(x, sd, pre + "vit.", training, nm),
                 _proj_bn_relu(down_aa(fl, hw), sd, pre + "flux.", training, nm),
                 _proj_bn_relu(down_aa(cmap, hw), sd, pre + "concept.",
                               training, nm, padding=1)]
        f = torch.cat(parts, 1)
        f = F.relu(batch_norm(conv(f, sd[pre + "fusion.conv1.weight"],
                                   sd[pre + "fusion.conv1.bias"], nm, padding=1),
                              sd, pre + "fusion.bn1.", training))
        f = batch_norm(conv(f, sd[pre + "fusion.conv2.weight"],
                            sd[pre + "fusion.conv2.bias"], nm),
                       sd, pre + "fusion.bn2.", training)
        fused.append(conv(torch.cat([x, f], 1), sd[pre + "final.weight"],
                          sd[pre + "final.bias"], nm))
    return decode(fused, sd, cfg, training, nm)
