"""Batched augmentation on the images' device (counterpart of
`s3od_tpu/ops/augment.py`).

Op-for-op coverage of the reference's `regular` and `synthetic` modes
(the checklist in `augment_batch`), plain PyTorch in float32. Each op is
split in two: `draw_<op>(g, n, h, w, device)` draws the per-sample
parameters and noise fields of n samples, and `<op>(x, params)` is
deterministic. Scalars are drawn from `g`, an explicit CPU
`torch.Generator` (never the global stream), so the per-sample gates and
OneOf picks are known on the host without a device sync; noise fields are
drawn on the images' device from a generator seeded by `g`.

The JAX package computes every branch of a OneOf on every sample and
selects afterwards (`_pick`). Here a stage draws its gate and pick per
sample, then runs each branch only on the samples that took it
(`index_select`, the op, `index_copy`): the same values, less work.

Known approximations, as in the JAX package: CLAHE on luma with RGB
rescaling instead of LAB-L; JPEG at 4:4:4; blur convs zero-pad edges;
hue shifts rotate in YIQ. The JAX CLAHE also rounds its tile histograms
and LUTs to bf16 for its one-hot matmuls; this one keeps them in float32.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from s3od_torch.ops import warp as W
from s3od_torch.parallel.mesh import shard_batch

Params = Dict[str, torch.Tensor]

# ImageNet statistics (`normalize_imagenet`).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ----------------------------------------------------------------------------
# Draws
# ----------------------------------------------------------------------------


def _u(g, n, lo, hi, shape=()) -> torch.Tensor:
    return torch.rand((n,) + tuple(shape), generator=g) * (hi - lo) + lo


def _gate(g, n, p) -> torch.Tensor:
    return torch.rand(n, generator=g) < p


def _one_of(g, n, weights) -> torch.Tensor:
    """Per-sample categorical pick with albumentations OneOf normalisation."""
    w = torch.tensor(weights, dtype=torch.float64)
    return torch.multinomial(w / w.sum(), n, replacement=True, generator=g)


def _field_generator(g, device) -> torch.Generator:
    """A generator on `device` seeded from `g`: noise fields are drawn where
    the images are, and still follow from the one explicit generator."""
    seed = int(torch.randint(0, 2**62, (), generator=g))
    return torch.Generator(device=device).manual_seed(seed)


def _to(params: Params, device) -> Params:
    return {k: W.host_to(v, device) for k, v in params.items()}


def draw_flips(g, n, p_h=0.5, p_v=0.2, p_rot90=0.2) -> Params:
    return {"h": _gate(g, n, p_h), "v": _gate(g, n, p_v),
            "rot": _gate(g, n, p_rot90),
            "k": torch.randint(1, 4, (n,), generator=g)}


def draw_geometric_warp(g, n, h, w, device, mode: str, p_rotate=0.2,
                        rotate_limit=15.0, p_distort=0.4, distort_limit=0.3,
                        grid_steps=6, elastic_alpha=1.0, elastic_sigma=25.0,
                        perspective_scale=(0.05, 0.1)) -> Params:
    """`distort`: -1 (none) or the OneOf pick optical / grid / elastic /
    perspective; `angle`: degrees, 0 where the rotation gate is closed."""
    p: Params = {"distort": torch.full((n,), -1, dtype=torch.long)}
    if mode == "synthetic" and p_distort > 0:
        choice = _one_of(g, n, [0.30, 0.30, 0.20, 0.15])
        p["distort"] = torch.where(_gate(g, n, p_distort), choice, -1)
        p["k_opt"] = _u(g, n, -distort_limit, distort_limit)
        p["sy"] = 1.0 + _u(g, n, -distort_limit, distort_limit, (grid_steps,))
        p["sx"] = 1.0 + _u(g, n, -distort_limit, distort_limit, (grid_steps,))
        gh, gw = W.elastic_grid(h, w, elastic_sigma)
        p["elastic"] = torch.randn((n, gh, gw, 2), generator=g) * elastic_alpha
        ps = _u(g, n, perspective_scale[0], perspective_scale[1])
        p["jitter"] = torch.randn((n, 4, 2), generator=g) * (
            ps[:, None, None] * torch.tensor([h, w], dtype=torch.float32))
    ang = _u(g, n, -rotate_limit, rotate_limit)
    p["angle"] = torch.where(_gate(g, n, p_rotate), ang, 0.0) \
        if p_rotate > 0 else torch.zeros(n)
    return _to(p, device)


def draw_color_jitter(g, n, h, w, device, brightness=0.5, contrast=0.5,
                      saturation=0.2, hue=0.2) -> Params:
    return _to({"fb": _u(g, n, 1 - brightness, 1 + brightness),
                "fc": _u(g, n, 1 - contrast, 1 + contrast),
                "fs": _u(g, n, 1 - saturation, 1 + saturation),
                "fh": _u(g, n, -hue, hue)}, device)


def draw_hue_saturation_value(g, n, h, w, device, hue_shift=25.0,
                              sat_shift=35.0, val_shift=30.0) -> Params:
    return _to({"dh": _u(g, n, -hue_shift, hue_shift) / 180.0,
                "ds": _u(g, n, -sat_shift, sat_shift) / 255.0,
                "dv": _u(g, n, -val_shift, val_shift) / 255.0}, device)


def draw_none(g, n, h, w, device) -> Params:
    return {}


def draw_gauss_noise(g, n, h, w, device, std_range=(0.2, 0.44)) -> Params:
    std = _u(g, n, std_range[0], std_range[1]) * 0.1
    dg = _field_generator(g, device)
    return {"std": W.host_to(std, device),
            "noise": torch.randn((n, h, w, 3), generator=dg, device=device)}


def draw_iso_noise(g, n, h, w, device, color_shift=(0.01, 0.03),
                   intensity=(0.08, 0.3)) -> Params:
    p = _to({"inten": _u(g, n, intensity[0], intensity[1]),
             "cshift": _u(g, n, color_shift[0], color_shift[1])}, device)
    dg = _field_generator(g, device)
    p["lum"] = torch.randn((n, h, w, 1), generator=dg, device=device)
    p["hue"] = torch.randn((n, h, w), generator=dg, device=device)
    return p


def draw_multiplicative_noise(g, n, h, w, device, mult=(0.9, 1.1)) -> Params:
    return _to({"f": _u(g, n, mult[0], mult[1])}, device)


def draw_jpeg(g, n, h, w, device, quality_range=(30, 80)) -> Params:
    return _to({"q": _u(g, n, quality_range[0], quality_range[1])}, device)


def draw_pixelate(g, n, h, w, device, scale_range=(0.4, 0.7)) -> Params:
    return _to({"s": _u(g, n, scale_range[0], scale_range[1])}, device)


def draw_shadow(g, n, h, w, device, num_range=(1, 3),
                roi=(0.0, 0.1, 1.0, 1.0)) -> Params:
    k = num_range[1]
    return _to({"n": torch.randint(num_range[0], num_range[1] + 1, (n,),
                                   generator=g),
                "cy": _u(g, n, roi[1] * h, roi[3] * h, (k,)),
                "cx": _u(g, n, roi[0] * w, roi[2] * w, (k,)),
                "ang": _u(g, n, 0.0, math.pi, (k,)),
                "hh": _u(g, n, 0.08 * h, 0.35 * h, (k,)),
                "ww": _u(g, n, 0.08 * w, 0.35 * w, (k,))}, device)


def draw_brightness_contrast(g, n, h, w, device, brightness=0.4,
                             contrast=0.4) -> Params:
    return _to({"alpha": 1.0 + _u(g, n, -contrast, contrast),
                "beta": _u(g, n, -brightness, brightness)}, device)


def draw_motion_blur(g, n, h, w, device) -> Params:
    return _to({"angle": _u(g, n, 0.0, math.pi),
                "length": _u(g, n, 3.0, 7.0)}, device)


def draw_gaussian_blur(g, n, h, w, device) -> Params:
    return _to({"ksize": _u(g, n, 3.0, 7.0)}, device)


def draw_defocus(g, n, h, w, device) -> Params:
    return _to({"radius": _u(g, n, 2.0, 6.0), "alias": _u(g, n, 0.1, 0.3)},
               device)


def draw_zoom_blur(g, n, h, w, device) -> Params:
    return _to({"zf": _u(g, n, 1.0, 1.03)}, device)


def draw_channel_shuffle(g, n, h, w, device) -> Params:
    perm = torch.stack([torch.randperm(3, generator=g) for _ in range(n)]) \
        if n else torch.zeros((0, 3), dtype=torch.long)
    return _to({"perm": perm}, device)


def draw_sharpen(g, n, h, w, device, alpha=(0.2, 0.5),
                 lightness=(0.5, 1.0)) -> Params:
    return _to({"a": _u(g, n, alpha[0], alpha[1]),
                "l": _u(g, n, lightness[0], lightness[1])}, device)


def draw_emboss(g, n, h, w, device, alpha=(0.2, 0.4),
                strength=(0.2, 0.5)) -> Params:
    return _to({"a": _u(g, n, alpha[0], alpha[1]),
                "s": _u(g, n, strength[0], strength[1])}, device)


def draw_snow(g, n, h, w, device, snow_point=(0.1, 0.3)) -> Params:
    return _to({"sp": _u(g, n, snow_point[0], snow_point[1])}, device)


RAIN_SLANTS = (-10.0, -5.0, 0.0, 5.0, 10.0)


def draw_rain(g, n, h, w, device, density=1.0 / 600.0) -> Params:
    """Drop seeds (n, H, W) as 0/1 floats and the slant level's index."""
    pick = torch.randint(0, len(RAIN_SLANTS), (n,), generator=g)
    dg = _field_generator(g, device)
    seeds = (torch.rand((n, h, w), generator=dg, device=device)
             < density).float()
    return {"seeds": seeds, "pick": pick}  # the pick stays on the host


# ----------------------------------------------------------------------------
# Geometric (image + mask)
# ----------------------------------------------------------------------------


def _where(gate: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    return torch.where(gate.reshape((-1,) + (1,) * (x.ndim - 1)), y, x)


def random_flips(images, masks, p: Params):
    """Batched flips + rot90 (`transforms.py:32-34`), square canvas."""
    images = _where(p["h"], images.flip(2), images)
    masks = _where(p["h"], masks.flip(2), masks)
    images = _where(p["v"], images.flip(1), images)
    masks = _where(p["v"], masks.flip(1), masks)
    for k in (1, 2, 3):
        sel = p["rot"] & (p["k"] == k)
        images = _where(sel, torch.rot90(images, k, (1, 2)), images)
        masks = _where(sel, torch.rot90(masks, k, (1, 2)), masks)
    return images, masks


def geometric_warp(images, masks, p: Params):
    """Rotate(+-15 deg, p=0.2) (`transforms.py:41`) composed with the
    synthetic distortion OneOf (optical / grid / elastic / perspective,
    `:159-178`) as one gather: the distortion's source coordinates are
    rotated analytically. Only samples with a distortion or a rotation
    are sampled; the rest are unchanged (the identity field reads them
    back exactly)."""
    b, h, w = images.shape[0], images.shape[1], images.shape[2]
    coords = W.base_grid(h, w, images.device).expand(b, h, w, 2).clone()
    builders = {
        0: lambda i: W.optical_coords(h, w, p["k_opt"][i]),
        1: lambda i: W.grid_distortion_coords(h, w, p["sy"][i], p["sx"][i]),
        2: lambda i: W.elastic_coords(h, w, p["elastic"][i]),
        3: lambda i: W.perspective_coords(h, w, p["jitter"][i]),
    }
    dist = p["distort"].tolist()
    for kind, build in builders.items():
        idx = [i for i, d in enumerate(dist) if d == kind]
        if idx:
            i = W.host_to(torch.tensor(idx), images.device)
            coords[i] = build(i)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th = -p["angle"] * math.pi / 180.0
    cos, sin = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    dy, dx = coords[..., 0] - cy, coords[..., 1] - cx
    coords = torch.stack([cy + dy * cos - dx * sin, cx + dy * sin + dx * cos],
                         dim=-1)
    moved = [i for i, (d, a) in enumerate(zip(dist, p["angle"].tolist()))
             if d >= 0 or a != 0.0]
    if not moved:
        return images, masks
    i = W.host_to(torch.tensor(moved), images.device)
    img, m = W.batched_warp(images.index_select(0, i), masks.index_select(0, i),
                            coords.index_select(0, i))
    return images.index_copy(0, i, img), masks.index_copy(0, i, m)


# ----------------------------------------------------------------------------
# Colour-space helpers; images float32 in [0, 1], (B, H, W, 3)
# ----------------------------------------------------------------------------


def _rgb_to_gray(x):
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(-1)
    mn = x.amin(-1)
    d = mx - mn + 1e-12
    h = torch.where(
        mx == r, torch.remainder((g - b) / d, 6.0),
        torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0)) / 6.0
    s = d / (mx + 1e-12)
    return torch.stack([torch.remainder(h, 1.0), s, mx], dim=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]

    def f(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([f(5.0), f(3.0), f(1.0)], dim=-1)


def _rotate_hue_yiq(x, theta):
    """Hue rotation in YIQ (theta broadcastable against (B, H, W))."""
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    y = _rgb_to_gray(x)[..., 0]
    i = 0.596 * x[..., 0] - 0.274 * x[..., 1] - 0.322 * x[..., 2]
    q = 0.211 * x[..., 0] - 0.523 * x[..., 1] + 0.312 * x[..., 2]
    i2 = i * cos_t - q * sin_t
    q2 = i * sin_t + q * cos_t
    r = y + 0.956 * i2 + 0.621 * q2
    g = y - 0.272 * i2 - 0.647 * q2
    b = y - 1.106 * i2 + 1.703 * q2
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def _col(v: torch.Tensor, nd: int = 4) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (nd - 1))


# ----------------------------------------------------------------------------
# Photometric ops (image only)
# ----------------------------------------------------------------------------


def color_jitter(x, p: Params):
    """`A.ColorJitter` (`transforms.py:46-52,66-73`): multiplicative
    brightness / contrast / saturation factors + a hue rotation (YIQ)."""
    x = x * _col(p["fb"])
    mean = _rgb_to_gray(x).mean(dim=(1, 2), keepdim=True)
    x = (x - mean) * _col(p["fc"]) + mean
    gray = _rgb_to_gray(x)
    x = (x - gray) * _col(p["fs"]) + gray
    return _rotate_hue_yiq(torch.clamp(x, 0.0, 1.0), _col(p["fh"], 3) * math.pi)


def hue_saturation_value(x, p: Params):
    """`A.HueSaturationValue(25, 35, 30)` (`transforms.py:74-79`): an
    RGB <-> HSV round trip with additive shifts."""
    hsv = _rgb_to_hsv(x)
    hsv = torch.stack([
        torch.remainder(hsv[..., 0] + _col(p["dh"], 3), 1.0),
        torch.clamp(hsv[..., 1] + _col(p["ds"], 3), 0.0, 1.0),
        torch.clamp(hsv[..., 2] + _col(p["dv"], 3), 0.0, 1.0)], dim=-1)
    return _hsv_to_rgb(hsv)


def clahe(x, p: Optional[Params] = None, clip_limit=4.0, grid=8, bins=64):
    """`A.CLAHE(clip_limit=4.0, tile_grid_size=(8, 8))` (`transforms.py:80-84`)
    on luma with RGB rescaling: 64-bin tile histograms of the 2x2-subsampled
    pixels (`scatter_add_`), clipped and redistributed, their cumulative
    LUTs read per pixel (`torch.gather`) and mixed bilinearly between the
    four neighbouring tiles over half-tile-shifted regions."""
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    th, tw = h // grid, w // grid
    y = torch.clamp(_rgb_to_gray(x)[..., 0], 0.0, 1.0)
    q = torch.clamp((y * bins).long(), 0, bins - 1)

    qt = q.reshape(b, grid, th, grid, tw).permute(0, 1, 3, 2, 4)
    sub = qt[..., ::2, ::2].reshape(b, grid * grid, -1)
    hist = torch.zeros(b, grid * grid, bins, device=x.device)
    hist.scatter_add_(2, sub, torch.ones_like(sub, dtype=hist.dtype))
    npx = float(sub.shape[-1])
    clip = max(1.0, clip_limit * npx / bins)
    excess = torch.clamp(hist - clip, min=0.0).sum(-1, keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / bins
    lut = (torch.cumsum(hist, -1) / npx).reshape(b, grid, grid, bins)

    ph, pw = th // 2, tw // 2
    rows = torch.clamp(torch.arange(-ph, h + th - ph, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-pw, w + tw - pw, device=x.device), 0, w - 1)
    qp = q[:, rows][:, :, cols]
    qr = qp.reshape(b, grid + 1, th, grid + 1, tw).permute(0, 1, 3, 2, 4)
    qr = qr.reshape(b, grid + 1, grid + 1, th * tw)

    ai = torch.arange(grid + 1, device=x.device)
    a0 = torch.clamp(ai - 1, 0, grid - 1)
    a1 = torch.clamp(ai, 0, grid - 1)
    out = 0.0
    wy = ((torch.arange(th, dtype=torch.float32, device=x.device) + 0.5)
          / th)[:, None]
    wx = ((torch.arange(tw, dtype=torch.float32, device=x.device) + 0.5)
          / tw)[None, :]
    for ay, ax, wgt in ((a0, a0, (1 - wy) * (1 - wx)), (a0, a1, (1 - wy) * wx),
                        (a1, a0, wy * (1 - wx)), (a1, a1, wy * wx)):
        corner = lut[:, ay][:, :, ax]  # (B, G+1, G+1, bins)
        out = out + torch.gather(corner, 3, qr) * wgt.reshape(-1)
    out = out.reshape(b, grid + 1, grid + 1, th, tw).permute(0, 1, 3, 2, 4)
    out = out.reshape(b, h + th, w + tw)[:, ph: ph + h, pw: pw + w]
    ratio = out / (y + 1e-6)
    return torch.clamp(x * ratio[..., None], 0.0, 1.0)


def gauss_noise(x, p: Params):
    """`A.GaussNoise` (`transforms.py:59,94-97`)."""
    return torch.clamp(x + _col(p["std"]) * p["noise"], 0.0, 1.0)


def iso_noise(x, p: Params):
    """`A.ISONoise` (`transforms.py:60,89-93`): luma noise scaled by
    sqrt(Y) + a per-pixel hue drift."""
    y = _rgb_to_gray(x)
    lum = p["lum"] * torch.sqrt(torch.clamp(y, 0.0, 1.0))
    x = torch.clamp(x + _col(p["inten"]) * lum, 0.0, 1.0)
    theta = p["hue"] * _col(p["cshift"], 3) * (2 * math.pi)
    return _rotate_hue_yiq(x, theta)


def multiplicative_noise(x, p: Params):
    """`A.MultiplicativeNoise(multiplier=(0.9, 1.1))` (`transforms.py:61,98-101`)."""
    return torch.clamp(x * _col(p["f"]), 0.0, 1.0)


_JPEG_Q_LUMA = np.asarray([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99]], np.float32)

_JPEG_Q_CHROMA = np.full((8, 8), 99, np.float32)
_JPEG_Q_CHROMA[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66],
                          [24, 26, 56, 99], [47, 66, 99, 99]]


@functools.lru_cache(maxsize=1)
def _dct8_np() -> np.ndarray:
    c = np.zeros((8, 8), np.float32)
    for k in range(8):
        for n in range(8):
            c[k, n] = math.cos(math.pi * (2 * n + 1) * k / 16.0)
    c *= math.sqrt(2.0 / 8.0)
    c[0] /= math.sqrt(2.0)
    return c


def jpeg_compression(x, p: Params):
    """`A.ImageCompression(quality_range=(30, 80))` (`transforms.py:106-109`):
    JPEG luma / chroma quantisation in the 8x8 DCT domain (4:4:4)."""
    b, h, w = x.shape[0], x.shape[1], x.shape[2]
    q = p["q"]
    scale = torch.where(q < 50, 5000.0 / q, 200.0 - 2.0 * q)[:, None, None]

    def table(base):
        t = W.host_to(torch.from_numpy(base), x.device)[None]
        return torch.clamp(torch.floor((t * scale + 50) / 100), 1, 255)

    qt_l, qt_c = table(_JPEG_Q_LUMA), table(_JPEG_Q_CHROMA)
    r, g, bl = x[..., 0], x[..., 1], x[..., 2]
    y = (0.299 * r + 0.587 * g + 0.114 * bl) * 255.0 - 128.0
    cb = (-0.168736 * r - 0.331264 * g + 0.5 * bl) * 255.0
    cr = (0.5 * r - 0.418688 * g - 0.081312 * bl) * 255.0
    c = W.host_to(torch.from_numpy(_dct8_np()), x.device)

    def codec(chan, qt):
        blocks = chan.reshape(b, h // 8, 8, w // 8, 8)
        f = torch.einsum("ki,bhiwj,lj->bhkwl", c, blocks, c)
        qt = qt[:, None, :, None, :]
        f = torch.round(f / qt) * qt
        return torch.einsum("ik,bhkwl,jl->bhiwj", c, f, c).reshape(b, h, w)

    y = codec(y, qt_l) + 128.0
    cb = codec(cb, qt_c)
    cr = codec(cr, qt_c)
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    bl = y + 1.772 * cb
    return torch.clamp(torch.stack([r, g, bl], dim=-1) / 255.0, 0.0, 1.0)


def pixelate(x, p: Params):
    """`A.Downscale(scale_range=(0.4, 0.7))` (`transforms.py:110-113`):
    nearest down + up, i.e. sampling at quantised coordinates."""
    h, w = x.shape[1], x.shape[2]
    s = p["s"][:, None]
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None] * s
    ys = torch.floor(ys) / s + 0.5 / s
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None] * s
    xs = torch.floor(xs) / s + 0.5 / s
    return W.resample_cols(W.resample_rows(x, ys, "nearest"), xs, "nearest")


def random_shadow(x, p: Params, darkness=0.5):
    """`A.RandomShadow(shadow_roi=(0, 0.1, 1, 1), num_shadows_limit=(1, 3))`
    (`transforms.py:118-122`): soft rotated-rectangle shadows."""
    h, w = x.shape[1], x.shape[2]
    g = W.base_grid(h, w, x.device)
    yy, xx = g[..., 0][None, None], g[..., 1][None, None]
    e = lambda k: p[k][..., None, None]
    dy, dx = yy - e("cy"), xx - e("cx")
    ca, sa = torch.cos(e("ang")), torch.sin(e("ang"))
    u = dy * ca - dx * sa
    v = dy * sa + dx * ca
    soft = 4.0
    inside = (torch.sigmoid((e("hh") - u.abs()) / soft)
              * torch.sigmoid((e("ww") - v.abs()) / soft))
    k = p["cy"].shape[1]
    active = (torch.arange(k, device=x.device)[None] < p["n"][:, None]).float()
    shade = 1.0 - (1.0 - darkness) * torch.clamp(
        (inside * active[..., None, None]).sum(1), 0.0, 1.0)
    return x * shade[..., None]


def random_brightness_contrast(x, p: Params):
    """`A.RandomBrightnessContrast(0.4, 0.4)` (`transforms.py:123-127`)."""
    return torch.clamp(x * _col(p["alpha"]) + _col(p["beta"]), 0.0, 1.0)


# --- Blur family: per-sample 13x13 kernels, one depthwise conv ---------------

BLUR_K = 13  # holds defocus radius 6, motion length 7, gaussian k <= 7


def _blur_grid(device):
    r = BLUR_K // 2
    d = torch.arange(-r, r + 1, dtype=torch.float32, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return dy[None], dx[None]


def gaussian_kernel(ksize: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur's sigma convention: 0.3 ((k - 1)/2 - 1) + 0.8."""
    dy, dx = _blur_grid(ksize.device)
    sigma = (0.3 * ((ksize - 1.0) * 0.5 - 1.0) + 0.8)[:, None, None]
    r2 = dy * dy + dx * dx
    k = torch.exp(-r2 / (2 * sigma * sigma))
    k = k * (r2 <= (ksize[:, None, None] / 2.0) ** 2 + 1e-6)
    return k / k.sum((1, 2), keepdim=True)


def motion_kernel(angle: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """A line of `length` px at `angle` through the centre
    (`A.MotionBlur(blur_limit=(3, 7))`)."""
    dy, dx = _blur_grid(angle.device)
    ca, sa = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    along = dy * sa + dx * ca
    perp = dy * ca - dx * sa
    k = ((perp.abs() <= 0.5) & (along.abs() <= length[:, None, None] / 2.0))
    k = k.float()
    return k / torch.clamp(k.sum((1, 2), keepdim=True), min=1.0)


def defocus_kernel(radius: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """A disk of `radius` with a soft edge
    (`A.Defocus(radius=(2, 6), alias_blur=(0.1, 0.3))`)."""
    dy, dx = _blur_grid(radius.device)
    d = torch.sqrt(dy * dy + dx * dx)
    k = torch.sigmoid((radius[:, None, None] - d)
                      / torch.clamp(alias * 2.0, min=0.05)[:, None, None])
    return k / k.sum((1, 2), keepdim=True)


def depthwise_blur(x, kern: torch.Tensor):
    """Each sample's 13x13 kernel (n, 13, 13) over its three channels, zero
    padding, cross-correlation as `lax.conv_general_dilated`; float32
    products (TF32 off for the call)."""
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    folded = x.permute(0, 3, 1, 2).reshape(1, n * 3, h, w)
    weight = kern.repeat_interleave(3, 0)[:, None]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        out = F.conv2d(folded, weight, padding=BLUR_K // 2, groups=n * 3)
    return out.reshape(n, 3, h, w).permute(0, 2, 3, 1)


def motion_blur(x, p: Params):
    return depthwise_blur(x, motion_kernel(p["angle"], p["length"]))


def gaussian_blur(x, p: Params):
    return depthwise_blur(x, gaussian_kernel(p["ksize"]))


def defocus(x, p: Params):
    return depthwise_blur(x, defocus_kernel(p["radius"], p["alias"]))


def zoom_blur(x, p: Params):
    """ZoomBlur (max_factor 1.03): the mean over zoom taps 1, 1.015, 1.03."""
    h, w = x.shape[1], x.shape[2]
    zf = p["zf"][:, None]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None]
    acc = x
    for t in (0.5, 1.0):
        s = 1.0 / (1.0 + (zf - 1.0) * t)
        z = W.resample_rows(x, cy + (ys - cy) * s, "linear")
        acc = acc + W.resample_cols(z, cx + (xs - cx) * s, "linear")
    return acc / 3.0


# --- Colour-space swaps --------------------------------------------------------

_SEPIA = np.asarray([[0.393, 0.769, 0.189],
                     [0.349, 0.686, 0.168],
                     [0.272, 0.534, 0.131]], np.float32)


def to_sepia(x, p: Optional[Params] = None):
    """`A.ToSepia` (`transforms.py:153`)."""
    s = W.host_to(torch.from_numpy(_SEPIA), x.device)
    return torch.clamp(torch.einsum("bhwc,dc->bhwd", x, s), 0.0, 1.0)


def to_gray(x, p: Optional[Params] = None):
    return _rgb_to_gray(x).expand(x.shape)


def channel_shuffle(x, p: Params):
    """Per-sample channel permutation (`A.ChannelShuffle`)."""
    perm = p["perm"][:, None, None, :].expand(x.shape)
    return torch.gather(x, 3, perm)


# --- Sharpen / Emboss / Posterize -------------------------------------------


def _shift(x, dy, dx):
    return torch.roll(x, (dy, dx), dims=(1, 2))


def sharpen(x, p: Params):
    """`A.Sharpen` (`transforms.py:53,187-190`): (1 - a) img + a conv(img,
    [[-1, -1, -1], [-1, 8 + l, -1], [-1, -1, -1]]) as (9 + l) img - box3."""
    box = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            box = box + _shift(x, dy, dx)
    a, l = _col(p["a"]), _col(p["l"])
    eff = (9.0 + l) * x - box
    return torch.clamp((1 - a) * x + a * eff, 0.0, 1.0)


def emboss(x, p: Params):
    """`A.Emboss` (`transforms.py:182-186`): the relief kernel
    [[-1-s, -s, 0], [-s, 1, s], [0, s, 1+s]] blended by alpha."""
    a, s = _col(p["a"]), _col(p["s"])
    diag = _shift(x, 1, 1) - _shift(x, -1, -1)
    cross = (_shift(x, 1, 0) + _shift(x, 0, 1)
             - _shift(x, -1, 0) - _shift(x, 0, -1))
    eff = x + diag + s * (diag + cross)
    return torch.clamp((1 - a) * x + a * eff, 0.0, 1.0)


def posterize(x, p: Optional[Params] = None, num_bits=5):
    """`A.Posterize(num_bits=5)` (`transforms.py:191-194`)."""
    q = float(1 << (8 - num_bits))
    return torch.floor(x * 255.0 / q) * q / 255.0


# --- Weather -------------------------------------------------------------------


def random_snow(x, p: Params, brightness_coeff=2.5):
    """`A.RandomSnow(method="bleach")` (`transforms.py:200-205`)."""
    thr = 85.0 / 255.0 + _col(p["sp"], 3) * 0.5
    y = _rgb_to_gray(x)[..., 0]
    factor = torch.where(y < thr, brightness_coeff, 1.0)
    return torch.clamp(x * factor[..., None], 0.0, 1.0)


def _streaks(seeds, s_px: float, drop_length: int = 20):
    """Slanted streaks grown by doubling shift-adds: 1 -> 2 -> 4 -> 8 ->
    16, then + 4 = 20 px."""
    acc, grown, parts = seeds, 1, [seeds]
    while grown < 16:
        dx = int(round(grown * s_px / drop_length))
        acc = acc + torch.roll(acc, (grown, dx), dims=(1, 2))
        grown *= 2
        parts.append(acc)
    dx16 = int(round(16 * s_px / drop_length))
    return acc + torch.roll(parts[2], (16, dx16), dims=(1, 2))


def random_rain(x, p: Params, drop_color=(200, 200, 200),
                brightness_coefficient=0.7):
    """`A.RandomRain` (`transforms.py:206-215`): drop seeds grown into
    slanted streaks, softened by a linear down-up resize (antialiased
    down, as `jax.image.resize`), the drop colour composited over the
    darkened scene."""
    n, h, w = x.shape[0], x.shape[1], x.shape[2]
    streaks = torch.empty_like(p["seeds"])
    picks = p["pick"].tolist()
    for lvl, s_px in enumerate(RAIN_SLANTS):
        idx = [i for i, k in enumerate(picks) if k == lvl]
        if idx:
            i = W.host_to(torch.tensor(idx), x.device)
            streaks[i] = _streaks(p["seeds"][i], s_px)
    streaks = torch.clamp(streaks, 0.0, 1.0)[:, None]
    small = F.interpolate(streaks, size=(h // 4, w // 4), mode="bilinear",
                          align_corners=False, antialias=True)
    streaks = F.interpolate(small, size=(h, w), mode="bilinear",
                            align_corners=False)[:, 0] * 0.7
    color = W.host_to(torch.tensor(drop_color, dtype=torch.float32),
                      x.device) / 255.0
    out = x * brightness_coefficient
    return out * (1 - streaks[..., None]) + color * streaks[..., None]


# ----------------------------------------------------------------------------
# Composed pipelines
# ----------------------------------------------------------------------------

Op = Tuple[Callable, Callable]  # (op(x, params), draw(g, n, h, w, device))


def _stages(mode: str, div8: bool) -> List[Tuple[str, float, list, List[Op]]]:
    """The photometric stages in order: (name, gate probability, OneOf
    weights, one (op, draw) per branch). CLAHE tiles and JPEG blocks need
    canvases divisible by 8; elsewhere their branches run the sibling op
    the JAX package substitutes (HSV, pixelate)."""
    P = functools.partial
    cj = lambda *a: (color_jitter, P(draw_color_jitter, brightness=a[0],
                                     contrast=a[1], saturation=a[2], hue=a[3]))
    sh = lambda al, li: (sharpen, P(draw_sharpen, alpha=al, lightness=li))
    gauss = lambda r: (gauss_noise, P(draw_gauss_noise, std_range=r))
    iso = (iso_noise, draw_iso_noise)
    mult = (multiplicative_noise, draw_multiplicative_noise)
    hsv = (hue_saturation_value, draw_hue_saturation_value)
    pix = (pixelate, draw_pixelate)
    if mode == "regular":
        return [
            ("color", 0.5, [0.7, 0.3], [cj(0.5, 0.5, 0.2, 0.2),
                                        sh((0.2, 0.5), (0.5, 1.0))]),
            ("noise", 0.3, [1.0, 1.0, 1.0], [gauss((0.2, 0.44)), iso, mult]),
        ]
    if mode != "synthetic":
        raise ValueError(f"unknown transform mode {mode!r}")
    return [
        ("color", 0.7, [0.7, 0.4, 0.2],
         [cj(0.4, 0.4, 0.3, 0.2), hsv, (clahe, draw_none) if div8 else hsv]),
        ("noise", 0.6, [0.4, 0.4, 0.4], [iso, gauss((0.25, 0.6)), mult]),
        ("quality", 0.5, [0.4, 0.3],
         [(jpeg_compression, draw_jpeg) if div8 else pix, pix]),
        ("lighting", 0.5, [0.4, 0.4],
         [(random_shadow, draw_shadow),
          (random_brightness_contrast, draw_brightness_contrast)]),
        ("blur", 0.5, [0.4, 0.4, 0.3, 0.2],
         [(motion_blur, draw_motion_blur), (gaussian_blur, draw_gaussian_blur),
          (defocus, draw_defocus), (zoom_blur, draw_zoom_blur)]),
        ("colorspace", 0.05, [0.5, 0.5, 0.3],
         [(to_sepia, draw_none), (to_gray, draw_none),
          (channel_shuffle, draw_channel_shuffle)]),
        ("relief", 0.3, [0.3, 0.3, 0.2],
         [(emboss, draw_emboss), sh((0.2, 0.6), (0.5, 1.2)),
          (posterize, draw_none)]),
        ("weather", 0.15, [0.5, 0.5],
         [(random_snow, draw_snow), (random_rain, draw_rain)]),
    ]


def draw_augment(generator: torch.Generator, b: int, h: int, w: int,
                 mode: str, device, device_geometric: bool = True) -> Dict:
    """Every draw of one `augment_batch` call: the flips, the device
    geometry (when asked), and per photometric stage the branch each
    sample takes (-1: untouched) with the parameters of the samples of
    each branch, in sample order."""
    plan: Dict = {"mode": mode, "stages": []}
    if mode == "test":
        return plan
    plan["flips"] = _to(draw_flips(generator, b), device)
    if device_geometric:
        plan["geometric"] = draw_geometric_warp(
            generator, b, h, w, device, mode,
            p_distort=0.4 if mode == "synthetic" else 0.0)
    for name, p_gate, weights, ops in _stages(mode, h % 8 == 0 and w % 8 == 0):
        gate = _gate(generator, b, p_gate)
        pick = _one_of(generator, b, weights)
        branch = torch.where(gate, pick, -1).tolist()
        params = {}
        for i, (_, draw) in enumerate(ops):
            n = branch.count(i)
            if n:
                params[i] = draw(generator, n, h, w, device)
        plan["stages"].append({"name": name, "branch": branch,
                               "params": params})
    return plan


def shard_plan(plan: Dict, shard: Tuple[int, int]) -> Dict:
    """The plan of the rows `shard_batch(.., shard)` takes of the batch it
    was drawn for (every parameter is per sample, in sample order within
    its branch)."""
    if plan["mode"] == "test":
        return plan
    rows = lambda p, idx: {k: v[idx] for k, v in p.items()}
    b = len(plan["stages"][0]["branch"]) if plan["stages"] else \
        plan["flips"]["h"].shape[0]
    keep = shard_batch(list(range(b)), shard)
    out = {"mode": plan["mode"], "flips": rows(plan["flips"], keep),
           "stages": []}
    if "geometric" in plan:
        out["geometric"] = rows(plan["geometric"], keep)
    for stage in plan["stages"]:
        branch = stage["branch"]
        params = {}
        for i, p in stage["params"].items():
            members = [j for j, k in enumerate(branch) if k == i]
            idx = [members.index(j) for j in keep if branch[j] == i]
            if idx:
                params[i] = rows(p, idx)
        out["stages"].append({"name": stage["name"],
                              "branch": [branch[j] for j in keep],
                              "params": params})
    return out


def apply_augment(images_u8: torch.Tensor, masks: torch.Tensor,
                  plan: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a drawn plan: deterministic given the plan."""
    x = images_u8.float() / 255.0
    mode = plan["mode"]
    if mode == "test":
        return x, masks
    x, masks = random_flips(x, masks, plan["flips"])
    if "geometric" in plan:
        x, masks = geometric_warp(x, masks, plan["geometric"])
    h, w = x.shape[1], x.shape[2]
    stages = _stages(mode, h % 8 == 0 and w % 8 == 0)
    for (name, _, _, ops), stage in zip(stages, plan["stages"]):
        assert name == stage["name"], (name, stage["name"])
        out = x
        for i, p in stage["params"].items():
            idx = W.host_to(torch.tensor(
                [j for j, k in enumerate(stage["branch"]) if k == i]), x.device)
            out = out.index_copy(0, idx, ops[i][0](x.index_select(0, idx), p))
        x = out
    return x, masks


def augment_batch(images_u8: torch.Tensor, masks: torch.Tensor,
                  mode: str = "regular",
                  generator: Optional[torch.Generator] = None,
                  device_geometric: bool = True,
                  shard: Optional[Tuple[int, int]] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full batched augmentation: images uint8 (B, S, S, 3), masks float
    (B, S, S) -> (images float32 in [0, 1], masks). Modes: test | regular
    | synthetic. `generator` is a CPU `torch.Generator` (required unless
    mode is test). `shard` = (rank, world): the batch is the rows
    `parallel.mesh.shard_batch` takes of a global batch of B * world; the
    draws are the global batch's, sliced the same way (`shard_plan`), so
    that they do not depend on the world size.

    Op-for-op checklist vs `model_training/transforms.py`:

    geometric (regular + synthetic, `:31-42`):
      HorizontalFlip p=.5 / VerticalFlip p=.2 / RandomRotate90 p=.2 [here],
      RandomResizedCrop p=.5 [host draw, training/data.py], Rotate +-15 deg
      p=.2 [here with device_geometric, else drawn by the loader]
    regular colour OneOf p=.5 (`:44-55`): ColorJitter(.5,.5,.2,.2) w=.7 |
      Sharpen(.2-.5,.5-1.) w=.3
    regular noise OneOf p=.3 (`:57-63`): GaussNoise(.2-.44) | ISONoise |
      MultiplicativeNoise(.9-1.1), equal weights
    synthetic (`:65-217`):
      1. colour OneOf p=.7: ColorJitter(.4,.4,.3,.2) w=.7 | HSV(25,35,30)
         w=.4 | CLAHE(4.0, 8x8) w=.2
      2. noise OneOf p=.6: ISONoise(.01-.03,.08-.3) | GaussNoise(.25-.6) |
         MultiplicativeNoise(.9-1.1), w=.4 each
      3. quality OneOf p=.5: ImageCompression(q30-80) w=.4 | Downscale
         (.4-.7) w=.3
      4. lighting OneOf p=.5: RandomShadow(1-3) w=.4 |
         RandomBrightnessContrast(.4,.4) w=.4
      5. blur OneOf p=.5: MotionBlur(3-7) w=.4 | GaussianBlur(3-7) w=.4 |
         Defocus(2-6,.1-.3) w=.3 | ZoomBlur(1.03) w=.2
      6. colourspace OneOf p=.05: ToSepia w=.5 | ToGray w=.5 |
         ChannelShuffle w=.3
      7. distortion OneOf p=.4 [fused into the geometric warp]:
         OpticalDistortion(.3) w=.3 | GridDistortion(6,.3) w=.3 |
         ElasticTransform(1,25) w=.2 | Perspective(.05-.1) w=.15
      8. relief OneOf p=.3: Emboss(.2-.4,.2-.5) w=.3 | Sharpen(.2-.6,.5-1.2)
         w=.3 | Posterize(5) w=.2
      9. weather OneOf p=.15: RandomSnow w=.1 | RandomRain w=.1
    """
    if mode != "test" and generator is None:
        raise ValueError("augment_batch needs an explicit torch.Generator")
    b, h, w = images_u8.shape[0], images_u8.shape[1], images_u8.shape[2]
    world = shard[1] if shard is not None else 1
    plan = draw_augment(generator, b * world, h, w, mode, images_u8.device,
                        device_geometric)
    if world > 1:
        plan = shard_plan(plan, shard)
    return apply_augment(images_u8, masks, plan)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> ImageNet-normalised."""
    mean = W.host_to(torch.tensor(IMAGENET_MEAN, dtype=x.dtype), x.device)
    std = W.host_to(torch.tensor(IMAGENET_STD, dtype=x.dtype), x.device)
    return (x - mean) / std
