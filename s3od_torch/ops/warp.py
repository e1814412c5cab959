"""Batched geometric warps for augmentation (counterpart of
`s3od_tpu/ops/warp.py`).

One sampler serves every geometric distortion of the reference's
albumentations pipelines (`model_training/transforms.py`): Rotate(+-15 deg)
(:41), Perspective (:174-177), OpticalDistortion (:160-163),
GridDistortion (:164-168), ElasticTransform (:169-173), and the loader's
RandomResizedCrop (:35-40). Each is a per-sample field of source
coordinates; images are sampled bilinearly and masks by the nearest
pixel, with OpenCV's default border, BORDER_REFLECT_101.

Coordinates are (y, x) in pixel units of the source image. The JAX
package builds its resamplers from one-hot and interpolation-matrix
matmuls because point gathers were slow on its chip; here they are
gathers (`torch.gather`). Both compute the same sums.

`apply_host_geometry` applies what the training loader drew on the host
(`s3od_torch.training.data.draw_host_geometry`): the crop, then the
rotation, then the distortion, each rounded back to uint8 as OpenCV's
uint8 resamplers round, in the JAX loader's order
(`s3od_tpu/training/data.py:77-201`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def host_to(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor onto `device` without waiting for the device's queue:
    through pinned memory, non-blocking (a plain `.to` from pageable
    memory synchronises the stream, which would hold the upload worker
    until the running training step ends)."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """cv2.BORDER_REFLECT_101 index folding: ...2 1 | 0 1 2 ... n-1 | n-2..."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    idx = idx.abs() % period
    return torch.where(idx >= n, period - idx, idx)


def grid_sample(img: torch.Tensor, coords: torch.Tensor,
                method: str = "linear") -> torch.Tensor:
    """Sample `img` (B, H, W, C) at float `coords` (B, H', W', 2) [(y, x)
    order] -> (B, H', W', C), reflect-101 outside the image.

    method: "linear" (bilinear) or "nearest" (masks keep hard labels, as
    albumentations' nearest mask interpolation; ties round to even)."""
    b, h, w, c = img.shape
    ho, wo = coords.shape[1], coords.shape[2]
    flat = img.reshape(b, h * w, c)
    cy, cx = coords[..., 0].reshape(b, -1), coords[..., 1].reshape(b, -1)

    def fetch(iy, ix):
        i = _reflect101(iy, h) * w + _reflect101(ix, w)
        return torch.gather(flat, 1, i[..., None].expand(-1, -1, c))

    if method == "nearest":
        out = fetch(torch.round(cy).long(), torch.round(cx).long())
        return out.reshape(b, ho, wo, c)
    y0 = torch.floor(cy)
    x0 = torch.floor(cx)
    wy = (cy - y0)[..., None]
    wx = (cx - x0)[..., None]
    y0, x0 = y0.long(), x0.long()
    if not flat.is_floating_point():
        flat = flat.float()
    top = fetch(y0, x0) * (1 - wx) + fetch(y0, x0 + 1) * wx
    bot = fetch(y0 + 1, x0) * (1 - wx) + fetch(y0 + 1, x0 + 1) * wx
    return (top * (1 - wy) + bot * wy).reshape(b, ho, wo, c)


def batched_warp(images: torch.Tensor, masks: torch.Tensor,
                 coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample coordinate fields applied to images (bilinear) and masks
    (nearest). images (B,H,W,3), masks (B,H,W), coords (B,H,W,2)."""
    return (grid_sample(images, coords, "linear"),
            grid_sample(masks[..., None], coords, "nearest")[..., 0])


def _resample(x: torch.Tensor, src: torch.Tensor, method: str,
              axis: int) -> torch.Tensor:
    """Per-sample 1-D resample of x (B, H, W, C) along `axis` (1 or 2) at
    float source positions src (B, n_out). Linear: the two neighbouring
    taps, weights renormalised over the taps inside the axis (the JAX
    interpolation matrix's clipped support; a position a whole pixel or
    more outside reads 0). Nearest: the rounded position, clipped."""
    n = x.shape[axis]
    shape = [x.shape[0], 1, 1, 1]
    shape[axis] = src.shape[1]

    def take(i):
        i = i.reshape(shape).expand(
            *(src.shape[1] if d == axis else x.shape[d] for d in range(4)))
        return torch.gather(x, axis, i)

    if method == "nearest":
        return take(torch.clamp(torch.round(src), 0, n - 1).long())
    i0 = torch.floor(src)
    f = src - i0
    i0 = i0.long()
    w0 = torch.where((i0 >= 0) & (i0 < n), 1.0 - f, 0.0)
    w1 = torch.where((i0 + 1 >= 0) & (i0 + 1 < n), f, 0.0)
    norm = torch.clamp(w0 + w1, min=1e-6)
    w0, w1 = (w0 / norm).reshape(shape), (w1 / norm).reshape(shape)
    return (take(torch.clamp(i0, 0, n - 1)) * w0
            + take(torch.clamp(i0 + 1, 0, n - 1)) * w1)


def resample_rows(x, src, method: str = "linear"):
    """`resample_rows_matmul`: resample along axis 1 at src (B, H_out)."""
    return _resample(x, src, method, 1)


def resample_cols(x, src, method: str = "linear"):
    """`resample_cols_matmul`: resample along axis 2 at src (B, W_out)."""
    return _resample(x, src, method, 2)


def base_grid(h: int, w: int, device=None) -> torch.Tensor:
    """Identity coordinate field (H, W, 2) in (y, x) order."""
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([yy, xx], dim=-1)


# ----------------------------------------------------------------------------
# Coordinate-field builders: per-sample params (leading B axis) ->
# (B, H, W, 2) source coordinates for the output grid.
# ----------------------------------------------------------------------------


def rotation_coords(h: int, w: int, angles_deg: torch.Tensor) -> torch.Tensor:
    """Rotation about the image centre (`A.Rotate(limit=15)`): output pixel
    p maps to source R(-theta)(p - c) + c."""
    g = base_grid(h, w, angles_deg.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th = -angles_deg * math.pi / 180.0
    cos, sin = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    dy, dx = g[..., 0] - cy, g[..., 1] - cx
    return torch.stack([cy + dy * cos - dx * sin, cx + dy * sin + dx * cos],
                       dim=-1)


def solve_h(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Homographies (B, 3, 3), h22 = 1, mapping dst -> src corners: src
    and dst (B, 4, 2) in (y, x), by the 8x8 DLT solve of `warp.py`."""
    rows = []
    for k in range(4):
        X, Y = dst[:, k, 1], dst[:, k, 0]
        u, v = src[:, k, 1], src[:, k, 0]
        z, o = torch.zeros_like(X), torch.ones_like(X)
        rows.append(torch.stack([X, Y, o, z, z, z, -u * X, -u * Y], -1))
        rows.append(torch.stack([z, z, z, X, Y, o, -v * X, -v * Y], -1))
    a = torch.stack(rows, 1)
    rhs = torch.stack([t for k in range(4) for t in
                       (src[:, k, 1], src[:, k, 0])], 1)
    sol = torch.linalg.solve(a, rhs)
    return torch.cat([sol, torch.ones_like(sol[:, :1])], 1).reshape(-1, 3, 3)


def homography_coords(h: int, w: int, hm: torch.Tensor) -> torch.Tensor:
    """Source coordinates q = H (x, y, 1) of every output pixel, in hm's
    dtype, returned in float32; hm (B, 3, 3) maps output (x, y) to source
    (x, y)."""
    g = base_grid(h, w, hm.device).to(hm.dtype)
    pts = torch.stack([g[..., 1], g[..., 0], torch.ones_like(g[..., 0])], -1)
    q = torch.einsum("hwk,bjk->bhwj", pts, hm)
    return torch.stack([q[..., 1] / q[..., 2], q[..., 0] / q[..., 2]],
                       -1).float()


def perspective_coords(h: int, w: int,
                       corner_jitter: torch.Tensor) -> torch.Tensor:
    """Random projective warp (`A.Perspective(scale=(0.05, 0.1))`): the
    four source corners are jittered by `corner_jitter` (B, 4, 2) in (y, x)
    pixels; the homography mapping output corners to jittered source
    corners is fit per sample."""
    dst = host_to(torch.tensor([[0.0, 0.0], [0.0, w - 1.0], [h - 1.0, 0.0],
                                [h - 1.0, w - 1.0]]), corner_jitter.device)
    dst = dst.expand(corner_jitter.shape[0], 4, 2)
    return homography_coords(h, w, solve_h(dst + corner_jitter, dst))


def optical_coords(h: int, w: int, k: torch.Tensor) -> torch.Tensor:
    """Barrel/pincushion radial distortion
    (`A.OpticalDistortion(distort_limit=0.3)`): the source radius scales by
    (1 + k r^2) / (1 + k), r normalised to the half-diagonal."""
    g = base_grid(h, w, k.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dy, dx = g[..., 0] - cy, g[..., 1] - cx
    r2 = (dy * dy + dx * dx) / ((cy * cy + cx * cx) + 1e-8)
    kk = k[:, None, None]
    scale = (1.0 + kk * r2) / (1.0 + kk)
    return torch.stack([cy + dy * scale, cx + dx * scale], dim=-1)


def grid_axis_map(stretch: torch.Tensor, n: int) -> torch.Tensor:
    """One axis of `A.GridDistortion`: per-cell stretch factors (B, steps)
    -> the monotone piecewise-linear source positions (B, n)."""
    steps = stretch.shape[-1]
    widths = stretch / stretch.sum(-1, keepdim=True)
    bounds = torch.cat([torch.zeros_like(widths[:, :1]),
                        torch.cumsum(widths, -1)], -1) * (n - 1.0)
    t = torch.arange(n, dtype=torch.float32, device=stretch.device) / (
        n - 1.0) * steps
    i0 = torch.clamp(torch.floor(t).long(), 0, steps - 1)
    frac = t - i0
    lo, hi = bounds[:, i0], bounds[:, i0 + 1]
    return lo + (hi - lo) * frac


def axis_maps_coords(ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Separable source positions ys (B, H), xs (B, W) -> (B, H, W, 2)."""
    b, h, w = ys.shape[0], ys.shape[1], xs.shape[1]
    return torch.stack([ys[:, :, None].expand(b, h, w),
                        xs[:, None, :].expand(b, h, w)], -1)


def grid_distortion_coords(h: int, w: int, stretch_y: torch.Tensor,
                           stretch_x: torch.Tensor) -> torch.Tensor:
    """Separable piecewise-linear axis remap
    (`A.GridDistortion(num_steps=6, distort_limit=0.3)`); stretch_* are
    per-sample per-cell factors (B, steps)."""
    return axis_maps_coords(grid_axis_map(stretch_y, h),
                            grid_axis_map(stretch_x, w))


def elastic_coords(h: int, w: int, noise: torch.Tensor) -> torch.Tensor:
    """Elastic displacement (`A.ElasticTransform(alpha=1, sigma=25)`):
    low-resolution noise (B, gh, gw, 2), already scaled by alpha,
    upsampled bilinearly with half-pixel centres and edge clamping (as
    `jax.image.resize(..., "linear")` and `cv2.resize`), added to the
    identity grid."""
    disp = F.interpolate(noise.permute(0, 3, 1, 2), size=(h, w),
                         mode="bilinear", align_corners=False)
    return base_grid(h, w, noise.device)[None] + disp.permute(0, 2, 3, 1)


def elastic_grid(h: int, w: int, sigma: float = 25.0) -> Tuple[int, int]:
    """The low-resolution noise grid of the elastic transform."""
    return max(2, int(round(h / sigma))), max(2, int(round(w / sigma)))


# ----------------------------------------------------------------------------
# The training loader's geometry, drawn on the host, applied here
# ----------------------------------------------------------------------------


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _resize_axis(n_out: int, starts: torch.Tensor, sizes: torch.Tensor,
                 method: str) -> torch.Tensor:
    """Source positions of a cv2.resize of each sample's [start, start +
    size) span to n_out pixels: linear with half-pixel centres clamped
    into the span (INTER_LINEAR), nearest by floor(j * size / n_out)
    (INTER_NEAREST)."""
    j = torch.arange(n_out, dtype=torch.float64, device=starts.device)[None]
    scale = sizes.double()[:, None] / n_out
    if method == "nearest":
        src = torch.minimum(torch.floor(j * scale), sizes[:, None] - 1.0)
    else:
        src = torch.clamp((j + 0.5) * scale - 0.5, min=0.0)
        src = torch.minimum(src, sizes[:, None] - 1.0)
    return (src + starts[:, None]).float()


def _crop(images, masks, boxes: torch.Tensor):
    """RandomResizedCrop of each sample's box (y0, x0, ch, cw) back to the
    full canvas. The spans lie inside the image, so no border applies."""
    s = images.shape[1]
    y0, x0, ch, cw = boxes.unbind(1)
    ys, xs = _resize_axis(s, y0, ch, "linear"), _resize_axis(s, x0, cw, "linear")
    img = resample_cols(resample_rows(images.float(), ys), xs)
    ys_n = _resize_axis(s, y0, ch, "nearest")
    xs_n = _resize_axis(s, x0, cw, "nearest")
    m = resample_cols(resample_rows(masks[..., None], ys_n, "nearest"),
                      xs_n, "nearest")[..., 0]
    return _round_u8(img), m


def _affine_rotation_coords(h: int, w: int, angles: torch.Tensor):
    """cv2.warpAffine by getRotationMatrix2D(((w-1)/2, (h-1)/2), angle, 1):
    the inverse map of a counter-clockwise rotation by `angle` degrees."""
    g = base_grid(h, w, angles.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    th = angles.double() * math.pi / 180.0
    a = torch.cos(th).float()[:, None, None]
    b = torch.sin(th).float()[:, None, None]
    dy, dx = g[..., 0] - cy, g[..., 1] - cx
    return torch.stack([cy + b * dx + a * dy, cx + a * dx - b * dy], -1)


def _warp_u8(images, masks, coords):
    img, m = batched_warp(images.float(), masks, coords)
    return _round_u8(img), m


def _subset(fn, images, masks, idx: List[int], *args):
    """Run fn on the samples `idx` and write them back."""
    if not idx:
        return images, masks
    i = host_to(torch.tensor(idx), images.device)
    img, m = fn(images.index_select(0, i), masks.index_select(0, i), *args)
    return images.index_copy(0, i, img), masks.index_copy(0, i, m)


def apply_host_geometry(images: torch.Tensor, masks: torch.Tensor,
                        geometry: Sequence[Optional[Dict]]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the loader's per-sample geometry (one dict or None per
    sample; `s3od_torch.training.data.draw_host_geometry`) to uint8 images
    (B, S, S, 3) and masks (B, S, S) on their device: the crop, then the
    rotation, then the distortion, each only on the samples that drew it.
    Returns uint8 images and masks of the input dtype."""
    if not any(geometry):
        return images, masks
    h, w = images.shape[1], images.shape[2]
    dev = images.device
    geo = [g or {} for g in geometry]

    crop = [i for i, g in enumerate(geo) if g.get("crop") is not None]
    if crop:
        boxes = host_to(torch.tensor([geo[i]["crop"] for i in crop]), dev)
        images, masks = _subset(_crop, images, masks, crop, boxes)

    rot = [i for i, g in enumerate(geo) if g.get("angle") is not None]
    if rot:
        ang = host_to(torch.tensor([geo[i]["angle"] for i in rot],
                                   dtype=torch.float64), dev)
        images, masks = _subset(
            lambda im, m: _warp_u8(im, m, _affine_rotation_coords(h, w, ang)),
            images, masks, rot)

    kinds = {}
    for i, g in enumerate(geo):
        if g.get("distort") is not None:
            kinds.setdefault(g["distort"][0], []).append(i)
    for kind, idx in kinds.items():
        params = [geo[i]["distort"][1] for i in idx]
        if kind == "optical":
            k = host_to(torch.tensor(params, dtype=torch.float32), dev)
            make = lambda: optical_coords(h, w, k)
        elif kind == "grid":
            ys = host_to(torch.from_numpy(np.stack([p[0] for p in params])), dev)
            xs = host_to(torch.from_numpy(np.stack([p[1] for p in params])), dev)
            make = lambda: axis_maps_coords(ys, xs)
        elif kind == "elastic":
            noise = host_to(torch.from_numpy(np.stack(params)), dev)
            make = lambda: elastic_coords(h, w, noise)
        elif kind == "perspective":
            hm = host_to(torch.from_numpy(np.stack(params)).double(), dev)
            make = lambda: homography_coords(h, w, hm)
        else:
            raise ValueError(f"unknown distortion {kind!r}")
        images, masks = _subset(
            lambda im, m: _warp_u8(im, m, make()), images, masks, idx)
    return images, masks

