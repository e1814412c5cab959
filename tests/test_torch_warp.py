"""s3od_torch.ops.warp against s3od_tpu.ops.warp on the CPU, on the same
seeded numpy inputs.

Tolerances (float32): coordinate fields 1e-4 px (the same formulas; the
perspective fit is an 8x8 float32 solve, 2e-3 px); sampled values 1e-5
of the [0, 1] range (bilinear sums in another order). Nearest samples are
equal except where a coordinate lies within float rounding of a tie.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from s3od_tpu.ops import warp as JW
from s3od_torch.ops import warp as W


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _coords(rng, b, h, w, spread):
    """Source coordinates around the identity, reaching `spread` pixels
    outside the image on every side."""
    g = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), -1)
    jitter = rng.uniform(-spread, spread, (b, h, w, 2))
    return (g[None] + jitter).astype(np.float32)


@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_grid_sample_matches_jax_with_reflect101_borders(method):
    rng = np.random.default_rng(0)
    img = rng.random((3, 17, 23, 3)).astype(np.float32)
    coords = _coords(rng, 3, 17, 23, 30.0)  # well past one period
    ref = np.stack([np.asarray(JW.grid_sample(jnp.asarray(i), jnp.asarray(c),
                                              method))
                    for i, c in zip(img, coords)])
    got = W.grid_sample(_t(img), _t(coords), method).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_torch_grid_sample_reflection_is_reflect101_for_bilinear():
    """F.grid_sample(padding_mode="reflection", align_corners=True)
    reflects a coordinate about the centre of the border pixel, which is
    cv2's BORDER_REFLECT_101 for bilinear sampling: it equals the gather
    form within float rounding (the port keeps the gather, which is exact
    in its index arithmetic)."""
    rng = np.random.default_rng(1)
    h, w = 19, 26
    img = rng.random((2, h, w, 3)).astype(np.float32)
    coords = _coords(rng, 2, h, w, 8.0)  # within one period of the border
    ours = W.grid_sample(_t(img), _t(coords), "linear")
    grid = torch.stack([_t(coords)[..., 1] / (w - 1) * 2 - 1,
                        _t(coords)[..., 0] / (h - 1) * 2 - 1], -1)
    theirs = F.grid_sample(_t(img).permute(0, 3, 1, 2), grid, mode="bilinear",
                           padding_mode="reflection", align_corners=True)
    np.testing.assert_allclose(theirs.permute(0, 2, 3, 1).numpy(),
                               ours.numpy(), atol=2e-5)


def test_batched_warp_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    mask = (rng.random((2, 16, 16)) > 0.5).astype(np.float32)
    coords = _coords(rng, 2, 16, 16, 5.0)
    ri, rm = JW.batched_warp(jnp.asarray(img), jnp.asarray(mask),
                             jnp.asarray(coords))
    gi, gm = W.batched_warp(_t(img), _t(mask), _t(coords))
    np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=1e-5)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("method", ["linear", "nearest"])
@pytest.mark.parametrize("axis", [1, 2])
def test_axis_resamplers_match_the_matmul_forms(method, axis):
    """Including positions under a pixel outside (clipped support,
    renormalised) and a whole pixel or more outside (zero)."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 12, 14, 3)).astype(np.float32)
    n = x.shape[axis]
    src = rng.uniform(-1.8, n + 0.8, (2, 9)).astype(np.float32)
    jfn = JW.resample_rows_matmul if axis == 1 else JW.resample_cols_matmul
    tfn = W.resample_rows if axis == 1 else W.resample_cols
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(src), method))
    got = tfn(_t(x), _t(src), method).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_coordinate_builders_match_jax():
    rng = np.random.default_rng(4)
    h, w, b = 21, 30, 3
    ang = rng.uniform(-15, 15, b).astype(np.float32)
    np.testing.assert_allclose(W.rotation_coords(h, w, _t(ang)).numpy(),
                               np.asarray(JW.rotation_coords(h, w, jnp.asarray(ang))),
                               atol=1e-4)
    k = rng.uniform(-0.3, 0.3, b).astype(np.float32)
    np.testing.assert_allclose(W.optical_coords(h, w, _t(k)).numpy(),
                               np.asarray(JW.optical_coords(h, w, jnp.asarray(k))),
                               atol=1e-4)
    sy = (1 + rng.uniform(-0.3, 0.3, (b, 6))).astype(np.float32)
    sx = (1 + rng.uniform(-0.3, 0.3, (b, 6))).astype(np.float32)
    np.testing.assert_allclose(
        W.grid_distortion_coords(h, w, _t(sy), _t(sx)).numpy(),
        np.asarray(JW.grid_distortion_coords(h, w, jnp.asarray(sy),
                                             jnp.asarray(sx))), atol=1e-4)
    jit = (rng.standard_normal((b, 4, 2)) * 0.08 * np.array([h, w])
           ).astype(np.float32)
    np.testing.assert_allclose(
        W.perspective_coords(h, w, _t(jit)).numpy(),
        np.asarray(JW.perspective_coords(h, w, jnp.asarray(jit))), atol=2e-3)


@pytest.mark.parametrize("hw", [(64, 64), (50, 37)])
def test_elastic_coords_match_jax_resize_at_the_edges(hw):
    """`jax.image.resize(..., "linear")` upsampling = F.interpolate
    bilinear, half-pixel centres, clamped at the edges: checked on every
    output pixel, the border rows and columns included."""
    h, w = hw
    key = jax.random.key(5)
    gh, gw = W.elastic_grid(h, w)
    ref = np.asarray(JW.elastic_coords(h, w, key, 2, 1.0, 25.0))
    noise = np.asarray(jax.random.normal(key, (2, gh, gw, 2)))
    got = W.elastic_coords(h, w, _t(noise)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got[:, [0, -1]], ref[:, [0, -1]], atol=1e-5)
    np.testing.assert_allclose(got[:, :, [0, -1]], ref[:, :, [0, -1]],
                               atol=1e-5)
