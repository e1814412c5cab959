"""s3od_torch.ops.augment against s3od_tpu.ops.augment on the CPU.

Each test reproduces the JAX op's draws from the same key, with the same
`jax.random` calls on the same splits, hands them to the port's
deterministic `<op>(x, params)`, and compares with the JAX op on the same
numpy inputs. The whole pipeline is compared the same way: a plan built
from `augment_batch`'s own key splits goes through `apply_augment`.
Eager JAX ops only, 64^2 canvases (and one non-div8 size).

Tolerances (float32, values in [0, 1]): 2e-5 for the elementwise ops
(the same formulas); 1e-4 for the blurs and the DCT (sums of 169 or 64
products in another order). CLAHE: 1e-2, because the JAX op rounds its
tile LUTs to bf16 for the one-hot matmul (one bf16 rounding of a LUT
value in [0, 1] is 2^-9, times the luma ratio), while the port keeps
float32; with those matmuls in float32 (the `clahe_fp32` fixture, used
by the pipeline tests too) 2e-5. JPEG rounds its DCT coefficients and
the pipelines floor (posterize, pixelate), so a last-bit difference
could flip a level; none does on these seeds: JPEG's largest difference
reads 2.4e-7 and the pipelines' 9.8e-6 (over 14 pipeline runs, mean
differences 2e-9 to 1e-7), held at 2e-5 and 1.5e-5.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_tpu.ops import augment as JA
from s3od_torch.ops import augment as A

B = 4
S = 64


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _img(seed, b=B, h=S, w=S):
    return np.random.default_rng(seed).random((b, h, w, 3)).astype(np.float32)


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=0)


@pytest.fixture
def clahe_fp32(monkeypatch):
    """The JAX module with bf16 read as float32: its CLAHE then runs the
    one-hot matmuls in float32 (no other op of the module names bf16)."""
    proxy = types.SimpleNamespace(**vars(jnp))
    proxy.bfloat16 = jnp.float32
    monkeypatch.setattr(JA, "jnp", proxy)


# ----------------------------------------------------------------------------
# JAX draws -> the port's parameters
# ----------------------------------------------------------------------------

def _u(key, b, lo, hi, shape=()):
    return np.asarray(JA._u(key, b, lo, hi, shape))


def j_color_jitter(key, b, br=0.5, co=0.5, sa=0.2, hu=0.2):
    kb, kc, ks, kh = jax.random.split(key, 4)
    return {"fb": _u(kb, b, 1 - br, 1 + br), "fc": _u(kc, b, 1 - co, 1 + co),
            "fs": _u(ks, b, 1 - sa, 1 + sa), "fh": _u(kh, b, -hu, hu)}


def j_hsv(key, b):
    kh, ks, kv = jax.random.split(key, 3)
    return {"dh": _u(kh, b, -25.0, 25.0) / 180.0,
            "ds": _u(ks, b, -35.0, 35.0) / 255.0,
            "dv": _u(kv, b, -30.0, 30.0) / 255.0}


def j_gauss(key, b, h, w, std_range=(0.2, 0.44)):
    ks, kn = jax.random.split(key)
    return {"std": _u(ks, b, *std_range) * np.float32(0.1),
            "noise": np.asarray(jax.random.normal(kn, (b, h, w, 3)))}


def j_iso(key, b, h, w):
    ki, kc, kl, kh = jax.random.split(key, 4)
    return {"inten": _u(ki, b, 0.08, 0.3), "cshift": _u(kc, b, 0.01, 0.03),
            "lum": np.asarray(jax.random.normal(kl, (b, h, w, 1))),
            "hue": np.asarray(jax.random.normal(kh, (b, h, w)))}


def j_mult(key, b):
    f = jax.random.uniform(key, (b, 1, 1, 1), minval=0.9, maxval=1.1)
    return {"f": np.asarray(f).reshape(b)}


def j_jpeg(key, b):
    return {"q": _u(key, b, 30, 80)}


def j_pixelate(key, b):
    return {"s": _u(key, b, 0.4, 0.7)}


def j_shadow(key, b, h, w):
    kn, kc, ka, ks = jax.random.split(key, 4)
    f = jax.random.fold_in
    return {"n": np.asarray(jax.random.randint(kn, (b,), 1, 4)),
            "cy": _u(f(kc, 0), b, 0.1 * h, 1.0 * h, (3,)),
            "cx": _u(f(kc, 1), b, 0.0 * w, 1.0 * w, (3,)),
            "ang": _u(ka, b, 0.0, jnp.pi, (3,)),
            "hh": _u(f(ks, 0), b, 0.08 * h, 0.35 * h, (3,)),
            "ww": _u(f(ks, 1), b, 0.08 * w, 0.35 * w, (3,))}


def j_brightness_contrast(key, b):
    kb, kc = jax.random.split(key)
    return {"alpha": 1.0 + _u(kc, b, -0.4, 0.4), "beta": _u(kb, b, -0.4, 0.4)}


def j_blur(key, b, weights=(0.4, 0.4, 0.3, 0.2)):
    """-> (choice, {branch: full-batch params})."""
    keys = jax.random.split(key, 6)
    f = jax.random.fold_in
    choice = np.asarray(JA._one_of(keys[0], b, list(weights)))
    return choice, {
        0: {"angle": _u(f(keys[2], 0), b, 0.0, jnp.pi),
            "length": _u(f(keys[2], 1), b, 3.0, 7.0)},
        1: {"ksize": _u(keys[1], b, 3.0, 7.0)},
        2: {"radius": _u(f(keys[3], 0), b, 2.0, 6.0),
            "alias": _u(f(keys[3], 1), b, 0.1, 0.3)},
        3: {"zf": _u(keys[4], b, 1.0, 1.03)},
    }


def j_shuffle(key, b):
    perms = jax.vmap(lambda k: jax.random.permutation(k, 3))(
        jax.random.split(key, b))
    return {"perm": np.asarray(perms)}


def j_sharpen(key, b, alpha=(0.2, 0.5), lightness=(0.5, 1.0)):
    ka, kl = jax.random.split(key)
    return {"a": _u(ka, b, *alpha), "l": _u(kl, b, *lightness)}


def j_emboss(key, b):
    ka, ks = jax.random.split(key)
    return {"a": _u(ka, b, 0.2, 0.4), "s": _u(ks, b, 0.2, 0.5)}


def j_snow(key, b):
    return {"sp": _u(key, b, 0.1, 0.3)}


def j_rain(key, b, h, w):
    kseed, ks = jax.random.split(key)
    seeds = jax.random.uniform(kseed, (b, h, w)) < 1.0 / 600.0
    return {"seeds": np.asarray(seeds).astype(np.float32),
            "pick": np.asarray(jax.random.randint(ks, (b,), 0, 5))}


def j_flips(key, b):
    kh, kv, kr, kr2 = jax.random.split(key, 4)
    return {"h": np.asarray(JA._gate(kh, b, 0.5)),
            "v": np.asarray(JA._gate(kv, b, 0.2)),
            "rot": np.asarray(JA._gate(kr, b, 0.2)),
            "k": np.asarray(jax.random.randint(kr2, (b,), 1, 4))}


def j_geometric(key, b, h, w, mode):
    keys = jax.random.split(key, 10)
    p = {"distort": np.full((b,), -1)}
    if mode == "synthetic":
        choice = np.asarray(JA._one_of(keys[0], b, [0.30, 0.30, 0.20, 0.15]))
        gd = np.asarray(JA._gate(keys[1], b, 0.4))
        p["distort"] = np.where(gd, choice, -1)
        p["k_opt"] = _u(keys[2], b, -0.3, 0.3)
        p["sy"] = 1.0 + _u(keys[3], b, -0.3, 0.3, (6,))
        p["sx"] = 1.0 + _u(keys[4], b, -0.3, 0.3, (6,))
        gh, gw = max(2, int(round(h / 25.0))), max(2, int(round(w / 25.0)))
        p["elastic"] = np.asarray(jax.random.normal(keys[5], (b, gh, gw, 2)))
        ps = JA._u(keys[6], b, 0.05, 0.1)
        p["jitter"] = np.asarray(jax.random.normal(keys[7], (b, 4, 2)) * (
            ps[:, None, None] * jnp.asarray([h, w], jnp.float32)))
    gr = np.asarray(JA._gate(keys[8], b, 0.2))
    p["angle"] = np.where(gr, _u(keys[9], b, -15.0, 15.0), 0.0)
    return p


def _tp(p):
    out = {}
    for k, v in p.items():
        v = np.asarray(v)
        out[k] = torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu"
                                  else v.astype(bool) if v.dtype == bool
                                  else v.astype(np.float32))
    return out


def _select(p, idx):
    return {k: v[idx] for k, v in _tp(p).items()}


# ----------------------------------------------------------------------------
# Per-op
# ----------------------------------------------------------------------------

def _op_cases():
    h = w = S
    return {
        "color_jitter": (lambda k, x: JA.color_jitter(k, x),
                         lambda k: j_color_jitter(k, B), A.color_jitter, 2e-5),
        "color_jitter_synth": (
            lambda k, x: JA.color_jitter(k, x, 0.4, 0.4, 0.3, 0.2),
            lambda k: j_color_jitter(k, B, 0.4, 0.4, 0.3, 0.2),
            A.color_jitter, 2e-5),
        "hsv": (JA.hue_saturation_value, lambda k: j_hsv(k, B),
                A.hue_saturation_value, 2e-5),
        "gauss": (lambda k, x: JA.gauss_noise(k, x, (0.25, 0.6)),
                  lambda k: j_gauss(k, B, h, w, (0.25, 0.6)), A.gauss_noise,
                  2e-5),
        "iso": (JA.iso_noise, lambda k: j_iso(k, B, h, w), A.iso_noise, 2e-5),
        "mult": (JA.multiplicative_noise, lambda k: j_mult(k, B),
                 A.multiplicative_noise, 2e-5),
        "pixelate": (JA.pixelate, lambda k: j_pixelate(k, B), A.pixelate, 2e-5),
        "shadow": (JA.random_shadow, lambda k: j_shadow(k, B, h, w),
                   A.random_shadow, 2e-5),
        "brightness_contrast": (JA.random_brightness_contrast,
                                lambda k: j_brightness_contrast(k, B),
                                A.random_brightness_contrast, 2e-5),
        "shuffle": (JA.channel_shuffle, lambda k: j_shuffle(k, B),
                    A.channel_shuffle, 0.0),
        "sharpen": (lambda k, x: JA.sharpen(k, x, (0.2, 0.6), (0.5, 1.2)),
                    lambda k: j_sharpen(k, B, (0.2, 0.6), (0.5, 1.2)),
                    A.sharpen, 2e-5),
        "emboss": (JA.emboss, lambda k: j_emboss(k, B), A.emboss, 2e-5),
        "snow": (JA.random_snow, lambda k: j_snow(k, B), A.random_snow, 2e-5),
        "rain": (JA.random_rain, lambda k: j_rain(k, B, h, w), A.random_rain,
                 2e-5),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_op_matches_jax_on_its_draws(name):
    jop, jdraw, op, atol = _op_cases()[name]
    x = _img(sum(map(ord, name)))
    key = jax.random.key(11)
    ref = np.asarray(jop(key, jnp.asarray(x)))
    got = op(_t(x), _tp(jdraw(key))).numpy()
    _close(got, ref, atol)


@pytest.mark.parametrize("name", ["sepia", "gray", "posterize", "clahe"])
def test_parameterless_op_matches_jax(name):
    x = _img(7)
    jop, op, atol = {"sepia": (JA.to_sepia, A.to_sepia, 2e-5),
                     "gray": (JA.to_gray, A.to_gray, 2e-5),
                     "posterize": (JA.posterize, A.posterize, 0.0),
                     "clahe": (JA.clahe, A.clahe, 1e-2)}[name]
    _close(op(_t(x)).numpy(), np.asarray(jop(jnp.asarray(x))), atol)


def test_clahe_matches_jax_with_its_matmuls_in_float32(clahe_fp32):
    """The whole gap to JAX's CLAHE is its bf16 rounding: with the one-hot
    matmuls in float32 the two agree to float32 rounding."""
    x = _img(7)
    _close(A.clahe(_t(x)).numpy(), np.asarray(JA.clahe(jnp.asarray(x))),
           2e-5)


def test_jpeg_matches_jax():
    x = _img(8)
    key = jax.random.key(12)
    ref = np.asarray(JA.jpeg_compression(key, jnp.asarray(x)))
    got = A.jpeg_compression(_t(x), _tp(j_jpeg(key, B))).numpy()
    _close(got, ref, 2e-5)


def test_blurs_match_jax_branch_by_branch():
    x = _img(9)
    key = jax.random.key(13)
    ref = np.asarray(JA.blur_one_of(key, jnp.asarray(x)))
    choice, params = j_blur(key, B)
    ops = [A.motion_blur, A.gaussian_blur, A.defocus, A.zoom_blur]
    got = np.empty_like(ref)
    for i in range(B):
        got[i] = ops[choice[i]](_t(x[i: i + 1]),
                                _select(params[choice[i]], [i]))[0].numpy()
    _close(got, ref, 1e-4)
    # every branch, whatever the draw picked
    for br, op in enumerate(ops):
        forced = np.asarray(JA.blur_one_of(key, jnp.asarray(x), tuple(
            1.0 if j == br else 1e-30 for j in range(4))))
        _close(op(_t(x), _tp(params[br])).numpy(), forced, 1e-4)


def test_flips_match_jax():
    x = _img(10, b=8)
    m = (np.random.default_rng(0).random((8, S, S)) > 0.5).astype(np.float32)
    key = jax.random.key(14)
    ri, rm = JA.random_flips(key, jnp.asarray(x), jnp.asarray(m))
    gi, gm = A.random_flips(_t(x), _t(m), _tp(j_flips(key, 8)))
    _close(gi.numpy(), ri, 0.0)
    _close(gm.numpy(), rm, 0.0)


@pytest.mark.parametrize("mode", ["regular", "synthetic"])
def test_geometric_warp_matches_jax(mode):
    x = _img(11, b=8)
    m = (np.random.default_rng(1).random((8, S, S)) > 0.5).astype(np.float32)
    key = jax.random.key(15)
    ri, rm = JA.geometric_warp(key, jnp.asarray(x), jnp.asarray(m), mode,
                               p_distort=0.4 if mode == "synthetic" else 0.0)
    p = _tp(j_geometric(key, 8, S, S, mode))
    gi, gm = A.geometric_warp(_t(x), _t(m), p)
    _close(gi.numpy(), ri, 1e-4)
    assert (gm.numpy() != np.asarray(rm)).mean() < 2e-3


def test_draws_follow_the_generator_and_the_stage_probabilities():
    """Same generator seed, same plan; another seed, another plan; gate
    and pick frequencies near their probabilities over many samples."""
    g = lambda s: torch.Generator().manual_seed(s)
    a = A.draw_augment(g(3), 16, S, S, "synthetic", "cpu")
    b = A.draw_augment(g(3), 16, S, S, "synthetic", "cpu")
    c = A.draw_augment(g(4), 16, S, S, "synthetic", "cpu")
    assert [s["branch"] for s in a["stages"]] == [s["branch"] for s in b["stages"]]
    assert [s["branch"] for s in a["stages"]] != [s["branch"] for s in c["stages"]]
    big = A.draw_augment(g(5), 4000, 8, 8, "synthetic", "cpu",
                         device_geometric=False)
    color = np.array(big["stages"][0]["branch"])
    assert abs((color >= 0).mean() - 0.7) < 0.03
    picked = color[color >= 0]
    np.testing.assert_allclose(np.bincount(picked, minlength=3) / len(picked),
                               np.array([0.7, 0.4, 0.2]) / 1.3, atol=0.03)
    for st in big["stages"]:
        for i, p in st["params"].items():
            n = st["branch"].count(i)
            assert all(v.shape[0] == n for v in p.values()), st["name"]


# ----------------------------------------------------------------------------
# Whole pipeline
# ----------------------------------------------------------------------------

def jax_plan(key, b, h, w, mode, device_geometric=True):
    """The plan `augment_batch(key, ...)` draws, in the port's format."""
    keys = jax.random.split(key, 24)
    div8 = h % 8 == 0 and w % 8 == 0
    plan = {"mode": mode, "flips": _tp(j_flips(keys[0], b)), "stages": []}
    if device_geometric:
        plan["geometric"] = _tp(j_geometric(keys[1], b, h, w, mode))

    def stage(name, kgate, p_gate, branch, full_params):
        gate = np.asarray(JA._gate(kgate, b, p_gate))
        branch = np.where(gate, branch, -1)
        params = {}
        for i, fp in enumerate(full_params):
            idx = np.nonzero(branch == i)[0]
            if len(idx):
                params[i] = _select(fp, idx)
        plan["stages"].append({"name": name, "branch": branch.tolist(),
                               "params": params})

    def pick(k, weights):
        return np.asarray(JA._one_of(k, b, weights))

    if mode == "regular":
        stage("color", keys[2], 0.5, pick(keys[3], [0.7, 0.3]),
              [j_color_jitter(keys[4], b), j_sharpen(keys[5], b)])
        stage("noise", keys[6], 0.3, pick(keys[7], [1.0, 1.0, 1.0]),
              [j_gauss(keys[8], b, h, w), j_iso(keys[9], b, h, w),
               j_mult(keys[10], b)])
        return plan
    hsv = j_hsv(keys[5], b)
    stage("color", keys[2], 0.7, pick(keys[3], [0.7, 0.4, 0.2]),
          [j_color_jitter(keys[4], b, 0.4, 0.4, 0.3, 0.2), hsv,
           {} if div8 else hsv])
    stage("noise", keys[6], 0.6, pick(keys[7], [0.4, 0.4, 0.4]),
          [j_iso(keys[8], b, h, w), j_gauss(keys[9], b, h, w, (0.25, 0.6)),
           j_mult(keys[10], b)])
    pix = j_pixelate(keys[14], b)
    stage("quality", keys[11], 0.5, pick(keys[12], [0.4, 0.3]),
          [j_jpeg(keys[13], b) if div8 else pix, pix])
    stage("lighting", keys[15], 0.5, pick(keys[16], [0.4, 0.4]),
          [j_shadow(keys[17], b, h, w), j_brightness_contrast(keys[18], b)])
    choice, blur = j_blur(keys[20], b)
    stage("blur", keys[19], 0.5, choice, [blur[i] for i in range(4)])
    kpick, kshuf = jax.random.split(keys[22])
    stage("colorspace", keys[21], 0.05, pick(kpick, [0.5, 0.5, 0.3]),
          [{}, {}, j_shuffle(kshuf, b)])
    sub = jax.random.split(keys[23], 8)
    stage("relief", sub[0], 0.3, pick(sub[1], [0.3, 0.3, 0.2]),
          [j_emboss(sub[2], b), j_sharpen(sub[3], b, (0.2, 0.6), (0.5, 1.2)),
           {}])
    stage("weather", sub[4], 0.15, pick(sub[5], [0.5, 0.5]),
          [j_snow(sub[6], b), j_rain(sub[7], b, h, w)])
    return plan


@pytest.mark.parametrize("mode,size", [("regular", 64), ("synthetic", 64),
                                       ("regular", 60), ("synthetic", 60)])
def test_augment_batch_matches_jax(mode, size, clahe_fp32):
    """b = 8; 64^2 (div8: CLAHE and JPEG run; three keys, so that most
    branches are taken) and 60^2 (their JAX substitutes, HSV and
    pixelate; one key)."""
    rng = np.random.default_rng(size)
    imgs = rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)
    masks = (rng.random((8, size, size)) > 0.5).astype(np.float32)
    taken = set()
    for seed in range(3 if size % 8 == 0 else 1):
        key = jax.random.key(100 + seed)
        ri, rm = JA.augment_batch(key, jnp.asarray(imgs), jnp.asarray(masks),
                                  mode)
        plan = jax_plan(key, 8, size, size, mode)
        gi, gm = A.apply_augment(_t(imgs, torch.uint8), _t(masks), plan)
        _close(gi.numpy(), ri, 1.5e-5)
        assert (gm.numpy() != np.asarray(rm)).mean() < 2e-3
        for st in plan["stages"]:
            taken |= {(st["name"], i) for i in st["params"]}
    if size % 8 == 0:
        assert len(taken) >= (4 if mode == "regular" else 12), sorted(taken)


def test_augment_batch_without_device_geometry_and_test_mode(clahe_fp32):
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (8, S, S, 3), dtype=np.uint8)
    masks = (rng.random((8, S, S)) > 0.5).astype(np.float32)
    key = jax.random.key(7)
    ri, rm = JA.augment_batch(key, jnp.asarray(imgs), jnp.asarray(masks),
                              "synthetic", device_geometric=False)
    plan = jax_plan(key, 8, S, S, "synthetic", device_geometric=False)
    gi, gm = A.apply_augment(_t(imgs, torch.uint8), _t(masks), plan)
    _close(gi.numpy(), ri, 1.5e-5)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))
    x, m = A.augment_batch(_t(imgs, torch.uint8), _t(masks), "test")
    _close(x.numpy(), imgs / np.float32(255.0), 0.0)
    with pytest.raises(ValueError, match="Generator"):
        A.augment_batch(_t(imgs, torch.uint8), _t(masks), "regular")


def test_normalize_imagenet_matches_jax():
    x = _img(12)
    _close(A.normalize_imagenet(_t(x)).numpy(),
           np.asarray(JA.normalize_imagenet(jnp.asarray(x))), 1e-6)
