"""Int8 weight residency in s3od_torch (`ops/quant.py`, `models/mmdit.py`'s
`QuantLinear`, `convert`'s `kernel_q` trees) against the JAX package's
`s3od_tpu/ops/quant.py` on the CPU.

Tolerances: quantization and dequantization are elementwise, so bit-equal
(int8 codes, fp32 scales, the fp32 dequantized kernel); the tiny MMDiT
forward on the same int8 tree is the same math in another summation
order: 1e-5 relative norm in float32 (`test_torch_mmdit.py`'s 1e-4 of
max|JAX| for the whole forward, here by norm).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_torch.ops import quant


def _rel_norm(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-12))


@pytest.mark.parametrize("shape,seed", [((384, 512), 0), ((300, 260), 2),
                                        ((256, 3072), 5)])
def test_quantize_kernel_is_bit_equal_to_jax(shape, seed):
    from s3od_tpu.ops import quant as jq

    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.02
    w[:, 3] = 0.0  # a zero column: the 1e-12 floor of the scale
    q, s = quant.quantize_kernel_int8(w)
    qr, sr = jq.quantize_kernel_int8(w)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, np.asarray(qr))
    np.testing.assert_array_equal(s, np.asarray(sr))
    # the dequantization, in the JAX order, bit-equal in fp32 (and bf16)
    p = {"kernel_q": q, "kernel_scale": s}
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16)):
        got = quant.dequant_kernel(p, tdt).float().numpy()
        ref = np.asarray(jq.dequant_kernel(
            {"kernel_q": qr, "kernel_scale": sr}, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, ref)
        # the module layout's (dout, din) weight is its transpose, exactly
        w_t = quant.dequant_weight(torch.from_numpy(q.T.copy()),
                                   torch.from_numpy(s), tdt).float().numpy()
        np.testing.assert_array_equal(w_t, ref.T)


def test_quantize_tree_matches_jax_keys_and_leaves():
    from s3od_tpu.ops import quant as jq

    rng = np.random.default_rng(1)
    big = {
        "blocks": [
            {"qkv": {"kernel": rng.standard_normal((512, 1536)).astype(
                np.float32), "bias": np.zeros((1536,), np.float32)},
             "qk_norm": {"q": np.ones((64,), np.float32)}}],
        "proj_out": {"kernel": np.zeros((512, 16), np.float32)},
    }
    got, ref = quant.quantize_tree_int8(big), jq.quantize_tree_int8(big)
    assert (jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, ref)))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert "kernel" not in got["blocks"][0]["qkv"]
    assert "kernel" in got["proj_out"]  # dout 16 < MIN_QUANT_DIM
    assert quant.tree_bytes(got) == jq.tree_bytes(ref)
    assert quant.tree_bytes(got) < 0.3 * quant.tree_bytes(big)


@pytest.fixture(scope="module")
def quantized_tiny():
    """The JAX tiny MMDiT, quantized by JAX with MIN_QUANT_DIM lowered to
    32 (the JAX test's patch) and by the port under the same patch."""
    from s3od_tpu.models.mmdit import init_mmdit_params, tiny_mmdit_config
    from s3od_tpu.ops import quant as jq

    params = jax.tree.map(np.asarray, init_mmdit_params(
        jax.random.key(0), tiny_mmdit_config()))
    old = (jq.MIN_QUANT_DIM, quant.MIN_QUANT_DIM)
    jq.MIN_QUANT_DIM = quant.MIN_QUANT_DIM = 32
    try:
        ref = jax.tree.map(np.asarray, jq.quantize_tree_int8(params))
        got = quant.quantize_tree_int8(params)
    finally:
        jq.MIN_QUANT_DIM, quant.MIN_QUANT_DIM = old
    return params, ref, got


def _inputs(cfg):
    from s3od_torch.datagen.diffusion import make_img_ids

    rng = np.random.default_rng(1)
    ph, pw = 4, 6
    return dict(
        latents=rng.standard_normal((1, ph * pw, cfg.in_channels)).astype(
            np.float32),
        txt=rng.standard_normal((1, 8, cfg.text_dim)).astype(np.float32),
        pooled=rng.standard_normal((1, cfg.pooled_dim)).astype(np.float32),
        timestep=np.full((1,), 0.7, np.float32),
        img_ids=make_img_ids(ph, pw), txt_ids=np.zeros((8, 3), np.float32),
        guidance=np.full((1,), 3.5, np.float32))


def test_quantized_tiny_mmdit_forward_matches_jax(quantized_tiny, tmp_path):
    """The port's MMDiT on the int8 tree (loaded from the `.npz` the JAX
    package writes, every eligible linear a `QuantLinear`) against the JAX
    `mmdit_forward` on the same tree: float32, 1e-5 relative norm. Both
    track the float model as the JAX test bounds it (5e-2)."""
    from s3od_tpu.convert import save_native as jax_save
    from s3od_tpu.models.mmdit import mmdit_forward
    from s3od_torch.convert import load_mmdit
    from s3od_torch.models.mmdit import QuantLinear, tiny_mmdit_config

    params, ref_tree, got_tree = quantized_tiny
    for a, b in zip(jax.tree.leaves(got_tree), jax.tree.leaves(ref_tree)):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "q.npz")
    jax_save(path, jax.tree.map(jnp.asarray, ref_tree), None)
    cfg = tiny_mmdit_config()
    model = load_mmdit(path, cfg)
    n_q = sum(isinstance(m, QuantLinear) for m in model.modules())
    assert n_q == sum(1 for _ in _kernel_q_nodes(ref_tree)) > 30
    assert model.dual_blocks[0].img_attn.qkv.weight_q.dtype == torch.int8

    inp = _inputs(cfg)
    kw = {k: jnp.asarray(v) for k, v in inp.items()}
    ref = np.asarray(mmdit_forward(jax.tree.map(jnp.asarray, ref_tree), cfg,
                                   compute_dtype=jnp.float32, attn_impl="xla",
                                   **kw)["output"])
    with torch.no_grad():
        got = model(compute_dtype=torch.float32, attn_impl="xla",
                    **{k: torch.from_numpy(np.asarray(v)) for k, v in
                       inp.items()})["output"].numpy()
    assert _rel_norm(got, ref) < 1e-5
    dense = np.asarray(mmdit_forward(jax.tree.map(jnp.asarray, params), cfg,
                                     compute_dtype=jnp.float32,
                                     attn_impl="xla", **kw)["output"])
    assert _rel_norm(got, dense) < 5e-2


def _kernel_q_nodes(tree):
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            yield tree
        for v in tree.values():
            yield from _kernel_q_nodes(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _kernel_q_nodes(v)


def test_quantized_npz_round_trip(quantized_tiny, tmp_path):
    """An int8 tree through `load_mmdit` -> `save_factory_npz` -> the JAX
    `load_native` and the port's `load_mmdit` again: every leaf and dtype
    kept, the configuration stored beside it."""
    from s3od_tpu.convert import load_native as jax_load
    from s3od_torch.convert import load_mmdit, save_factory_npz, save_native
    from s3od_torch.models.mmdit import tiny_mmdit_config

    _, ref_tree, _ = quantized_tiny
    cfg = tiny_mmdit_config()
    save_native(str(tmp_path / "a.npz"), ref_tree)
    model = load_mmdit(str(tmp_path / "a.npz"), cfg)
    save_factory_npz(str(tmp_path / "b.npz"), model, cfg)
    back, meta = jax_load(str(tmp_path / "b.npz"))
    assert (jax.tree.structure(jax.tree.map(np.asarray, back))
            == jax.tree.structure(ref_tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_tree)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    again = load_mmdit(str(tmp_path / "b.npz"))  # config from the file
    assert again.cfg == cfg
    for (k, v), (k2, v2) in zip(model.state_dict().items(),
                                again.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)


def test_init_mmdit_int8_draws_the_jax_form(monkeypatch):
    """`init_mmdit(int8_weights=True)`: every eligible linear an int8
    `QuantLinear` (codes in [-127, 127], scale 0.02 / 127, bias 0), the
    rest float as before; resident bytes fall by ~4x against fp32."""
    from s3od_torch.models.mmdit import (
        QuantLinear,
        init_mmdit,
        tiny_mmdit_config,
    )

    monkeypatch.setattr(quant, "MIN_QUANT_DIM", 32)
    cfg = tiny_mmdit_config()
    gen = lambda: torch.Generator().manual_seed(0)
    q = init_mmdit(cfg, gen(), int8_weights=True)
    f = init_mmdit(cfg, gen())
    lin = q.single_blocks[0].mlp_in
    assert isinstance(lin, QuantLinear)
    assert lin.weight_q.dtype == torch.int8
    assert int(lin.weight_q.min()) == -127 and int(lin.weight_q.max()) == 127
    assert torch.all(lin.weight_scale == np.float32(0.02 / 127.0))
    assert float(lin.bias.abs().max()) == 0.0
    assert not isinstance(q.img_in, QuantLinear)  # in_channels 16 < 32
    size = lambda m: sum(t.numel() * t.element_size()
                         for t in list(m.parameters()) + list(m.buffers()))
    assert size(q) < 0.35 * size(f)
    # the forward runs on the int8 weights and stays finite
    inp = _inputs(cfg)
    with torch.no_grad():
        out = q(compute_dtype=torch.float32,
                **{k: torch.from_numpy(np.asarray(v)) for k, v in
                   inp.items()})["output"]
    assert torch.isfinite(out).all()


def test_quantize_mmdit_equals_the_quantized_tree(monkeypatch):
    """`quantize_mmdit` (the int8 form of a float model, made with torch
    ops on the model's device) holds the codes and scales of
    `quantize_tree_int8` on the model's tree, bit for bit, and leaves the
    source untouched."""
    from s3od_torch.convert import load_tree_, state_dict_to_tree
    from s3od_torch.models.mmdit import (
        MMDiT,
        init_mmdit,
        quantize_linears_,
        quantize_mmdit,
        tiny_mmdit_config,
    )

    monkeypatch.setattr(quant, "MIN_QUANT_DIM", 32)
    cfg = tiny_mmdit_config()
    model = init_mmdit(cfg, torch.Generator().manual_seed(4))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = quantize_mmdit(model)
    tree = quant.quantize_tree_int8(state_dict_to_tree(model.state_dict()))
    want = MMDiT(cfg)
    quantize_linears_(want, None)
    load_tree_(want, tree)
    assert got.state_dict().keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())
