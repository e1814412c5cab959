"""s3od_torch's MMDiT slice against the JAX package on the CPU: K7's plain
version against the Pallas flash forward in interpret mode, the attention
dispatch, the tiny MMDiT forward with and without the concept stream, and
the T5 / CLIP text encoders with the hash tokenizer. Inputs and weights
are seeded numpy, carried across by `s3od_torch.convert`.

Tolerances: float32 compares the same math in another summation order —
relative 1e-5 of max|JAX| for one op (attention, an encoder layer stack
counts as one chain of a few ops: 1e-5 holds), 1e-4 for the whole MMDiT
forward (57 ops deep at full size, 6 blocks here) and multi-step
pipelines. bf16: within one bf16 rounding of the output (2^-8 of its
largest magnitude).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_torch.convert import tree_to_state_dict, state_dict_to_tree
from s3od_torch.ops import attention as xa
from s3od_torch.ops import flash_attention as fa


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


# ----------------------------------------------------------------------------
# K7: the online-softmax flash forward
# ----------------------------------------------------------------------------


def _k7_case(d, n_valid, logit_scale, seed=8):
    """`tests/test_ops.py:968`'s shape (1, 200, 2, D); `logit_scale`
    stretches q so the logits reach well past +-40."""
    rng = np.random.default_rng(seed)
    b, n, h = 1, 200, 2
    q = rng.standard_normal((b, n, h, d)).astype(np.float32) * 0.5 * logit_scale
    k = rng.standard_normal((b, n, h, d)).astype(np.float32) * 0.5
    v = rng.standard_normal((b, n, h, d)).astype(np.float32)
    return q, k, v, n_valid


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("blocks", [(208, 208), (64, 64)])
@pytest.mark.parametrize("n_valid,logit_scale", [(200, 1.0), (170, 1.0),
                                                  (170, 40.0)])
def test_k7_plain_matches_pallas_interpret(d, blocks, n_valid, logit_scale):
    """Single-block (208/208: `_fwd_kernel_single`, row max) and streaming
    (64/64: `_fwd_kernel`, running max and rescale) against the port's
    dispatch, which pads to 256 and runs K7's plain version; n_valid < N
    masks keys; logit_scale 40 puts the logits at ~+-200."""
    from s3od_tpu.ops.flash_attention import _flash_forward, flash_attention

    q, k, v, n_valid = _k7_case(d, n_valid, logit_scale)
    b, n, h, _ = q.shape
    scale = d**-0.5
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=scale, block_q=blocks[0], block_k=blocks[1],
                          n_valid=n_valid, interpret=True)
    got = xa.multi_head_attention(_t(q), _t(k), _t(v), scale=scale,
                                  impl="flash", n_valid=n_valid)
    assert got.shape == (b, n, h, d)
    assert _rel(got.numpy(), ref) < 1e-5

    bhnd = lambda t: np.ascontiguousarray(
        t.transpose(0, 2, 1, 3).reshape(b * h, n, d))
    qs = bhnd(q * np.float32(scale))
    _, lse_ref = _flash_forward(
        jnp.asarray(qs), jnp.asarray(bhnd(k)), jnp.asarray(bhnd(v)), 1.0,
        blocks[0], blocks[1], n_valid, want_lse=True, interpret=True)
    _, lse = fa.flash_attention_online(_t(qs), _t(bhnd(k)), _t(bhnd(v)),
                                       n_valid)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0],
                               rtol=1e-6, atol=2e-5)


def test_k7_bf16_scale_fold_and_output():
    """bf16: q is scaled IN bf16 before the kernel (D = 128's scale is not
    a power of two, so the rounding is real) exactly as JAX folds it, and
    the output is within one bf16 rounding of the Pallas kernel's."""
    from s3od_tpu.ops.flash_attention import flash_attention

    q, k, v, n_valid = _k7_case(128, 180, 1.0, seed=3)
    scale = 128**-0.5
    bf = jnp.bfloat16
    jq = jnp.asarray(q).astype(bf)
    folded_ref = np.asarray((jq * jnp.asarray(scale, bf)).astype(jnp.float32))
    tq = _t(q, torch.bfloat16)
    folded = (tq * torch.tensor(scale, dtype=torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(folded, folded_ref)
    assert not np.array_equal(folded, (tq.float() * scale).numpy())

    ref = flash_attention(jq, jnp.asarray(k).astype(bf), jnp.asarray(v).astype(bf),
                          scale=scale, block_q=64, block_k=64, n_valid=n_valid,
                          interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    got = xa.multi_head_attention(tq, _t(k, torch.bfloat16),
                                  _t(v, torch.bfloat16), scale=scale,
                                  impl="flash", n_valid=n_valid)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 2.0**-8 * np.abs(ref).max()


def test_attention_dispatch_rule_and_xla_route():
    """The JAX rule: the flash kernel only for bf16 at N >= 1024; the
    exact route below it (probabilities rounded to v's dtype), matching
    `_xla_attention`."""
    from s3od_tpu.ops.attention import _xla_attention

    assert xa.resolve_attn_impl(1024, torch.bfloat16) == "flash"
    assert xa.resolve_attn_impl(1023, torch.bfloat16) == "xla"
    assert xa.resolve_attn_impl(4608, torch.float32) == "xla"
    assert xa.resolve_attn_impl(10, torch.float32, "flash") == "flash"
    with pytest.raises(ValueError):
        xa.resolve_attn_impl(10, torch.float32, "pallas")
    q, k, v, n_valid = _k7_case(64, 150, 1.0, seed=5)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5),
                         (torch.bfloat16, jnp.bfloat16, 2.0**-8)):
        ref = _xla_attention(jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
                             jnp.asarray(v).astype(jdt), 64**-0.5, n_valid)
        ref = np.asarray(ref.astype(jnp.float32))
        got = xa.multi_head_attention(_t(q, dt), _t(k, dt), _t(v, dt),
                                      n_valid=n_valid)
        assert got.dtype == dt
        assert _rel(got.float().numpy(), ref) <= tol


def test_k7_wrapper_gates():
    """CPU tensors take the plain version without counting; device tensors
    outside bf16 / D in {64, 128} / N % 64 / 0 < n_valid <= N raise before
    any launch ('meta' tensors need no card); an input that requires grad
    runs the forward and, through `flash_attention_online_autograd`, K8's
    backward (here both plain versions) into every input's gradient."""
    before = fa.flash_attention_online.launches
    q = torch.randn(2, 64, 128)
    o, lse = fa.flash_attention_online(q, q, q, 60)
    assert torch.equal(o, fa.flash_attention_online_plain(q, q, q, 60)[0])
    assert fa.flash_attention_online.launches == before
    m = lambda *s, dtype=torch.bfloat16: torch.empty(*s, dtype=dtype, device="meta")
    for args in ((m(2, 64, 32), m(2, 64, 32), m(2, 64, 32), 64),
                 (m(2, 100, 128), m(2, 100, 128), m(2, 100, 128), 100),
                 (m(2, 64, 128, dtype=torch.float32),) * 3 + (64,),
                 (m(2, 64, 128), m(2, 64, 128), m(2, 64, 128), 65),
                 (m(2, 64, 128), m(2, 128, 128), m(2, 64, 128), 64)):
        with pytest.raises(ValueError):
            fa.flash_attention_online(*args)
    g = torch.randn(1, 64, 64, requires_grad=True)
    o, _ = fa.flash_attention_online(g, g, g, 64)
    assert torch.equal(o, fa.flash_attention_online_plain(g, g, g, 64)[0])
    k, v = (torch.randn(1, 64, 64, requires_grad=True) for _ in range(2))
    fa.flash_attention_online_autograd(g, k, v, 50).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (g, k, v))
    assert float(k.grad[:, 50:].abs().max()) == 0.0  # masked keys
    assert fa.flash_attention_online.launches == before


# ----------------------------------------------------------------------------
# The MMDiT
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    from s3od_tpu.models.mmdit import init_mmdit_params, tiny_mmdit_config
    from s3od_torch.models import mmdit as tm

    params = jax.tree.map(np.asarray,
                          init_mmdit_params(jax.random.key(0),
                                            tiny_mmdit_config()))
    cfg = tm.tiny_mmdit_config()
    model = tm.MMDiT(cfg)
    model.load_state_dict(tree_to_state_dict(params), strict=True)
    return cfg, params, model.eval()


def _mmdit_inputs(cfg, ph=4, pw=6, n_txt=8, n_c=2, seed=0):
    from s3od_torch.datagen.diffusion import make_img_ids

    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(latents=f(1, ph * pw, cfg.in_channels),
                txt=f(1, n_txt, cfg.text_dim), pooled=f(1, cfg.pooled_dim),
                timestep=np.full((1,), 0.7, np.float32),
                img_ids=make_img_ids(ph, pw),
                txt_ids=np.zeros((n_txt, 3), np.float32),
                guidance=np.full((1,), 3.5, np.float32),
                concepts=f(1, n_c, cfg.text_dim),
                pooled_concepts=f(1, cfg.pooled_dim))


@pytest.mark.parametrize("with_concepts", [False, True])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_mmdit_forward_matches_jax(tiny, with_concepts, impl, monkeypatch):
    """Velocity, the feature taps, the per-layer concept maps and the final
    dual-block streams, float32. impl "flash" forces the flash route on
    both sides (JAX's Pallas kernel in interpret mode, the port's K7
    dispatch with padding to 64) at this short sequence."""
    import functools

    from s3od_tpu.models.mmdit import mmdit_forward
    from s3od_tpu.ops import flash_attention as jfa

    cfg, params, model = tiny
    if impl == "flash":
        monkeypatch.setattr(jfa, "flash_attention",
                            functools.partial(jfa.flash_attention,
                                              interpret=True))
    inp = _mmdit_inputs(cfg)
    if not with_concepts:
        inp.pop("concepts"), inp.pop("pooled_concepts")
    ref = mmdit_forward(jax.tree.map(jnp.asarray, params), cfg,
                        compute_dtype=jnp.float32, attn_impl=impl,
                        concept_layers=(1,),
                        **{k: jnp.asarray(v) for k, v in inp.items()})
    with torch.no_grad():
        got = model(compute_dtype=torch.float32, attn_impl=impl,
                    concept_layers=(1,), **{k: _t(v) for k, v in inp.items()})
    assert _rel(got["output"].numpy(), ref["output"]) < 1e-4
    assert len(got["features"]) == len(cfg.feature_taps)
    for g, r in zip(got["features"], ref["features"]):
        assert _rel(g.numpy(), r) < 1e-4
    if with_concepts:
        assert got["concept_maps"].shape == (1, 1, 2, 24)
        assert _rel(got["concept_maps"].numpy(), ref["concept_maps"]) < 1e-4
        assert _rel(got["concept_out"].numpy(), ref["concept_out"]) < 1e-4
    else:
        assert got["concept_maps"] is None and ref["concept_maps"] is None
    assert _rel(got["image_out"].numpy(), ref["image_out"]) < 1e-4


def test_mmdit_tree_roundtrip_and_init(tiny):
    """Port state dict -> JAX tree -> state dict is the identity, the tree
    has the JAX init's structure, and the seeded init follows its scheme
    (weights N(0, 0.02), biases 0, q/k norms 1)."""
    from s3od_torch.models.mmdit import init_mmdit

    cfg, params, model = tiny
    tree = state_dict_to_tree(model.state_dict())
    assert (jax.tree.structure(tree) == jax.tree.structure(params))
    sd = tree_to_state_dict(tree)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    m = init_mmdit(cfg, torch.Generator().manual_seed(3))
    w = m.dual_blocks[0].img_attn.qkv.weight.detach()
    assert abs(float(w.std()) - 0.02) < 2e-3
    assert float(m.dual_blocks[0].img_attn.qkv.bias.abs().max()) == 0.0
    assert float(m.single_blocks[1].qk_norm.k.min()) == 1.0


def test_mmdit_rope_and_primitives_match_jax():
    from s3od_tpu.models import mmdit as jm
    from s3od_torch.models import mmdit as tm
    from s3od_torch.datagen.diffusion import make_img_ids

    ids = np.concatenate([np.zeros((5, 3), np.float32), make_img_ids(16, 12)])
    cos_r, sin_r = jm.rope_from_ids(jnp.asarray(ids), (16, 56, 56), 10000.0)
    cos, sin = tm.rope_from_ids(_t(ids), (16, 56, 56), 10000.0)
    assert np.abs(cos.numpy() - np.asarray(cos_r)).max() < 1e-5
    assert np.abs(sin.numpy() - np.asarray(sin_r)).max() < 1e-5
    t = np.array([0.3, 1.0], np.float32)
    # arguments up to 1000 rad, where one fp32 ulp of the argument is 6e-5
    np.testing.assert_allclose(tm.timestep_embedding(_t(t), 256).numpy(),
                               jm.timestep_embedding(jnp.asarray(t), 256),
                               atol=1e-4)
    rng = np.random.default_rng(0)
    q, k = (rng.standard_normal((1, 197, 2, 128)).astype(np.float32)
            for _ in range(2))
    ref = jm.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_r, sin_r)
    got = tm.apply_rope(_t(q), _t(k), cos, sin)
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) < 1e-5
    maps = rng.random((2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(tm.minmax_normalize(_t(maps)).numpy(),
                               jm.minmax_normalize(jnp.asarray(maps)), atol=1e-6)


def test_int8_trees_raise_naming_the_queue():
    """Int8 trees are ported (`tests/test_torch_quant.py`): a `kernel_q` /
    `kernel_scale` node becomes a `QuantLinear`'s int8 `weight_q` (dout,
    din) and fp32 `weight_scale`, and comes back unchanged; nothing
    raises."""
    rng = np.random.default_rng(0)
    tree = {"img_in": {"kernel_q": rng.integers(-127, 128, (4, 6),
                                                dtype=np.int8),
                       "kernel_scale": rng.random(6).astype(np.float32)}}
    sd = tree_to_state_dict(tree)
    assert sd["img_in.weight_q"].dtype == torch.int8
    assert sd["img_in.weight_q"].shape == (6, 4)
    assert sd["img_in.weight_scale"].dtype == torch.float32
    back = state_dict_to_tree(sd)["img_in"]
    np.testing.assert_array_equal(back["kernel_q"], tree["img_in"]["kernel_q"])
    assert back["kernel_q"].dtype == np.int8
    np.testing.assert_array_equal(back["kernel_scale"],
                                  tree["img_in"]["kernel_scale"])


# ----------------------------------------------------------------------------
# Text encoders
# ----------------------------------------------------------------------------


def _tiny_text_cfgs():
    from s3od_tpu.models import text_encoders as jt
    from s3od_torch.models import text_encoders as tt

    t5 = dict(vocab_size=300, d_model=64, d_kv=16, d_ff=96, num_layers=2,
              num_heads=4, relative_attention_num_buckets=32,
              relative_attention_max_distance=128)
    clip = dict(vocab_size=400, hidden_size=128, intermediate_size=192,
                num_layers=2, num_heads=2, max_position_embeddings=77)
    return ((jt.T5Config(**t5), tt.T5Config(**t5)),
            (jt.CLIPTextConfig(**clip), tt.CLIPTextConfig(**clip)))


@pytest.fixture(scope="module")
def text_encoders():
    from s3od_tpu.datagen.text_encoding import JaxTextEncoders
    from s3od_tpu.models import text_encoders as jt
    from s3od_torch.datagen.text_encoding import TorchTextEncoders
    from s3od_torch.models import text_encoders as tt

    (jt5, tt5), (jclip, tclip) = _tiny_text_cfgs()
    t5p = jax.tree.map(np.asarray, jt.init_t5_params(jax.random.key(1), jt5))
    clipp = jax.tree.map(np.asarray,
                         jt.init_clip_text_params(jax.random.key(2), jclip))
    jax_enc = JaxTextEncoders(t5p, clipp, jt5, jclip, max_t5_tokens=40,
                              compute_dtype="float32")
    t5 = tt.T5Encoder(tt5)
    t5.load_state_dict(tree_to_state_dict(t5p), strict=True)
    clip = tt.CLIPTextEncoder(tclip)
    clip.load_state_dict(tree_to_state_dict(clipp), strict=True)
    port = TorchTextEncoders(t5, clip, max_t5_tokens=40, device="cpu")
    return jax_enc, port


PROMPTS = ["a photograph of a tabby cat in its natural environment, sharp "
           "details, bright daylight, deep depth of field, multiple objects "
           "and overlapping elements on textured surfaces", "a red fox"]


def test_hash_tokenizer_ids_are_the_jax_ids(text_encoders):
    jax_enc, port = text_encoders
    for got, ref in zip(port._tok_t5(PROMPTS, 40), jax_enc._tok_t5(PROMPTS, 40)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(port._tok_clip(PROMPTS),
                                  jax_enc._tok_clip(PROMPTS))


def test_t5_relative_position_buckets_match_jax():
    from s3od_tpu.models.text_encoders import t5_relative_position_bucket as jb
    from s3od_torch.models.text_encoders import t5_relative_position_bucket as tb

    rel = np.arange(-600, 601)
    np.testing.assert_array_equal(tb(torch.from_numpy(rel), 32, 128).numpy(),
                                  np.asarray(jb(jnp.asarray(rel), 32, 128)))


def test_text_encoders_match_jax(text_encoders):
    """encode (T5 sequence + CLIP pooled, with the padding mask and the
    hash tokenizer) and encode_concepts (first T5 token per concept, the
    joined concepts' CLIP pool), float32."""
    jax_enc, port = text_encoders
    for got, ref in zip(port.encode(PROMPTS), jax_enc.encode(PROMPTS)):
        assert got.shape == ref.shape
        assert _rel(got, ref) < 1e-5
    concepts = ["tabby cat", "background"]
    for got, ref in zip(port.encode_concepts(concepts),
                        jax_enc.encode_concepts(concepts)):
        assert got.shape == ref.shape
        assert _rel(got, ref) < 1e-5


def test_text_encoder_inits_follow_the_jax_scheme():
    from s3od_torch.models import text_encoders as tt

    (_, t5c), (_, clipc) = _tiny_text_cfgs()
    g = torch.Generator().manual_seed(0)
    t5 = tt.init_t5(t5c, g)
    assert abs(float(t5.layers[0].attention.q.weight.std())
               - (64 * 16) ** -0.5) < 5e-3
    assert float(t5.final_layer_norm.min()) == 1.0
    assert t5.layers[0].attention.relative_attention_bias.shape == (32, 4)
    assert not hasattr(t5.layers[1].attention, "relative_attention_bias")
    clip = tt.init_clip_text(clipc, g)
    assert float(clip.layers[1].ln2.weight.min()) == 1.0
    assert float(clip.layers[1].attn.q.bias.abs().max()) == 0.0
