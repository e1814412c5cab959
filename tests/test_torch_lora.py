"""s3od_torch's LoRA fine-tuning path against the JAX package on the CPU:
the attention gradients (K7's and K8's plain versions under the autograd
Function, against JAX's Pallas forward and backward in interpret mode) at
D = 128, the LoRA tree and its merge, one LoRA step's gradients, the AdamW
update, and the pipeline's `lora=`. Weights are seeded numpy (JAX's init,
carried across by `s3od_torch.convert`); the step's random draws are
JAX's, injected in place of the port's `torch.Generator` draws.

Tolerances: float32 compares the same math in another summation order —
relative 1e-4 (of max|JAX| per tensor, or of the norm over a tree) for a
gradient through a whole network, 1e-6 for one AdamW update of the same
gradients and for a merge; bf16: 2^-7 of max|JAX|, the bound of one
flipped bf16 rounding (ROADMAP, Queue 3, "A tolerance note").
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from s3od_torch.convert import tree_to_state_dict
from s3od_torch.datagen import lora as tl
from s3od_torch.ops import attention as xa
from s3od_torch.ops import flash_attention as fa


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))


def _tree_rel(got, ref):
    """||got - ref|| / ||ref|| over every leaf of two trees of the same
    structure."""
    g = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(got)]
    r = [np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(ref)]
    assert [a.shape for a in g] == [b.shape for b in r]
    g, r = np.concatenate(g), np.concatenate(r)
    return float(np.linalg.norm(g - r) / np.linalg.norm(r))


def _np_tree(tree):
    """A port LoRA tree (tensors) -> numpy leaves."""
    return jax.tree.map(lambda x: x.detach().float().numpy(), tree)


def _grads_tree(tree):
    return jax.tree.map(lambda x: x.grad.numpy(), tree)


# ----------------------------------------------------------------------------
# (i) K7 + K8 under autograd against JAX's Pallas kernels, D = 128
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("n_valid", [100, 83])
def test_flash_online_gradients_match_pallas_interpret(n_valid):
    """`multi_head_attention`'s flash route, differentiated: K7's plain
    forward and K8's plain backward under `_FlashAttentionOnline` (the
    sequence padded 100 -> 128, keys at or past n_valid masked), against
    `jax.grad` of JAX's `flash_attention` (online softmax, blocks of 64)
    in interpret mode, as `tests/test_ops.py:205-231` runs it at D = 64;
    the loss sums sin(o) over every row, the padded ones included."""
    from s3od_tpu.ops.flash_attention import flash_attention

    rng = np.random.default_rng(1)
    b, n, h, d = 1, 100, 2, 128
    q, k = (rng.standard_normal((b, n, h, d)).astype(np.float32) * 0.5
            for _ in range(2))
    v = rng.standard_normal((b, n, h, d)).astype(np.float32)

    ref = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(flash_attention(
        q, k, v, scale=d**-0.5, block_q=64, block_k=64, n_valid=n_valid,
        interpret=True))), argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    before = fa.flash_attention_bwd.launches
    o = xa.multi_head_attention(qt, kt, vt, impl="flash", n_valid=n_valid)
    torch.sin(o).sum().backward()
    assert fa.flash_attention_bwd.launches == before  # the plain version ran
    for got, r, name in zip((qt.grad, kt.grad, vt.grad), ref, "qkv"):
        assert _rel(got.numpy(), r) < 1e-4, f"d{name}"


def test_flash_online_autograd_saves_k7_lse_for_k8(monkeypatch):
    """The Function's backward gets K7's own lse and o: with the plain
    versions recorded, K8's plain version sees exactly what K7's returned,
    and the clamp min(s - lse, 0) changes nothing on an exact lse."""
    seen = {}
    real_bwd = fa.flash_attention_bwd

    def bwd(q, k, v, o, lse, g, n_valid):
        seen["bwd"] = (o, lse, n_valid)
        return real_bwd(q, k, v, o, lse, g, n_valid)

    monkeypatch.setattr(fa, "flash_attention_bwd", bwd)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 64, 128, generator=gen).requires_grad_()
               for _ in range(3))
    o = fa.flash_attention_online_autograd(q, k, v, 50)
    o.square().sum().backward()
    o_ref, lse_ref = fa.flash_attention_online_plain(q.detach(), k.detach(),
                                                     v.detach(), 50)
    so, slse, nv = seen["bwd"]
    assert nv == 50 and torch.equal(so, o_ref) and torch.equal(slse, lse_ref)
    s = torch.einsum("bnd,bmd->bnm", q.detach(), k.detach())[..., :50]
    assert float((s - lse_ref[..., None]).max()) <= 0.0


# ----------------------------------------------------------------------------
# The tiny MMDiT on both sides
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    from s3od_tpu.models.mmdit import init_mmdit_params, tiny_mmdit_config
    from s3od_torch.models import mmdit as tm

    params = jax.tree.map(np.asarray, init_mmdit_params(
        jax.random.key(0), tiny_mmdit_config()))
    cfg = tm.tiny_mmdit_config()
    model = tm.MMDiT(cfg)
    model.load_state_dict(tree_to_state_dict(params), strict=True)
    return cfg, params, model.eval()


def _port_model(tiny, dtype=torch.float32):
    """A fresh copy of the tiny model (the step freezes its base)."""
    from s3od_torch.models import mmdit as tm

    cfg, params, _ = tiny
    model = tm.MMDiT(cfg)
    model.load_state_dict(tree_to_state_dict(params), strict=True)
    return model.to(dtype).eval()


def _jax_lora(params, rank=4, seed=2, b_scale=0.0):
    """JAX's LoRA tree; B drawn N(0, b_scale) where b_scale > 0 (at init
    B = 0, which makes dA exactly zero)."""
    from s3od_tpu.datagen.lora import LoRAConfig, init_lora_params

    lora = jax.tree.map(np.asarray, init_lora_params(
        jax.random.key(seed), params, LoRAConfig(rank=rank)))
    if b_scale:
        rng = np.random.default_rng(seed)
        lora = jax.tree_util.tree_map_with_path(
            lambda p, x: (rng.standard_normal(x.shape).astype(np.float32)
                          * b_scale if p[-1].key == "B" else x), lora)
    return lora


def _port_lora(jlora):
    return jax.tree.map(lambda x: _t(x).requires_grad_(), jlora)


# ----------------------------------------------------------------------------
# (ii) the LoRA tree and the merge
# ----------------------------------------------------------------------------


def test_init_lora_params_mirrors_the_jax_tree(tiny):
    """Nested by path segment, as the JAX tree (never "/"-joined keys):
    the same structure and shapes; A ~ N(0, 1) / r, B = 0, fp32 leaves
    that require grad; with JAX's draws injected, JAX's values exactly."""
    from s3od_tpu.datagen.lora import LoRAConfig, init_lora_params

    cfg, params, model = tiny
    lcfg = tl.LoRAConfig(rank=4)
    got = tl.init_lora_params(torch.Generator().manual_seed(0), model, lcfg)
    ref = init_lora_params(jax.random.key(0), params, LoRAConfig(rank=4))
    assert (jax.tree.structure(_np_tree(got)) == jax.tree.structure(ref))
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert tuple(g.shape) == r.shape
        assert g.dtype == torch.float32 and g.requires_grad and g.is_leaf
    a = torch.cat([x.detach().ravel() for x in tl.lora_parameters(got)[::2]])
    assert abs(float(a.std()) * 4 - 1.0) < 0.05 and abs(float(a.mean())) < 0.01
    assert all(float(x.detach().abs().max()) == 0.0
               for x in tl.lora_parameters(got)[1::2])
    assert set(got["dual_blocks"][0]) == {"img_attn", "txt_attn"}
    assert set(got["single_blocks"][0]) == {"qkv", "proj_out"}

    keys = iter(jax.random.split(jax.random.key(0), 4096))
    draws = lambda gen, shape: _t(jax.random.normal(next(keys), shape, jnp.float32))
    tl_normal = tl.lora_normal
    try:
        tl.lora_normal = draws
        same = tl.init_lora_params(torch.Generator(), model, lcfg)
    finally:
        tl.lora_normal = tl_normal
    for g, r in zip(jax.tree.leaves(_np_tree(same)), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(g, np.asarray(r))


@pytest.mark.parametrize("base", ["float32", "bfloat16"])
def test_merge_lora_matches_jax(tiny, base):
    """W + (scale A @ B) rounded to W's dtype, the delta transposed into the
    (out, in) weight; every targeted linear, nothing else, the module
    untouched. fp32: 1e-6 of max|W|; bf16: the delta is rounded into bf16
    on both sides, within one bf16 step (2^-7 of max|W|) and all but a
    few entries equal."""
    from s3od_tpu.datagen.lora import LoRAConfig, merge_lora

    cfg, params, _ = tiny
    jdt, tdt = (jnp.float32, torch.float32) if base == "float32" else (
        jnp.bfloat16, torch.bfloat16)
    model = _port_model(tiny, tdt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jlora = _jax_lora(params, b_scale=0.05)
    ref = merge_lora(jax.tree.map(lambda x: jnp.asarray(x, jdt), params),
                     jlora, LoRAConfig(rank=4, alpha=8.0))
    got = tl.merge_lora(model, _port_lora(jlora), tl.LoRAConfig(rank=4, alpha=8.0))
    assert len(got) == 4 * cfg.num_dual_blocks + 2 * cfg.num_single_blocks
    for name, w in got.items():
        r = ref
        for p in name.split(".")[:-1]:
            r = r[int(p)] if p.isdigit() else r[p]
        r = np.asarray(jnp.asarray(r["kernel"], jnp.float32)).T
        g = w.detach().float().numpy()
        assert w.dtype == tdt and g.shape == r.shape
        if base == "float32":
            assert _rel(g, r) < 1e-6, name
        else:
            assert _rel(g, r) <= 2.0**-7, name
            assert np.mean(g != r) < 0.01, name
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


# ----------------------------------------------------------------------------
# (iii) one LoRA step's gradients
# ----------------------------------------------------------------------------


def _batch(cfg, ph=4, pw=6, n_txt=8, seed=0):
    from s3od_torch.datagen.diffusion import make_img_ids

    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"latents": f(1, ph * pw, cfg.in_channels),
            "txt": f(1, n_txt, cfg.text_dim), "pooled": f(1, cfg.pooled_dim),
            "img_ids": make_img_ids(ph, pw),
            "txt_ids": np.zeros((n_txt, 3), np.float32)}


def _jax_draws(seed, x0_shape):
    """JAX's t and noise of `make_lora_train_step`'s loss for rng key(seed)."""
    r1, r2 = jax.random.split(jax.random.key(seed))
    t = jax.nn.sigmoid(jax.random.normal(r1, (x0_shape[0],)))
    noise = jax.random.normal(r2, x0_shape, jnp.float32)
    return _t(t), _t(noise)


def _inject_draws(monkeypatch, seeds, x0_shape):
    """The port's step draws, in turn, JAX's t and noise for each seed."""
    draws = [_jax_draws(s, x0_shape) for s in seeds]
    state = {"t": iter(d[0] for d in draws), "noise": iter(d[1] for d in draws)}
    monkeypatch.setattr(tl, "draw_timesteps", lambda gen, b: next(state["t"]))
    monkeypatch.setattr(tl, "draw_noise", lambda gen, x0: next(state["noise"]))


def _grab():
    """An optax transformation that returns the gradients as its state and
    updates nothing: JAX's step then hands back its gradients."""
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("impl,dtype", [("xla", "float32"), ("flash", "float32"),
                                        ("xla", "bfloat16")])
def test_lora_step_gradients_match_jax(tiny, impl, dtype, monkeypatch):
    """`make_lora_train_step`'s gradients of the LoRA tree (B nonzero, so
    dA is too) against JAX's step on the same weights, batch and draws.
    Both sides compute in `dtype` on an fp32 base; "flash" forces the flash
    route on both (JAX's Pallas forward and backward in interpret mode,
    the port's K7 and K8 plain versions under the autograd Function).
    bf16: the loss and the tree's relative norm within 2^-7; a gradient
    is a chain of dozens of bf16 roundings (six blocks forward and back),
    not one, so each leaf's max error is held to 2^-6 (1.2e-2 measured on
    the leaves whose gradients are ~1e-3 of the largest)."""
    import s3od_tpu.models.mmdit as jm
    from s3od_tpu.datagen.lora import LoRAConfig, make_lora_train_step
    from s3od_tpu.ops import flash_attention as jfa

    cfg, params, _ = tiny
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    if impl == "flash":
        monkeypatch.setattr(jfa, "flash_attention", functools.partial(
            jfa.flash_attention, interpret=True))
    monkeypatch.setattr(jm, "mmdit_forward", functools.partial(
        jm.mmdit_forward, compute_dtype=jdt, attn_impl=impl))
    jlora = _jax_lora(params, b_scale=0.05)
    batch = _batch(cfg)
    step = make_lora_train_step(cfg, LoRAConfig(rank=4), _grab())
    _, jgrads, jloss = step(jlora, jax.tree.map(jnp.zeros_like, jlora),
                            jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, batch), jax.random.key(3))

    _inject_draws(monkeypatch, [3], batch["latents"].shape)
    model = _port_model(tiny)
    lora = _port_lora(jlora)
    tstep = tl.make_lora_train_step(
        model, tl.LoRAConfig(rank=4),
        torch.optim.SGD(tl.lora_parameters(lora), lr=0.0),
        compute_dtype=tdt, attn_impl=impl)
    loss = tstep(lora, {k: _t(v) for k, v in batch.items()}, torch.Generator())
    got = _grads_tree(lora)
    assert not any(p.requires_grad for p in model.parameters())
    if dtype == "float32":
        assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
        assert _tree_rel(got, jgrads) < 1e-4
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(jgrads)):
            assert _rel(g, r) < 1e-4
    else:
        assert abs(float(loss) - float(jloss)) <= 2.0**-7 * abs(float(jloss))
        assert _tree_rel(got, jgrads) <= 2.0**-7
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(jgrads)):
            assert _rel(g, r) <= 2.0**-6


def test_lora_step_with_remat_matches_the_step_without(tiny):
    """`remat=True` recomputes each block in the backward, the merge
    inside the recomputed function: the loss and every LoRA gradient are
    those of the step without it, bit for bit on the CPU, and K7's plain
    forward (not counted) runs twice per block."""
    cfg, params, _ = tiny
    batch = {k: _t(v) for k, v in _batch(cfg).items()}
    grads = []
    for remat in (False, True):
        lora = _port_lora(_jax_lora(params, b_scale=0.05))
        step = tl.make_lora_train_step(
            _port_model(tiny), tl.LoRAConfig(rank=4),
            torch.optim.SGD(tl.lora_parameters(lora), lr=0.0),
            compute_dtype=torch.float32, attn_impl="flash", remat=remat)
        loss = step(lora, batch, torch.Generator().manual_seed(1))
        grads.append((loss, [p.grad for p in tl.lora_parameters(lora)]))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ----------------------------------------------------------------------------
# (iv) the optimizer
# ----------------------------------------------------------------------------


def test_lora_adamw_matches_optax():
    """`lora_optimizer` (torch AdamW with optax.adamw's defaults: weight
    decay 1e-4) and `optax.adamw(lr)` fed the same gradients, three
    updates: the parameters agree within 1e-6 relative."""
    import optax

    rng = np.random.default_rng(0)
    tree = {"dual_blocks": [{"img_attn": {"qkv": {
        "A": rng.standard_normal((12, 4)).astype(np.float32),
        "B": rng.standard_normal((4, 36)).astype(np.float32) * 0.1}}}]}
    opt = optax.adamw(1e-2)
    jparams = jax.tree.map(jnp.asarray, tree)
    state = opt.init(jparams)
    lora = _port_lora(tree)
    topt = tl.lora_optimizer(lora, 1e-2)
    assert topt.defaults["weight_decay"] == 1e-4
    for i in range(3):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32)
            * 10.0**-i, tree)
        updates, state = opt.update(jax.tree.map(jnp.asarray, grads), state,
                                    jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tl.lora_parameters(lora), tl.lora_parameters(
                jax.tree.map(_t, grads))):
            p.grad = g
        topt.step()
    for g, r in zip(jax.tree.leaves(_np_tree(lora)), jax.tree.leaves(jparams)):
        assert _rel(g, r) < 1e-6


# ----------------------------------------------------------------------------
# (vi) the pipeline's lora=
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_npz(tiny, tmp_path_factory):
    """A JAX-written adapter file (alpha 8 in the state, pack_order tag)."""
    from s3od_tpu.convert import save_native

    _, params, _ = tiny
    path = str(tmp_path_factory.mktemp("lora") / "lora.npz")
    save_native(path, _jax_lora(params, b_scale=0.05),
                {"alpha": np.float32(8.0), "rank": np.int32(4),
                 "pack_order": np.bytes_(b"diffusers_v1")})
    return path


def test_pipeline_lora_t2i_matches_jax(tiny, lora_npz, monkeypatch):
    """`ConceptAttentionPipeline(lora=path)`: alpha from the file's state,
    the merge once at load, 4 denoise steps with the concept stream on the
    last 3 against the JAX pipeline with the same file (JAX's noise
    injected); the base model is not changed."""
    from s3od_tpu.datagen.diffusion import ConceptAttentionPipeline as JPipe
    from s3od_tpu.models.mmdit import tiny_mmdit_config
    from s3od_torch.datagen import diffusion as td

    cfg, params, _ = tiny
    monkeypatch.setattr(td, "initial_noise", lambda seed, shape, device: _t(
        jax.random.normal(jax.random.key(seed), tuple(shape), jnp.float32)))
    model = _port_model(tiny)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jpipe = JPipe(params, tiny_mmdit_config(), text_encoders=None,
                  num_inference_steps=4, compute_dtype="float32",
                  lora=lora_npz)
    tpipe = td.ConceptAttentionPipeline(model, text_encoders=None,
                                        num_inference_steps=4, device="cpu",
                                        lora=lora_npz)
    rng = np.random.default_rng(0)
    kw = dict(height=64, width=64, seed=1, concepts=["fox", "background"],
              prompt_embeds=(rng.standard_normal((1, 8, cfg.text_dim))
                             .astype(np.float32),
                             rng.standard_normal((1, cfg.pooled_dim))
                             .astype(np.float32)),
              concept_embeds=rng.standard_normal((1, 2, cfg.text_dim))
              .astype(np.float32))
    ref, got = jpipe("a red fox", **kw), tpipe("a red fox", **kw)
    assert _rel(got.latents, ref.latents) < 1e-4
    for g, r in zip(got.features, ref.features):
        assert _rel(g, np.asarray(r, np.float32)) < 1e-4
    for name, m in got.concept_maps.items():
        assert np.abs(m - ref.concept_maps[name]).max() < 1e-4
    base = td.ConceptAttentionPipeline(model, text_encoders=None,
                                       num_inference_steps=4, device="cpu")
    assert _rel(base("a red fox", **kw).latents, got.latents) > 1e-3
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_read_lora_alpha_and_pack_order(tiny, lora_npz, tmp_path):
    """alpha as the JAX pipeline takes it: `lora_scale` when given, else
    the file's state, else 16 (not the rank); a pack_order other than
    diffusers_v1 raises ValueError; an untagged file warns; a tree loads
    as it is."""
    from s3od_tpu.convert import load_native, save_native

    tree, lcfg = tl.read_lora(lora_npz)
    assert lcfg == tl.LoRAConfig(rank=4, alpha=8.0) and lcfg.scale == 2.0
    assert tl.read_lora(lora_npz, lora_scale=3.0)[1].alpha == 3.0
    jtree, _ = load_native(lora_npz)
    assert tl.read_lora(jtree)[1] == tl.LoRAConfig(rank=4, alpha=16.0)
    assert tl.read_lora(jtree, lora_scale=3.0)[1].alpha == 3.0
    np.testing.assert_array_equal(
        tree["single_blocks"][1]["qkv"]["B"].numpy(),
        jtree["single_blocks"][1]["qkv"]["B"])
    bad = str(tmp_path / "bad.npz")
    save_native(bad, jtree, {"alpha": np.float32(8.0),
                             "pack_order": np.bytes_(b"legacy")})
    with pytest.raises(ValueError, match="pack_order"):
        tl.read_lora(bad)
    untagged = str(tmp_path / "untagged.npz")
    save_native(untagged, jtree, {"rank": np.int32(4)})
    with pytest.warns(UserWarning, match="pack_order"):
        assert tl.read_lora(untagged)[1].alpha == 16.0


def test_lora_modules_leave_jax_out_and_default_to_the_card(tmp_path):
    """`datagen.lora`, `flux_finetune` and `feature_extraction`, and a tiny
    LoRA step on the CPU, import neither jax nor triton nor any module of
    s3od_tpu; without a card, both CLIs refuse their default device."""
    import subprocess
    import sys
    from pathlib import Path

    import yaml

    code = (
        "import sys, torch\n"
        "import s3od_torch.datagen.feature_extraction, s3od_torch.datagen.flux_finetune\n"
        "from s3od_torch.datagen import lora as L\n"
        "from s3od_torch.datagen.diffusion import make_img_ids\n"
        "from s3od_torch.models.mmdit import init_mmdit, tiny_mmdit_config\n"
        "m = init_mmdit(tiny_mmdit_config(), torch.Generator().manual_seed(0))\n"
        "lora = L.init_lora_params(torch.Generator(), m, L.LoRAConfig(rank=2))\n"
        "step = L.make_lora_train_step(m, L.LoRAConfig(rank=2),"
        " L.lora_optimizer(lora, 1e-3), compute_dtype=torch.float32,"
        " attn_impl='flash')\n"
        "b = dict(latents=torch.randn(1, 16, 16), txt=torch.randn(1, 4, 64),"
        " pooled=torch.randn(1, 32), img_ids=torch.from_numpy(make_img_ids(4, 4)),"
        " txt_ids=torch.zeros(4, 3))\n"
        "assert torch.isfinite(step(lora, b, torch.Generator()))\n"
        "print([any(m.split('.')[0] == n for m in sys.modules)\n"
        "       for n in ('jax', 'triton', 's3od_tpu')])\n")
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[False,", "False,", "False]"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from s3od_torch.datagen import feature_extraction, flux_finetune

    conf = tmp_path / "c.yaml"
    conf.write_text(yaml.safe_dump({"flux_checkpoint": "x.npz", "output_dir":
                                    str(tmp_path), "vae_checkpoint": "v.npz"}))
    for run in (flux_finetune.run, feature_extraction.run):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(str(conf))


def test_k8_d128_shapes_harness_covers_every_shape():
    """The side-by-side build of K8's D = 128 designs instantiates each
    listed split shape (dkv warpgroups, dq warpgroups, overlap) once, the
    one D = 128 ran before the single pass among them, and each single-pass
    variant (ring stages, dQ mode) once, the entry point's (its stages,
    the reduce-adds) among them; one name a case; it needs a card to run."""
    from s3od_torch.experiments import k8_d128_shapes as ks

    src = ks.harness_source()
    assert '#include "flash_attention_bwd.cu"' in src
    for i, (kv, dq, ov) in enumerate(ks.SHAPES):
        assert (f"case {i}: return wg::launch_wgmma<128, {kv}, {dq}, "
                f"{str(ov).lower()}>") in src
    for i, (stages, mode) in enumerate(ks.FUSED):
        assert (f"case {len(ks.SHAPES) + i}: return wg::launch_fused<{stages}, "
                f"{ks.DQ_MODES[mode]}>") in src
    assert (2, 2, False) in ks.SHAPES
    assert (fa.BWD_FUSED_STAGES, "reduce") in ks.FUSED
    assert len(ks.variants()) == len(ks.SHAPES) + len(ks.FUSED)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ks.main([])
