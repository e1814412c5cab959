"""`s3od_torch.datagen.convert_flux` against the JAX package's converter and
against the diffusers-layout stub modules of `tests/_diffusers_stubs.py`
(the diffusers key names, the FLUX semantics), on the CPU.

- The port's trees equal the JAX converter's exactly (structure, dtype,
  every leaf), for the transformer and the VAE.
- The port's MMDiT on its converted tree matches the JAX `mmdit_forward`
  on the JAX tree: float32, 1e-4 of max|JAX| (`test_torch_mmdit.py`).
- Against the stubs' own forwards (diffusers' math): the time / guidance
  / pooled embedding, a single-stream block, and the final
  `AdaLayerNormContinuous` whose [scale, shift] halves the converter
  swaps: 2e-4 absolute, the bound of `tests/test_full_mmdit_oracle.py`;
  the port's VAE encode and decode against `AutoencoderKL`: 2e-4
  absolute (`tests/test_vae_oracle.py`).
- The CLI on `.safetensors` files, read back by the port's loaders and
  the JAX `load_native`.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from tests._diffusers_stubs import (
    AdaLayerNormContinuous,
    AutoencoderKL,
    CombinedTimestepGuidanceTextProjEmbeddings,
    FluxSingleTransformerBlock,
    FluxTransformerBlock,
)

DIM, HEADS, HEAD_DIM = 64, 4, 16
AXES_DIMS = (4, 6, 6)
N_DUAL, N_SINGLE = 2, 3
IN_CH, TEXT_DIM, POOLED_DIM = 8, 32, 24
ORACLE_TOL = 2e-4


class _StubFlux(nn.Module):
    """A `FluxTransformer2DModel`'s state-dict layout from the stubs."""

    def __init__(self):
        super().__init__()
        self.x_embedder = nn.Linear(IN_CH, DIM)
        self.context_embedder = nn.Linear(TEXT_DIM, DIM)
        self.time_text_embed = CombinedTimestepGuidanceTextProjEmbeddings(
            DIM, POOLED_DIM)
        self.transformer_blocks = nn.ModuleList(
            FluxTransformerBlock(DIM, HEADS, HEAD_DIM) for _ in range(N_DUAL))
        self.single_transformer_blocks = nn.ModuleList(
            FluxSingleTransformerBlock(DIM, HEADS, HEAD_DIM)
            for _ in range(N_SINGLE))
        self.norm_out = AdaLayerNormContinuous(DIM, DIM)
        self.proj_out = nn.Linear(DIM, IN_CH)


def _perturbed(module, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn_like(p) * 0.05)
    return module.eval()


@pytest.fixture(scope="module")
def flux():
    from s3od_tpu.datagen.convert_flux import convert_flux_transformer as jconv
    from s3od_torch.datagen.convert_flux import convert_flux_transformer
    from s3od_torch.models.mmdit import MMDiTConfig

    stub = _perturbed(_StubFlux(), 0)
    sd = stub.state_dict()
    tree = convert_flux_transformer(sd)
    ref = jax.tree.map(np.asarray, jconv(sd))
    cfg = MMDiTConfig(hidden_size=DIM, num_heads=HEADS,
                      num_dual_blocks=N_DUAL, num_single_blocks=N_SINGLE,
                      text_dim=TEXT_DIM, pooled_dim=POOLED_DIM,
                      in_channels=IN_CH, axes_dims=AXES_DIMS,
                      feature_taps=(0, 2))
    return stub, sd, tree, ref, cfg


def test_transformer_tree_equals_jax(flux):
    _, _, tree, ref, cfg = flux
    assert jax.tree.structure(tree) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _port_model(tree, cfg):
    from s3od_torch.convert import load_tree_
    from s3od_torch.models.mmdit import MMDiT

    return load_tree_(MMDiT(cfg), tree).eval()


def test_converted_mmdit_matches_jax_forward(flux):
    from s3od_tpu.models.mmdit import MMDiTConfig as JCfg
    from s3od_tpu.models.mmdit import mmdit_forward
    from s3od_torch.datagen.diffusion import make_img_ids

    _, _, tree, ref_tree, cfg = flux
    model = _port_model(tree, cfg)
    jcfg = JCfg(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    rng = np.random.default_rng(3)
    ph, pw, n_txt = 4, 6, 5
    inp = dict(latents=rng.standard_normal((1, ph * pw, IN_CH)),
               txt=rng.standard_normal((1, n_txt, TEXT_DIM)),
               pooled=rng.standard_normal((1, POOLED_DIM)),
               timestep=np.full((1,), 0.6), img_ids=make_img_ids(ph, pw),
               txt_ids=np.zeros((n_txt, 3)), guidance=np.full((1,), 3.5))
    inp = {k: np.asarray(v, np.float32) for k, v in inp.items()}
    ref = mmdit_forward(jax.tree.map(jnp.asarray, ref_tree), jcfg,
                        compute_dtype=jnp.float32, attn_impl="xla",
                        **{k: jnp.asarray(v) for k, v in inp.items()})
    with torch.no_grad():
        got = model(compute_dtype=torch.float32, attn_impl="xla",
                    **{k: torch.from_numpy(v) for k, v in inp.items()})
    r = np.asarray(ref["output"])
    assert np.abs(got["output"].numpy() - r).max() <= 1e-4 * np.abs(r).max()
    for g, f in zip(got["features"], ref["features"]):
        f = np.asarray(f)
        assert np.abs(g.numpy() - f).max() <= 1e-4 * np.abs(f).max()


def test_converted_parts_match_the_diffusers_stubs(flux):
    """The embedding (diffusers feeds t x 1000 to its Timesteps), a single
    block (the stub's full forward with its own RoPE tables) and the final
    norm (the [scale, shift] swap) on the converted weights."""
    from s3od_torch.models import mmdit as tm
    from s3od_torch.datagen.diffusion import make_img_ids

    stub, _, tree, _, cfg = flux
    model = _port_model(tree, cfg)
    rng = np.random.default_rng(4)
    t = torch.tensor([0.6], dtype=torch.float32)
    g = torch.tensor([3.5], dtype=torch.float32)
    pooled = torch.from_numpy(rng.standard_normal((1, POOLED_DIM)).astype(
        np.float32))
    with torch.no_grad():
        want = stub.time_text_embed(t * 1000.0, g * 1000.0, pooled)
        cond = (model._embed(model.time_in, tm.timestep_embedding(t, 256))
                + model._embed(model.guidance_in,
                               tm.timestep_embedding(g, 256)))
        temb = cond + model._embed(model.vector_in, pooled)
    assert (temb - want).abs().max() < ORACLE_TOL

    ids = torch.from_numpy(make_img_ids(4, 6))
    x = torch.from_numpy(rng.standard_normal((1, 24, DIM)).astype(np.float32))
    cos, sin = tm.rope_from_ids(ids, AXES_DIMS, cfg.rope_theta)
    with torch.no_grad():
        want = stub.single_transformer_blocks[1](x, temb,
                                                 image_rotary_emb=(cos, sin))
        got = model.single_blocks[1](x, temb, (cos, sin), "xla")
        assert (got - want).abs().max() < ORACLE_TOL
        want = stub.proj_out(stub.norm_out(x, temb))
        shift, scale = tm._modulation(temb, model.final_mod, 2)
        got = tm._linear(tm._mod(x, shift, scale), model.proj_out)
    assert (got - want).abs().max() < ORACLE_TOL


@pytest.fixture(scope="module")
def vae():
    from s3od_tpu.datagen.convert_flux import convert_diffusers_vae as jconv
    from s3od_torch.datagen.convert_flux import convert_diffusers_vae
    from s3od_torch.models.vae import VAEConfig

    oracle = _perturbed(AutoencoderKL(block_out_channels=(32, 64),
                                      latent_channels=4, layers_per_block=2,
                                      norm_num_groups=16), 11)
    sd = oracle.state_dict()
    enc, dec = convert_diffusers_vae(sd)
    cfg = VAEConfig(latent_channels=4, base_channels=32, channel_mults=(1, 2),
                    layers_per_block=2, groups=16)
    return oracle, sd, (enc, dec), jax.tree.map(np.asarray, jconv(sd)), cfg


def test_vae_trees_equal_jax_and_match_the_oracle(vae):
    from s3od_torch.convert import load_tree_
    from s3od_torch.models.vae import VAEDecoder, VAEEncoder

    oracle, _, (enc, dec), (jenc, jdec), cfg = vae
    for got, ref in ((enc, jenc), (dec, jdec)):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)
    e = load_tree_(VAEEncoder(cfg), enc).eval()
    d = load_tree_(VAEDecoder(cfg), dec).eval()
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 3, 32, 48)).astype(np.float32)
    lat = rng.normal(0, 1, (2, 4, 4, 6)).astype(np.float32)
    with torch.no_grad():
        mean = oracle.encode_mean(torch.from_numpy(img))
        want = (mean - cfg.shift_factor) * cfg.scaling_factor
        got = e(torch.from_numpy(img).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        assert (got - want).abs().max() < ORACLE_TOL
        want = oracle.decode(torch.from_numpy(
            lat / cfg.scaling_factor + cfg.shift_factor))
        got = d(torch.from_numpy(lat).permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        assert got.shape == (2, 3, 8, 12)
        assert (got - want).abs().max() < ORACLE_TOL


def test_cli_writes_npz_both_packages_read(flux, vae, tmp_path):
    from safetensors.torch import save_file

    from s3od_tpu.convert import load_native as jax_load
    from s3od_torch.convert import load_mmdit, load_vae_modules
    from s3od_torch.datagen import convert_flux

    _, sd, tree, _, cfg = flux
    _, vsd, (enc, dec), _, vcfg = vae
    save_file({k: v.contiguous() for k, v in sd.items()},
              str(tmp_path / "t.safetensors"))
    torch.save(vsd, str(tmp_path / "v.bin"))
    assert convert_flux.main([
        "--transformer", str(tmp_path / "t.safetensors"),
        "--vae", str(tmp_path / "v.bin"),
        "--out_transformer", str(tmp_path / "t.npz"),
        "--out_vae", str(tmp_path / "v.npz")]) == 0
    params, meta = jax_load(str(tmp_path / "t.npz"))
    assert meta is None  # no state, as the JAX converter writes
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    model = load_mmdit(str(tmp_path / "t.npz"), cfg)
    want = _port_model(tree, cfg).state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    e, _, _ = load_vae_modules(str(tmp_path / "v.npz"), vcfg)
    assert e.conv_in.out_channels == 32
    vtree, vmeta = jax_load(str(tmp_path / "v.npz"))
    assert vmeta is None
    for a, b in zip(jax.tree.leaves(vtree["enc"]), jax.tree.leaves(enc)):
        np.testing.assert_array_equal(np.asarray(a), b)
