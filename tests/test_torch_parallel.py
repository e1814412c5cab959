"""The port's data parallelism (`s3od_torch.parallel`) on CPU gloo groups,
held against the JAX package on its 8-device virtual CPU mesh.

The groups are spawned processes (`parallel.distributed.spawn_local`, one
torch thread each, joined through a file in a fresh temporary directory,
so that concurrent test workers cannot collide). A worker imports this module to find its function, so
the module imports neither jax nor s3od_tpu at its top: the JAX references
are computed in the test process, inside fixtures and test bodies, from
numpy-seeded weights and batches that both sides share. Two module-scoped
fixtures run every job of a world size in one group (`_world2`,
`_world4`); each test then reads its own result.

- Leg 1: the tiny train step (accumulation 2, SGD so that the parameters
  carry the gradients) under DDP on 2 ranks and FSDP2 on dp 2 x fsdp 2,
  against `make_train_step` on `make_mesh(dp=2, fsdp=2)`.
- Leg 2: the same on `make_hybrid_mesh(dcn=2, fsdp=2)` on both sides.
- Leg 3: the MMDiT at 19 dual + 38 single blocks, hidden 256, under FSDP2
  on 2 ranks against JAX `mmdit_forward` unsharded.
- The loader's shard, global-batch BatchNorm, checkpoints and the export
  under FSDP2, the optimizer on DTensors, the remat recompute under FSDP2,
  the CLI at 2 ranks, the sharded pipeline and generation, data-parallel
  serving against the JAX predictor's sharded batches, and the refusals.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TINY = Path(__file__).parent / "fixture" / "tiny_s3od.npz"
ACCUM = 2
LR = 0.1
CONFUSION = ("tp", "fp", "fn")


# ----------------------------------------------------------------------------
# Shared by the workers and the test process (no jax)
# ----------------------------------------------------------------------------


def _tiny_cfg():
    from s3od_torch.configs import tiny_test_config

    cfg = tiny_test_config()
    return dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, pos_embed_rescale=None))


def _tiny_model(sd=None, seed=0):
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_

    model = S3ODSegmentation(_tiny_cfg())
    if sd is None:
        init_weights_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                              strict=True)
    return model


class _SGD:
    """p -= lr * g (on DTensors too): the parameters after one step carry
    the averaged gradients."""

    def __init__(self, model, lr):
        self.params, self.lr = list(model.parameters()), lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, step):
        for p in self.params:
            if p.grad is not None:
                p -= self.lr * p.grad


def _numpy_params(model):
    """Every parameter gathered whole, by name (a collective under FSDP2)."""
    from s3od_torch.parallel.mesh import full_tensor, unwrap

    return {n: full_tensor(p).detach().numpy().copy()
            for n, p in unwrap(model).named_parameters()}


def _numpy_buffers(model):
    from s3od_torch.parallel.mesh import unwrap

    return {n: b.detach().numpy().copy()
            for n, b in unwrap(model).named_buffers()}


def _train_leg(sd, batch, kind):
    """One train step of the tiny model on this rank's rows."""
    import torch.distributed as dist

    from s3od_torch.parallel import (batch_sharding, data_axes,
                                     make_hybrid_mesh, make_mesh, shard_batch,
                                     shard_module, unwrap)
    from s3od_torch.parallel.mesh import all_reduce_sums
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.train_step import train_step

    mesh = {"ddp": lambda: make_mesh(fsdp=1, device_type="cpu"),
            "fsdp": lambda: make_mesh(dp=2, fsdp=2, device_type="cpu"),
            "hybrid": lambda: make_hybrid_mesh(dcn=2, fsdp=2,
                                               device_type="cpu")}[kind]()
    model = shard_module(_tiny_model(sd), mesh)
    wrapper = type(model).__name__
    local = {k: torch.from_numpy(v)
             for k, v in shard_batch(batch, batch_sharding(mesh)).items()}
    out = train_step(model, _SGD(unwrap(model), LR),
                     LossModule(LOSS_PRESETS["focal_iou"]), local, 0, 0,
                     generator=torch.Generator(), accum_steps=ACCUM,
                     preprocessed=True, bn_group=dist.group.WORLD)
    sums = all_reduce_sums(out, [k for k in out if k not in CONFUSION])
    params = _numpy_params(model)
    return {"wrapper": wrapper, "axes": data_axes(mesh),
            "rows": len(local["images"]), "sums": sums,
            "params": params, "buffers": _numpy_buffers(model)}


def _grads_for(model):
    """Seeded whole gradients by parameter name (the dead parameters get
    none), the key-bias segments included."""
    from s3od_torch.parallel.mesh import unwrap

    core = unwrap(model)
    dead = set(core.unused_parameter_names())
    return {n: torch.randn(p.shape, generator=torch.Generator().manual_seed(i))
            for i, (n, p) in enumerate(core.named_parameters())
            if n not in dead}


def _optimizer_step(model, clip):
    """The port's Optimizer (AdamW, per-group clip, key-bias freeze) for one
    step on `_grads_for`'s gradients, sharded as the parameters are."""
    from s3od_torch.parallel.mesh import distribute_like, unwrap
    from s3od_torch.training.optim import Optimizer

    core = unwrap(model)
    opt = Optimizer(core, 1e-3, steps_per_epoch=10, grad_clip=clip)
    grads = _grads_for(model)
    for n, p in core.named_parameters():
        if n in grads:
            p.grad = distribute_like(grads[n], p)
    opt.step(0)
    return opt


def _optimizer_job(kind):
    from s3od_torch.parallel import make_mesh, shard_module

    mesh = (make_mesh(fsdp=2, device_type="cpu") if kind == "fsdp"
            else make_mesh(dp=2, fsdp=2, device_type="cpu"))
    model = shard_module(_tiny_model(seed=3), mesh)
    _optimizer_step(model, clip=0.5)
    return _numpy_params(model)


def _bn(w, b):
    bn = torch.nn.BatchNorm2d(len(w))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    return bn


def _sync_bn_job(x, g, w, b):
    """Global-batch BatchNorm on rows r::W given the world's group: output,
    input and parameter gradients (the parameter ones summed over the
    ranks) and the running statistics; then, given no group, the output
    and running mean of this rank's rows alone."""
    import torch.distributed as dist

    from s3od_torch.models.dpt import batch_norm

    r, world = dist.get_rank(), dist.get_world_size()
    bn = _bn(w, b)
    xs = torch.from_numpy(x[r::world]).requires_grad_()
    y = batch_norm(bn, xs, True, dist.group.WORLD)
    (y * torch.from_numpy(g[r::world])).sum().backward()
    dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
    dist.all_reduce(dw)
    dist.all_reduce(db)
    alone = _bn(w, b)
    with torch.no_grad():
        y_alone = batch_norm(alone, torch.from_numpy(x[r::world]), True)
    return {"y": y.detach().numpy(), "dx": xs.grad.numpy(), "dw": dw.numpy(),
            "db": db.numpy(), "mean": bn.running_mean.numpy().copy(),
            "var": bn.running_var.numpy().copy(), "y_alone": y_alone.numpy(),
            "mean_alone": alone.running_mean.numpy().copy()}


def _remat_job(batch):
    """A train step under FSDP2 at 2 ranks whose block pre-forward hooks
    record what the block's parameters are when the block runs: in the
    forward and in the remat recompute, whole plain tensors (FSDP2 has
    gathered them)."""
    from torch.distributed.tensor import DTensor

    from s3od_torch.parallel import make_mesh, shard_module
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.train_step import train_step

    ref = _tiny_model(seed=4)
    shapes = {n: tuple(p.shape) for n, p in ref.encoder.layer[0].named_parameters()}
    model = shard_module(_tiny_model(seed=4), make_mesh(fsdp=2, device_type="cpu"))
    seen = []

    def record(module, args):
        seen.append(all(not isinstance(p, DTensor) and tuple(p.shape) == shapes[n]
                        for n, p in module.named_parameters()))

    for blk in model.encoder.layer:
        blk.register_forward_pre_hook(record)
    train_step(model, _SGD(model, LR), LossModule(LOSS_PRESETS["focal_iou"]),
               {k: torch.from_numpy(v) for k, v in batch.items()}, 0, 0,
               generator=torch.Generator(), accum_steps=1, preprocessed=True)
    return seen


def _checkpoint_job(batch, out_dir):
    """Train one step under FSDP2 at 2 ranks with the real optimizer, then
    save as `train()` does: every rank gathers, rank 0 writes `state.pt`
    through the CheckpointManager and the export."""
    import torch.distributed as dist

    from s3od_torch.parallel import (batch_sharding, make_mesh, shard_batch,
                                     shard_module)
    from s3od_torch.parallel.mesh import full_state_dict, full_tree
    from s3od_torch.training.checkpoint import (CheckpointManager,
                                                export_inference, key_bias_max)
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    mesh = make_mesh(fsdp=2, device_type="cpu")
    model = shard_module(_tiny_model(seed=5), mesh)
    opt = Optimizer(model, 1e-3, steps_per_epoch=10, grad_clip=1.0)
    train_step(model, opt, LossModule(LOSS_PRESETS["focal_iou"]),
               shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                           batch_sharding(mesh)), 0, 0,
               generator=torch.Generator(), preprocessed=True,
               bn_group=dist.group.WORLD)
    tree = {"model": full_state_dict(model),
            "optimizer": full_tree(opt.state_dict()), "step": 1, "epoch": 0}
    key_bias = key_bias_max(model)
    if dist.get_rank() == 0:
        CheckpointManager(out_dir).save(tree, epoch=0, metrics={})
        export_inference(model, str(Path(out_dir) / "s3od_final.npz"),
                         tree["model"], key_bias)
    return sorted(tree["model"])


def _mmdit_cfg(**kw):
    from s3od_torch.models.mmdit import MMDiTConfig

    return MMDiTConfig(hidden_size=256, num_heads=2, num_dual_blocks=19,
                       num_single_blocks=38, text_dim=64, pooled_dim=32, **kw)


def _mmdit_job(weights, inputs):
    """Leg 3: the full-depth MMDiT forward under FSDP2 on 2 ranks."""
    from s3od_torch.models.mmdit import MMDiT
    from s3od_torch.parallel import make_mesh, shard_module

    model = MMDiT(_mmdit_cfg())
    with np.load(weights) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files},
                              strict=True)
    shard_module(model, make_mesh(fsdp=2, device_type="cpu"), wrap="fsdp")
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        out = model(**t, compute_dtype=torch.float32)
    return {"output": out["output"].numpy(),
            "features": [f.numpy() for f in out["features"]]}


def _tiny_pipeline(mesh=None):
    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.datagen.text_encoding import TorchTextEncoders
    from s3od_torch.models import mmdit, text_encoders as te, vae

    gen = torch.Generator().manual_seed(0)
    cfg = mmdit.MMDiTConfig(
        hidden_size=96, num_heads=4, num_dual_blocks=2, num_single_blocks=4,
        text_dim=64, pooled_dim=32, in_channels=16, axes_dims=(8, 8, 8),
        feature_taps=(0, 1, 2, 3))
    vcfg = vae.VAEConfig(latent_channels=4, base_channels=8,
                         channel_mults=(1, 1, 1, 1), layers_per_block=1,
                         groups=4)
    enc = TorchTextEncoders.random_init(
        0, te.T5Config(vocab_size=300, d_model=64, d_kv=16, d_ff=96,
                       num_layers=1, num_heads=4),
        te.CLIPTextConfig(vocab_size=400, hidden_size=32,
                          intermediate_size=64, num_layers=1, num_heads=2),
        max_t5_tokens=16, device="cpu")
    return ConceptAttentionPipeline(
        mmdit.init_mmdit(cfg, gen), text_encoders=enc,
        vae=vae.VAE(*vae.init_vae(vcfg, gen), vcfg, device="cpu"),
        num_inference_steps=2, device="cpu", mesh=mesh)


def _pipeline_run(pipe):
    out = pipe("a red fox", height=64, width=96, seed=1,
               concepts=["fox", "background"])
    return {"latents": out.latents, "features": out.features,
            "maps": out.concept_maps, "image": out.image}


def _pipeline_job(out_dir):
    """The pipeline with fsdp=2 (`fsdp_mesh`, as `from_config` builds it),
    then one class through the generation orchestrator: which ranks write
    images (PIL saves counted per rank)."""
    from PIL import Image

    from s3od_torch.configs import tiny_test_config
    from s3od_torch.datagen import generate_train_images as g
    from s3od_torch.datagen.diffusion import fsdp_mesh
    from s3od_torch.datagen.mask_generator import MaskGenerator
    from s3od_torch.models.flux_teacher import (FluxTeacherConfig,
                                                init_flux_teacher)

    pipe = _tiny_pipeline(fsdp_mesh(2, "cpu"))
    result = _pipeline_run(pipe)
    saves = []
    real_save = Image.Image.save
    Image.Image.save = lambda self, fp, *a, **k: (saves.append(str(fp)),
                                                  real_save(self, fp, *a, **k))
    try:
        mg = MaskGenerator(model=init_flux_teacher(FluxTeacherConfig(
            base=tiny_test_config(), flux_dim=24),
            torch.Generator().manual_seed(1)), device="cpu")
        g.GENERATION_RESOLUTIONS = [(64, 96)]
        c = g.GenerationConfig(output_dir=out_dir + "/o",
                               prompts_dir=out_dir + "/p")
        run = g.ImageMaskGenerationPipeline(c, pipe, mg)
        result["done"] = [run.process_class("tabby cat", 2),
                          run.process_class("tabby cat", 2)]
    finally:
        Image.Image.save = real_save
    result["saves"] = saves
    return result


def _loaded_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in ("jax", "s3od_tpu", "triton")})


def _world2_jobs(p):
    import torch.distributed as dist

    out = {"ddp": _train_leg(p["sd"], p["batch"], "ddp"),
           "bn": _sync_bn_job(*p["bn"]),
           "optim": _optimizer_job("fsdp"),
           "remat": _remat_job(p["batch"]),
           "ckpt": _checkpoint_job(p["batch"], p["ckpt_dir"]),
           "mmdit": _mmdit_job(p["mmdit_weights"], p["mmdit_inputs"]),
           "pipeline": _pipeline_job(p["gen_dir"]),
           "modules": _loaded_modules()}
    if dist.get_rank():  # the whole tensors once, from rank 0
        for leg in ("ddp", "mmdit"):
            out[leg].pop("params", None)
        out.pop("optim")
    return out


def _world4_jobs(p):
    import torch.distributed as dist

    out = {"fsdp": _train_leg(p["sd"], p["batch"], "fsdp"),
           "hybrid": _train_leg(p["sd"], p["batch"], "hybrid"),
           "optim": _optimizer_job("hsdp"),
           "modules": _loaded_modules()}
    if dist.get_rank():
        for leg in ("fsdp", "hybrid"):
            out[leg].pop("params")
        out.pop("optim")
    return out


# ----------------------------------------------------------------------------
# The JAX side and the groups (test process)
# ----------------------------------------------------------------------------


def _batch(seed=0, n=8, size=64):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((n, size, size, 3)).astype(np.float32),
            "masks": (rng.random((n, size, size)) > 0.7).astype(np.float32)}


@pytest.fixture(scope="module")
def tiny_jax():
    """JAX params (init + seeded noise, the key-bias segment zero), the
    port's state dict of them, and the batch."""
    import jax
    from test_torch_training import _tiny

    from s3od_torch.convert import state_dict_from_jax

    cfg, params, state, _ = _tiny(num_layers=4, pos_embed_rescale=None)
    sd = {k: v.detach().numpy().copy()
          for k, v in state_dict_from_jax(params, state).items()}
    return cfg, params, state, sd, _batch()


def _jax_step(tiny_jax, mesh):
    """`make_train_step` (accumulation 2, SGD) on `mesh`: (loss, params
    in the port's layout, BN state leaves)."""
    import jax
    import jax.numpy as jnp
    import optax
    from test_torch_training import _port_layout

    from s3od_tpu.parallel import shard_batch, shard_params
    from s3od_tpu.training.loss import LOSS_PRESETS, LossModule
    from s3od_tpu.training.train_step import TrainState, make_train_step

    cfg, params, state, _, batch = tiny_jax
    st = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                           jax.tree_util.tree_map(jnp.asarray, state),
                           optax.sgd(LR))
    st = TrainState(params=shard_params(st.params, mesh), bn_state=st.bn_state,
                    opt_state=shard_params(st.opt_state, mesh), step=st.step)
    step = make_train_step(cfg, LossModule(LOSS_PRESETS["focal_iou"]),
                           optax.sgd(LR), accum_steps=ACCUM)
    new, out = step(st, shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                    mesh), jnp.asarray(0.0), jax.random.key(7))
    new_params = _port_layout(cfg, jax.tree_util.tree_map(np.asarray,
                                                          new.params), state)
    bn = [np.asarray(x) for x in jax.tree_util.tree_leaves(new.bn_state)]
    return {k: float(v) for k, v in out.items()}, new_params, bn


def _mmdit_inputs():
    from s3od_torch.datagen.diffusion import make_img_ids

    rng = np.random.default_rng(0)
    ph = pw = 4
    return {"latents": rng.standard_normal((1, ph * pw, 64)).astype(np.float32),
            "txt": rng.standard_normal((1, 8, 64)).astype(np.float32),
            "pooled": rng.standard_normal((1, 32)).astype(np.float32),
            "timestep": np.full((1,), 0.7, np.float32),
            "img_ids": np.asarray(make_img_ids(ph, pw), np.float32),
            "txt_ids": np.zeros((8, 3), np.float32),
            "guidance": np.full((1,), 3.5, np.float32)}


@pytest.fixture(scope="module")
def mmdit_jax(tmp_path_factory):
    """JAX `mmdit_forward` unsharded at 19 + 38 blocks, hidden 256 (the
    dryrun's leg 3 config), and its weights as the port's state dict."""
    import jax
    import jax.numpy as jnp

    from s3od_tpu.models.mmdit import (MMDiTConfig, init_mmdit_params,
                                       mmdit_forward)
    from s3od_torch.convert import tree_to_state_dict

    cfg = MMDiTConfig(hidden_size=256, num_heads=2, num_dual_blocks=19,
                      num_single_blocks=38, text_dim=64, pooled_dim=32)
    params = init_mmdit_params(jax.random.key(3), cfg)
    inputs = _mmdit_inputs()
    ref = mmdit_forward(params, cfg, **{k: jnp.asarray(v) for k, v in inputs.items()},
                        compute_dtype=jnp.float32)
    path = tmp_path_factory.mktemp("mmdit") / "weights.npz"
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    np.savez(path, **{k: v.detach().numpy() for k, v in
                      tree_to_state_dict(tree).items()})
    return str(path), inputs, {
        "output": np.asarray(ref["output"]),
        "features": [np.asarray(f) for f in ref["features"]]}


@pytest.fixture(scope="module")
def world2(tiny_jax, mmdit_jax, tmp_path_factory):
    from s3od_torch.parallel.distributed import spawn_local

    rng = np.random.default_rng(9)
    bn = (rng.standard_normal((8, 6, 5, 7)).astype(np.float32) * 2 + 0.5,
          rng.standard_normal((8, 6, 5, 7)).astype(np.float32),
          rng.standard_normal(6).astype(np.float32) * 0.1 + 1.0,
          rng.standard_normal(6).astype(np.float32) * 0.1)
    tmp = tmp_path_factory.mktemp("world2")
    payload = {"sd": tiny_jax[3], "batch": tiny_jax[4], "bn": bn,
               "ckpt_dir": str(tmp / "ckpt"), "gen_dir": str(tmp / "gen"),
               "mmdit_weights": mmdit_jax[0], "mmdit_inputs": mmdit_jax[1]}
    return payload, spawn_local(2, _world2_jobs, payload, device_type="cpu",
                                threads=1, timeout=600)


@pytest.fixture(scope="module")
def world4(tiny_jax):
    from s3od_torch.parallel.distributed import spawn_local

    payload = {"sd": tiny_jax[3], "batch": tiny_jax[4]}
    return spawn_local(4, _world4_jobs, payload, device_type="cpu",
                       threads=1, timeout=600)


def _hold_leg(tiny_jax, got, ref):
    """The JAX package's own bounds (`tests/test_train_entrypoint.py:
    153-158`): loss 1e-5 relative, parameters 1e-4 max abs; BN state as in
    `test_torch_training.test_train_step_matches_jax`."""
    from s3od_torch.convert import convert_state_dict

    (ref_out, ref_params, ref_bn) = ref
    for k, v in ref_out.items():
        assert abs(got["sums"][k] - v) <= 1e-5 * max(1.0, abs(v)), k
    worst = max(float(np.abs(got["params"][k] - ref_params[k]).max())
                for k in ref_params)
    assert worst < 1e-4, worst
    model = _tiny_model(tiny_jax[3])
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in got["buffers"].items()}, strict=False)
    import jax

    _, got_bn, _ = convert_state_dict(model.state_dict(), tiny_jax[0])
    for a, b in zip(jax.tree_util.tree_leaves(got_bn), ref_bn):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------------
# Legs 1-3
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def leg1_jax(tiny_jax):
    import jax

    from s3od_tpu.parallel import make_mesh

    return _jax_step(tiny_jax, make_mesh(dp=2, fsdp=2,
                                         devices=jax.devices()[:4]))


@pytest.mark.parametrize("kind", ["ddp", "fsdp"])
def test_leg1_train_step_matches_the_jax_mesh(tiny_jax, leg1_jax, world2,
                                              world4, kind):
    """Leg 1: DDP on 2 ranks and FSDP2 on dp 2 x fsdp 2 (4 ranks), rank r
    taking rows r::W, against `make_train_step` on `make_mesh(dp=2,
    fsdp=2)` with the same global batch."""
    got = world2[1][0]["ddp"] if kind == "ddp" else world4[0]["fsdp"]
    assert got["wrapper"] == ("DistributedDataParallel" if kind == "ddp"
                              else "FSDPS3ODSegmentation")
    assert got["axes"] == ("data", "fsdp")
    assert got["rows"] == 8 // (2 if kind == "ddp" else 4)
    _hold_leg(tiny_jax, got, leg1_jax)


def test_leg2_hybrid_mesh_train_step_matches_jax(tiny_jax, world4):
    """Leg 2: `make_hybrid_mesh(dcn=2, fsdp=2)` over 4 ranks (HSDP:
    replicated over dcn x data, sharded over fsdp) against the JAX step
    on the same hybrid mesh of 4 devices."""
    import jax

    from s3od_tpu.parallel import make_hybrid_mesh

    got = world4[0]["hybrid"]
    assert got["wrapper"] == "FSDPS3ODSegmentation" and got["rows"] == 2
    assert got["axes"] == ("dcn", "data", "fsdp")
    ref = _jax_step(tiny_jax, make_hybrid_mesh(dcn=2, fsdp=2,
                                               devices=jax.devices()[:4]))
    _hold_leg(tiny_jax, got, ref)


def test_leg3_fsdp_mmdit_full_depth_matches_jax(mmdit_jax, world2):
    """Leg 3: 19 dual + 38 single blocks at hidden 256 under FSDP2 on 2
    ranks against JAX `mmdit_forward` unsharded: the output and the four
    taps (4, 16, 27, 36) at the JAX test's bounds
    (`tests/test_distributed.py:165-219`)."""
    _, _, ref = mmdit_jax
    for r in (0, 1):
        got = world2[1][r]["mmdit"]
        assert len(got["features"]) == len(ref["features"]) == 4
        np.testing.assert_allclose(got["output"], ref["output"],
                                   atol=2e-5, rtol=1e-5)
        for a, b in zip(got["features"], ref["features"]):
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)


# ----------------------------------------------------------------------------
# The parts
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3])
def test_loader_process_shard_yields_the_jax_indices(world):
    """`PrefetchLoader(process_shard=)` gives each rank the JAX loader's
    indices (41 samples: truncated to a multiple of the world size), and
    rank r's batch b is rows r::W of the global batch b."""
    from s3od_tpu.training.data import PrefetchLoader as JLoader
    from s3od_torch.training.data import PrefetchLoader

    class Data:
        def __len__(self):
            return 41

        def load(self, i):
            return np.full((8, 8, 3), i, np.uint8), np.zeros((8, 8), np.float32)

    def ids(cls, r, **kw):
        loader = cls(Data(), batch_size=2, seed=7, num_threads=2,
                     process_shard=(r, world), **kw)
        return [b["images"][:, 0, 0, 0].tolist() for b in loader.epoch(3)]

    glob = [b["images"][:, 0, 0, 0].tolist() for b in PrefetchLoader(
        Data(), batch_size=2 * world, seed=7, num_threads=2).epoch(3)]
    for r in range(world):
        got = ids(PrefetchLoader, r)
        assert got == ids(JLoader, r)
        assert got == [g[r::world] for g in glob[: len(got)]]


def _same(a, b) -> bool:
    """Equality of nested dicts / tuples / arrays."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b)


def test_loader_and_augmentation_draws_do_not_depend_on_the_world_size():
    """The host geometry and the device augmentation plan of rank r are
    the global batch's draws of rows r::W."""
    from s3od_torch.ops.augment import augment_batch
    from s3od_torch.training.data import PrefetchLoader

    class Data:
        def __len__(self):
            return 24

        def load(self, i):
            return np.zeros((32, 32, 3), np.uint8), np.zeros((32, 32), np.float32)

    def loader(**kw):
        return PrefetchLoader(Data(), seed=3, random_resized_crop_p=0.5,
                              geometric_mode="synthetic", **kw)

    whole = loader(batch_size=6).draw_geometry(1, 2, 6, 32)
    for r in range(3):
        got = loader(batch_size=2, process_shard=(r, 3)).draw_geometry(
            1, 2, 2, 32)
        assert len(got) == 2
        for a, b in zip(got, whole[r::3]):
            assert _same(a, b)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8))
    masks = torch.from_numpy(rng.random((6, 32, 32)).astype(np.float32))
    for mode in ("regular", "synthetic"):
        ref = augment_batch(imgs, masks, mode, torch.Generator().manual_seed(5))
        for r in range(3):
            got = augment_batch(imgs[r::3], masks[r::3], mode,
                                torch.Generator().manual_seed(5), shard=(r, 3))
            assert torch.equal(got[0], ref[0][r::3])
            assert torch.equal(got[1], ref[1][r::3])


def test_sync_batch_norm_at_world_2_equals_world_1_on_the_joined_batch(world2):
    """`models/dpt.batch_norm` at 2 ranks (rows r::2) against 1 rank on the
    whole batch: output and input gradients row for row, the parameter
    gradients summed over the ranks, the running statistics (n counts
    both ranks' rows)."""
    from s3od_torch.models.dpt import batch_norm

    x, g, w, b = world2[0]["bn"]
    bn = _bn(w, b)
    xs = torch.from_numpy(x).requires_grad_()
    y = batch_norm(bn, xs, True)
    (y * torch.from_numpy(g)).sum().backward()
    for r in (0, 1):
        got = world2[1][r]["bn"]
        np.testing.assert_allclose(got["y"], y.detach().numpy()[r::2],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["dx"], xs.grad.numpy()[r::2],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["dw"], bn.weight.grad.numpy(),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["db"], bn.bias.grad.numpy(),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got["mean"], bn.running_mean.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["var"], bn.running_var.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_batch_norm_without_a_group_takes_each_ranks_rows_alone(world2):
    """Inside a 2-rank group, `batch_norm` given no group normalizes each
    rank's rows by their own statistics: the group is the caller's
    choice (the trainer's, whose ranks hold different rows), never taken
    from the process group that happens to exist."""
    from s3od_torch.models.dpt import batch_norm

    x, _, w, b = world2[0]["bn"]
    for r in (0, 1):
        bn = _bn(w, b)
        with torch.no_grad():
            y = batch_norm(bn, torch.from_numpy(x[r::2]), True)
        got = world2[1][r]["bn"]
        np.testing.assert_allclose(got["y_alone"], y.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["mean_alone"], bn.running_mean.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert np.abs(got["y_alone"] - got["y"]).max() > 1e-3


@pytest.mark.parametrize("kind", ["fsdp", "hsdp"])
def test_optimizer_on_dtensors_equals_world_1(world2, world4, kind):
    """The port's Optimizer on FSDP2's sharded parameters (fsdp 2 at 2
    ranks; dp 2 x fsdp 2 at 4) with the same whole gradients as one rank:
    the key-bias freeze by each shard's offset, the per-group clip whose
    norm is reduced over the ranks (0.5, so that it clips), AdamW."""
    model = _tiny_model(seed=3)
    _optimizer_step(model, clip=0.5)
    ref = {n: p.detach().numpy() for n, p in model.named_parameters()}
    got = world2[1][0]["optim"] if kind == "fsdp" else world4[0]["optim"]
    for n, v in ref.items():
        np.testing.assert_allclose(got[n], v, rtol=1e-6, atol=1e-7, err_msg=n)
    c = _tiny_cfg().encoder.hidden_size
    for i in range(4):
        bias = got[f"encoder.layer.{i}.attention.qkv.bias"]
        assert not bias[c: 2 * c].any()


def test_remat_recompute_runs_on_the_gathered_weights(world2):
    """Under FSDP2 every block's forward and its remat recompute (4 blocks,
    a checkpointed step) see the block's parameters whole and plain: the
    recompute runs after FSDP2's re-gather."""
    for r in (0, 1):
        seen = world2[1][r]["remat"]
        assert seen == [True] * 8


def test_checkpoint_written_under_fsdp_restores_at_world_1(world2, tmp_path):
    """`state.pt` written by rank 0 of an FSDP2 run (gathered whole)
    restores into a world-1 model and optimizer with the keys a world-1
    checkpoint has; JAX's `load_native` reads its export to the tree the
    restored model exports."""
    from s3od_tpu.convert import load_native
    from s3od_torch.training.checkpoint import CheckpointManager, export_inference
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import train_step

    payload, res = world2
    run = Path(payload["ckpt_dir"])
    tree = torch.load(run / "last" / "state.pt", weights_only=False)
    assert res[0]["ckpt"] == res[1]["ckpt"] == sorted(tree["model"])

    model = _tiny_model(seed=5)
    opt = Optimizer(model, 1e-3, steps_per_epoch=10, grad_clip=1.0)
    train_step(model, opt, LossModule(LOSS_PRESETS["focal_iou"]),
               {k: torch.from_numpy(v) for k, v in payload["batch"].items()},
               0, 0, generator=torch.Generator(), preprocessed=True)
    CheckpointManager(str(tmp_path)).save(
        {"model": model.state_dict(), "optimizer": opt.state_dict(),
         "step": 1, "epoch": 0}, epoch=0, metrics={})
    ref = torch.load(tmp_path / "last" / "state.pt", weights_only=False)
    assert list(tree["model"]) == list(ref["model"])
    for k, v in ref["model"].items():
        assert tree["model"][k].shape == v.shape and not _is_dtensor(tree["model"][k])
    st, st_ref = tree["optimizer"]["state"], ref["optimizer"]["state"]
    assert sorted(st) == sorted(st_ref)
    for i in st_ref:
        assert sorted(st[i]) == sorted(st_ref[i])
        for k, v in st_ref[i].items():
            assert st[i][k].shape == v.shape and not _is_dtensor(st[i][k])

    restored = _tiny_model()
    restored.load_state_dict(tree["model"], strict=True)
    ropt = Optimizer(restored, 1e-3, steps_per_epoch=10, grad_clip=1.0)
    ropt.load_state_dict(tree["optimizer"])
    for i, s in ropt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, st[i][k])
    export_inference(restored, str(tmp_path / "restored.npz"))
    got, _ = load_native(str(run / "s3od_final.npz"))
    want, _ = load_native(str(tmp_path / "restored.npz"))
    import jax

    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _is_dtensor(t):
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def test_sharded_pipeline_generates_the_unsharded_latents_rank_0_writes(world2):
    """`ConceptAttentionPipeline` with the MMDiT sharded fsdp=2 gives the
    unsharded pipeline's latents, taps, maps and image on both ranks; the
    orchestrator then generates on both ranks in step, only rank 0 saves,
    and a second pass skips what exists on both."""
    ref = _pipeline_run(_tiny_pipeline())
    res = world2[1]
    for r in (0, 1):
        got = res[r]["pipeline"]
        np.testing.assert_allclose(got["latents"], ref["latents"],
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(got["features"], ref["features"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        for k, m in ref["maps"].items():
            np.testing.assert_allclose(got["maps"][k], m, atol=1e-5)
        assert np.abs(got["image"].astype(int)
                      - ref["image"].astype(int)).max() <= 1
        assert got["done"] == [2, 2]
    assert len(res[0]["pipeline"]["saves"]) == 4  # 2 images + 2 masks
    assert res[1]["pipeline"]["saves"] == []


def test_workers_load_neither_jax_nor_s3od_tpu(world2, world4):
    for res in (world2[1], world4):
        assert all(r["modules"] == [] for r in res.values())


def test_ddp_leaves_out_exactly_the_parameters_without_gradient():
    """`unused_parameter_names` (DDP's ignore list) is the set of
    parameters a training step leaves without a gradient, at the tiny
    width and at ViT-B's 12 blocks with taps up to 11 (on meta tensors)."""
    from s3od_torch.configs import segmentation_config
    from s3od_torch.models.segmentation import S3ODSegmentation

    model = _tiny_model(seed=0)
    out = model(torch.randn(2, 64, 64, 3), training=True)
    (out["pred_masks"].mean() + out["pred_iou"].mean()).backward()
    assert sorted(model.unused_parameter_names()) == sorted(
        n for n, p in model.named_parameters() if p.grad is None)
    with torch.device("meta"):
        base = S3ODSegmentation(segmentation_config("dinov3_base"))
    names = base.unused_parameter_names()
    assert {n.split(".")[2] for n in names if n.startswith("encoder.layer.")} \
        == {"11"}


def test_cli_backend_devices_2_matches_devices_1(tmp_path):
    """`train()` with `backend.devices=2` (two spawned gloo workers, the
    regular transform, global batch 4) against `backend.devices=1` with
    batch 4: every metric within 1e-5, the same checkpoint keys."""
    from test_torch_training import _write_dataset

    from s3od_torch.training.train import train

    _write_dataset(tmp_path)
    base = ["dataset=duts", "dataset.paths=[tinyds]", "dataset.image_size=64",
            "dataset.val_split=0.25", "dataset.transform_mode=regular",
            "dataset.test_datasets=[]", "model=tiny", "backend=cpu",
            "backend.num_threads=2", "backend.max_epochs=1",
            f"data_dir={tmp_path}"]
    m1 = train(base + ["backend.devices=1", "dataset.train_batch_size=4",
                       "dataset.val_batch_size=2", f"base_dir={tmp_path}/w1"])
    m2 = train(base + ["backend.devices=2", "dataset.train_batch_size=2",
                       "dataset.val_batch_size=1", f"base_dir={tmp_path}/w2"])
    assert m1.keys() == m2.keys()
    for k in m1:
        assert abs(m1[k] - m2[k]) <= 1e-5 * max(1.0, abs(m1[k])), k
    (r1,), (r2,) = [list((tmp_path / w / "checkpoints").iterdir())
                    for w in ("w1", "w2")]
    s1, s2 = [torch.load(r / "last" / "state.pt", weights_only=False)
              for r in (r1, r2)]
    assert list(s1["model"]) == list(s2["model"])
    assert (r2 / "s3od_final.npz").exists()


@pytest.fixture(scope="module")
def serving_jax():
    """The JAX predictor with `data_parallel=True` over its 8 virtual
    devices, chunk 8, on 11 seeded images of varied shape: the first
    chunk sharded one image a device, the second (3 images) padded to 8
    and the padding dropped."""
    from s3od_tpu.predictor import BackgroundRemoval as JaxRemoval

    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (int(rng.integers(16, 48)),
                                  int(rng.integers(16, 48)), 3), np.uint8)
            for _ in range(11)]
    pred = JaxRemoval(model_id=str(TINY), image_size=32, dtype="float32",
                      data_parallel=True)
    assert pred._mesh is not None and pred._mesh.size == 8
    return imgs, pred.remove_background_batch(imgs, chunk=8)


@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_data_parallel_serving_matches_the_jax_predictor(serving_jax,
                                                         replicas):
    """`BackgroundRemoval(data_parallel=[cpu] * k)` splits each chunk of 8
    in order over k replicas (`np.array_split`: 3 over 3 is 1 + 1 + 1, no
    padding) and answers as the JAX predictor on its data-sharded mesh,
    image by image and in order (masks and scores within 1e-4, as
    `test_torch_predictor.test_matches_jax_predictor`)."""
    from s3od_torch.predictor import BackgroundRemoval

    imgs, ref = serving_jax
    pred = BackgroundRemoval(str(TINY), image_size=32, device="cpu",
                             dtype="float32",
                             data_parallel=["cpu"] * replicas)
    assert len({id(m) for m, _, _ in pred._replicas}) == replicas
    seen = []
    for i, (model, _, _) in enumerate(pred._replicas):
        model.register_forward_pre_hook(
            lambda m, a, i=i: seen.append((i, int(a[0].shape[0]))))
    got = pred.remove_background_batch(imgs, chunk=8)
    want = [(i, len(p)) for n in (8, 3)
            for i, p in enumerate(np.array_split(np.arange(n), replicas))
            if len(p)]
    assert seen == want
    assert len(got) == len(ref) == 11
    for g, r in zip(got, ref):
        assert g.all_masks.shape == r.all_masks.shape
        assert np.abs(g.all_masks - r.all_masks).max() <= 1e-4
        assert np.abs(g.all_ious - r.all_ious).max() <= 1e-4


def test_refusals(tmp_path):
    """No fallback: `backend.devices` above the visible cards, and an
    `fsdp` that does not divide the world size (training and the
    pipeline), raise before any process group is made."""
    import torch.distributed as dist

    from s3od_torch.datagen.diffusion import ConceptAttentionPipeline
    from s3od_torch.training.train import train

    base = ["model=tiny", "dataset.transform_mode=test", f"data_dir={tmp_path}",
            f"base_dir={tmp_path}"]
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA device"):
        train(base + ["backend=1chip", f"backend.devices={n + 1}"])
    with pytest.raises(ValueError, match="does not divide"):
        train(base + ["backend=cpu", "backend.devices=2", "backend.fsdp=3"])
    with pytest.raises(ValueError, match="does not divide"):
        ConceptAttentionPipeline.from_config("x.npz", fsdp=2, device="cpu")
    assert not dist.is_initialized()
