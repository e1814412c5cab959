"""The benchmark's FLUX.1-dev LoRA cell on the CPU at the tiny MMDiT
(`tiny_mmdit_config()`'s widths, float32): the plain reference
(`perfbench/reference/mmdit.py`) against the port's `lora_loss` and LoRA
step, planted faults that the comparison catches, the reference's
imports, the seeded weights' layout against the port's, the step's FLOP
count, the spans and merge count of a step, and the whole driver.

Tolerances: the port and the reference compute the same float32 math in
another order (fused qkv against split heads, the merged weight against
the adapter added to the output), six blocks deep: relative 1e-5 of the
reference's norm on the velocity and the loss, 1e-4 on a gradient (read
~5e-7), 1e-3 on a leaf's change after two AdamW steps (read up to
1.2e-4: an element whose gradient is under AdamW's eps, 1e-8, moves by
lr g / eps, so float32's rounding of such a gradient, ~1e-10 here, moves
it by ~1e-2 lr). A planted fault reads 10x its tolerance or more.
"""

from __future__ import annotations

import copy
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import core, flops_mmdit, inputs_mmdit, program_lora  # noqa: E402
from perfbench.reference import mmdit as ref_mmdit  # noqa: E402
from s3od_torch.datagen import lora as tl  # noqa: E402
from s3od_torch.models.mmdit import MMDiT, tiny_mmdit_config  # noqa: E402

CELL = "flux1dev-lora-1024-b1"
SEED = 2**31 + 22
VEL_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-3
B_SCALE = 0.5  # random B: each delta about ten times its base weight


def tiny_cfg(dtype="float32") -> dict:
    """The cell's configuration at `tiny_mmdit_config()`'s widths."""
    c = tiny_mmdit_config()
    cfg = copy.deepcopy(core.cell(CELL)["config"])
    cfg.update({"in_channels": c.in_channels, "num_layers": c.num_dual_blocks,
                "num_single_layers": c.num_single_blocks,
                "attention_head_dim": c.head_dim, "num_attention_heads": c.num_heads,
                "joint_attention_dim": c.text_dim, "pooled_projection_dim": c.pooled_dim,
                "axes_dims_rope": list(c.axes_dims), "hidden_size": c.hidden_size,
                "mlp_ratio": c.mlp_ratio, "rope_theta": c.rope_theta,
                "max_t5_tokens": 8, "dtype": dtype})
    return cfg


TRAFFIC = {"pool": 2, "batch": 1, "size": 128, "warmup_steps": 3}


def tiny_spec(dtype="float32") -> dict:
    spec = copy.deepcopy(core.cell(CELL))
    spec["config"] = tiny_cfg(dtype)
    spec["workload"]["traffic"].update(TRAFFIC)
    spec["workload"]["trace_seconds"] = 0.5
    return spec


def standing_in(monkeypatch, fn):
    """`fn` in place of the port's `merge_block`, with a merge count of
    its own (the real one counts on whatever the name resolves to)."""
    fn.merges = 0
    monkeypatch.setattr(tl, "merge_block", fn)


def _rel(got, ref) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def _build(cfg, seed=SEED):
    model = program_lora.build_model(cfg, inputs_mmdit.weights(cfg, seed, "cpu"))
    recipe = core.cell(CELL)["workload"]["recipe"]
    return model, program_lora.trainer(cfg, model, recipe, seed, "cpu"), recipe


def random_b(tr):
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for k, p in tr.leaves().items():
            if k.endswith(".B"):
                p.copy_(torch.randn(p.shape, generator=g) * B_SCALE)


def _pool(cfg, seed=SEED):
    return inputs_mmdit.samples(cfg, TRAFFIC, seed, "cpu")


def test_seeded_weights_have_the_port_layout():
    """Every parameter of the port's MMDiT, in order, with its shape, at the
    tiny and at FLUX.1-dev's published widths (on the meta device)."""
    for cfg in (tiny_cfg(), core.cell(CELL)["config"]):
        port = MMDiT(program_lora.mmdit_config(cfg), device="meta")
        want = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
        assert [(n, s) for n, s, _ in inputs_mmdit.param_specs(cfg)] == want
    full = core.cell(CELL)["config"]
    params = sum(math.prod(s) for _, s, _ in inputs_mmdit.param_specs(full))
    assert 11.8e9 < params < 12.0e9


def test_reference_imports_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.mmdit, perfbench.inputs_mmdit, "
            "perfbench.flops_mmdit; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'s3od_torch', 's3od_tpu', 'jax', 'jaxlib', 'flax'}); print(bad)"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_exact_float32_turns_tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with ref_mmdit.exact_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def _reference(cfg, recipe, lora0, batches, seed=SEED, steps=2):
    draws = [inputs_mmdit.draws(inputs_mmdit.step_generator(seed, i, "cpu"),
                                batches[i]["latents"]) for i in range(steps)]
    with ref_mmdit.exact_float32():
        return ref_mmdit.lora_steps(inputs_mmdit.weights(cfg, seed, "cpu"), cfg, recipe,
                                    lora0, batches[:steps], draws)


def _port_steps(tr, batches, steps=2):
    """The port's velocity and loss of the first step, its first gradients
    and the leaves after `steps` steps."""
    leaves = tr.leaves()
    cfg = tl.LoRAConfig(rank=16, alpha=16.0)
    with torch.no_grad():
        v, target = tl.lora_velocity(tr.model, tr.lora, cfg, batches[0],
                                     inputs_mmdit.step_generator(SEED, 0, "cpu"),
                                     compute_dtype=torch.float32)
    grads = None
    for i in range(steps):
        tr.step(batches[i], inputs_mmdit.step_generator(SEED, i, "cpu"))
        if i == 0:
            grads = {k: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                     for k, p in leaves.items()}
    return v, torch.mean((v - target) ** 2), grads, {k: p.detach().clone()
                                                      for k, p in leaves.items()}


@pytest.mark.parametrize("b_init", ["zero", "random"])
def test_reference_matches_the_port_lora_step(b_init):
    """Velocity, loss, the first step's LoRA gradients and the adapters
    after two AdamW steps; B from the recipe (0: A's first gradient is 0)
    or random (every merge nonzero from the first step)."""
    cfg = tiny_cfg()
    _, tr, recipe = _build(cfg)
    if b_init == "random":
        random_b(tr)
    lora0 = {k: v.detach().clone() for k, v in tr.leaves().items()}
    batches = _pool(cfg)
    v, loss, grads, after = _port_steps(tr, batches)
    ref = _reference(cfg, recipe, lora0, batches)
    assert _rel(v, ref["first"][0]) < VEL_TOL
    assert abs(loss.item() - ref["losses"][0]) < VEL_TOL * abs(ref["losses"][0])
    g_all = torch.cat([grads[k].flatten() for k in sorted(grads)])
    r_all = torch.cat([ref["grads1"][k].flatten() for k in sorted(grads)])
    assert _rel(g_all, r_all) < GRAD_TOL
    for k in grads:
        if b_init == "zero" and k.endswith(".A"):
            assert float(grads[k].abs().max()) == 0.0
            assert float(ref["grads1"][k].abs().max()) == 0.0
        else:
            assert _rel(grads[k], ref["grads1"][k]) < GRAD_TOL, k
    for k in after:
        assert _rel(after[k] - lora0[k], ref["params"][k] - lora0[k]) < UPDATE_TOL, k


def test_one_single_blocks_adapter_left_out_is_caught(monkeypatch):
    """The port with single block 2's adapters not merged: its leaves take
    no gradient and stay where they started."""
    cfg = tiny_cfg()
    model, tr, recipe = _build(cfg)
    skipped = model.single_blocks[2]
    real = tl.merge_block
    standing_in(monkeypatch, lambda blk, *a: {} if blk is skipped else real(blk, *a))
    lora0 = {k: v.detach().clone() for k, v in tr.leaves().items()}
    batches = _pool(cfg)
    _, _, _, after = _port_steps(tr, batches)
    ref = _reference(cfg, recipe, lora0, batches)
    worst = max(_rel(after[k] - lora0[k], ref["params"][k] - lora0[k]) for k in after)
    assert worst > 10 * UPDATE_TOL
    assert _rel(after["single_blocks.2.qkv.B"] - lora0["single_blocks.2.qkv.B"],
                ref["params"]["single_blocks.2.qkv.B"]
                - lora0["single_blocks.2.qkv.B"]) == pytest.approx(1.0)


def test_delta_rounded_to_bf16_is_caught(monkeypatch):
    """The merge with its delta rounded to bf16 (random B, so every delta
    is far from 0): the velocity leaves the reference by far more than
    float32's rounding."""
    cfg = tiny_cfg()
    _, tr, recipe = _build(cfg)
    random_b(tr)
    lora0 = {k: v.detach().clone() for k, v in tr.leaves().items()}
    real = tl.merge_block

    def rounded(blk, adapters, targets, lcfg):
        out = real(blk, adapters, targets, lcfg)
        for path in targets:
            w = tl._get(blk, path).weight
            out[".".join(path) + ".weight"] = w + (out[".".join(path) + ".weight"] - w
                                                   ).to(torch.bfloat16).float()
        return out

    standing_in(monkeypatch, rounded)
    batches = _pool(cfg)
    v, _, _, _ = _port_steps(tr, batches, steps=1)
    ref = _reference(cfg, recipe, lora0, batches, steps=1)
    assert _rel(v, ref["first"][0]) > 10 * VEL_TOL


def test_flops_at_the_tiny_config_by_hand():
    cfg = tiny_cfg()
    d, f, cin, dt, dp, r = 96, 384, 16, 64, 32, 16
    ni, nt = 64, 8
    n = ni + nt
    mm = lambda m, a, b: 2 * m * a * b
    fwd = (mm(ni, cin, d) + mm(nt, dt, d) + 2 * (mm(1, 256, d) + mm(1, d, d))
           + mm(1, dp, d) + mm(1, d, d) + 2 * 2 * mm(1, d, 6 * d)
           + 4 * mm(1, d, 3 * d) + mm(1, d, 2 * d) + mm(ni, d, cin))
    dual = sum(mm(m, d, 3 * d) + mm(m, d, d) + mm(m, d, f) + mm(m, f, d)
               for m in (ni, nt))
    single = mm(n, d, 3 * d) + mm(n, d, f) + mm(n, d + f, d)
    attn = 4 * 4 * n * n * 24
    fwd += 2 * dual + 4 * single + 6 * attn
    assert flops_mmdit.tokens(cfg, 128) == (ni, nt)
    assert flops_mmdit.forward_flops(cfg, ni, nt) == pytest.approx(fwd, rel=1e-12)
    dgrad = 2 * dual + 4 * single - mm(ni, d, 3 * d) - mm(nt, d, 3 * d) + mm(ni, d, cin)
    adapters = (2 * sum(6 * m * r * ((d + 3 * d) + (d + d)) for m in (ni, nt))
                + 4 * 6 * n * r * (d + 3 * d + (d + f) + d))
    step = fwd + dgrad + 6 * 10 * 4 * n * n * 24 + adapters
    assert flops_mmdit.lora_step_flops(cfg, ni, nt) == pytest.approx(step, rel=1e-12)


def test_flops_at_flux1dev():
    cfg = core.cell(CELL)["config"]
    ni, nt = flops_mmdit.tokens(cfg, 1024)
    assert (ni, nt) == (4096, 512)
    assert flops_mmdit.forward_flops(cfg, ni, nt) == pytest.approx(7.45e13, rel=0.01)
    assert flops_mmdit.lora_step_flops(cfg, ni, nt) == pytest.approx(1.71e14, rel=0.01)
    assert flops_mmdit.attention_calls(cfg, ni, nt) == [(24, 4608, 128)] * 57


def _span_names(prof, tmp_path):
    import json

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("s3od.")]


@pytest.mark.parametrize("remat", [False, True])
def test_lora_step_spans_and_merge_count(tmp_path, remat):
    """One tiny step under the CPU profiler: one `s3od.train.step` with its
    four phases, a block span a block (2 + 4; the recompute under remat
    replays outside them) and a merge span and count a merge (6, or 12
    with the recompute)."""
    cfg = tiny_cfg()
    model, _, recipe = _build(cfg)
    tr = program_lora.trainer(cfg, model, {**recipe, "remat": remat}, SEED, "cpu")
    batch = _pool(cfg)[0]
    before = tl.merge_block.merges
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.step(batch, inputs_mmdit.step_generator(SEED, 0, "cpu"))
    names = _span_names(prof, tmp_path)
    merges = 12 if remat else 6
    assert tl.merge_block.merges - before == merges
    count = {n: names.count(n) for n in set(names)}
    assert count == {"s3od.train.step": 1, "s3od.train.forward": 1,
                     "s3od.train.loss": 1, "s3od.train.backward": 1,
                     "s3od.train.optimizer": 1, "s3od.mmdit.dual_block": 2,
                     "s3od.mmdit.single_block": 4, "s3od.lora.merge": merges}
    phases = [n for n in names if n.startswith("s3od.train.")]
    assert phases == ["s3od.train.step", "s3od.train.forward", "s3od.train.loss",
                      "s3od.train.backward", "s3od.train.optimizer"]


def test_lora_step_opens_no_span_without_a_profiler(monkeypatch):
    real = torch.autograd.profiler.record_function

    def guard(name, *args, **kwargs):
        assert not name.startswith("s3od."), f"span {name} opened without a profiler"
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", guard)
    cfg = tiny_cfg()
    _, tr, _ = _build(cfg)
    loss = tr.step(_pool(cfg)[0], inputs_mmdit.step_generator(SEED, 0, "cpu"))
    assert torch.isfinite(loss)


def test_driver_sound_run_is_correct_and_a_fault_is_not():
    """The whole cell at the tiny size, float32, under its own limits: a
    sound run is correct; the single blocks' adapters dropped after the
    build (the calibration's planted fault) fail `update_group_med` at
    about 1."""
    from perfbench.run import run_cell

    line = run_cell(tiny_spec(), SEED, 0.3, False, "cpu")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == {"fwd_rel", "grad_diff_med", "update_group_med"}
    assert line["metrics"]["train_img_s"]["value"] > 0

    with program_lora.single_adapters_dropped():
        line = run_cell(tiny_spec(), SEED, 0.3, False, "cpu")
    assert not line["correct"]
    assert line["checks"]["update_group_med"]["value"] == pytest.approx(1.0, abs=1e-3)


def test_driver_starts_both_sides_from_the_benchmarks_adapters(monkeypatch):
    """The reference starts from `inputs_mmdit.lora_init`, not from what
    the port drew, and the program is run from the same adapters: a port
    whose A draw is scaled x3 neither reaches the reference nor the
    compared run."""
    from perfbench.run import run_cell

    real_normal, real_steps, seen = tl.lora_normal, ref_mmdit.lora_steps, []
    monkeypatch.setattr(tl, "lora_normal", lambda g, shape: 3.0 * real_normal(g, shape))

    def steps(sd, cfg, recipe, lora0, *args, **kwargs):
        seen.append({k: v.detach().clone() for k, v in lora0.items()})
        return real_steps(sd, cfg, recipe, lora0, *args, **kwargs)

    monkeypatch.setattr(ref_mmdit, "lora_steps", steps)
    spec = tiny_spec()
    line = run_cell(spec, SEED, 0.3, False, "cpu")
    assert line["correct"], line["checks"]
    init = inputs_mmdit.lora_init(spec["config"], SEED, "cpu")
    assert len(seen) == 1 and set(seen[0]) == set(init)
    for k, v in init.items():
        assert torch.equal(seen[0][k], v), k


def test_driver_start_from_keeps_a_leaf_of_another_shape():
    """`start_from` copies by name and shape; a leaf whose shape differs
    (an adapter laid out (r, in) where the recipe has (in, r)) keeps the
    port's value."""
    drv = core.load_module(core.BENCH / "drivers" / "lora.py", "perfbench_driver_lora")
    leaves = {"a.A": torch.zeros(4, 2), "b.A": torch.zeros(2, 4)}
    init = {"a.A": torch.ones(4, 2), "b.A": torch.ones(4, 2)}
    drv.start_from(leaves, init)
    assert torch.equal(leaves["a.A"], init["a.A"])
    assert torch.equal(leaves["b.A"], torch.zeros(2, 4))


def test_driver_trace_run_reads_every_metric_or_none():
    """A traced run on the CPU: no device work, so every per-layer reader
    of the cell finds nothing and returns None, never raising."""
    from perfbench.run import run_cell

    spec = tiny_spec()
    assert {m["name"] for m in spec["per_layer"]} >= {
        "mfu.lora", "attn_fwd_span_roofline.lora", "merge_device_ms.lora",
        "dual_block_device_ms.lora", "single_block_device_ms.lora",
        "loss_device_ms.lora", "attn_bwd_roofline.lora"}
    line = run_cell(spec, SEED, 0.3, True, "cpu")
    assert line["correct"] and line["metrics"] == {}
