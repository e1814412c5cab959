"""s3od_torch.experiments (E1-E4): each plain version against the Pallas
kernel of its script in `benchmarks/`, run in interpret mode on the CPU,
the entry points with `--device cpu` and the wrappers' dispatch. On the
card each kernel is held to its plain version by
`tests/test_torch_experiments_cuda.py`.

The scripts are read, never edited. Their kernels are reached as they
stand: `jax.experimental.pallas.pallas_call` is wrapped to force
`interpret=True` and to record each call's inputs and outputs (through
`jax.debug.callback`, so it works under `jax.jit`), E2's and E3b's
closures run through the script's `main()` under a small `sys.argv` with
`s3od_tpu.profiling.slope_time` stubbed to one call, and E3's `main()`
stops after section A at a sentinel raised by a stubbed
`s3od_tpu.ops.flash_attention.flash_attention` (its sections B and C are
hard-coded to full size). E3b's fixed 256-program grid is cut to 8
programs: program i writes output block i mod 8, so the first 8 write
every block and the output is the same.

Tolerances, after ROADMAP's note on bf16 outputs (one flipped rounding
moves an output by a bf16 step at its own magnitude): max|JAX - port| <=
2^-7 max|JAX| with under 1% of outputs differing; lse within 1e-3
absolute. E3b is fp32: `mul` exact, the infs at the same positions and
the finite values within 1e-5 relative (the clip tails converge to one
constant, so every output may differ; XLA's exp2 is exp(ln2 x), whose
rounded product moves the result by up to |x| 2^-24, 2.4e-6 at |x| = 40).
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from s3od_torch.experiments import exp_exp2 as e3
from s3od_torch.experiments import exp_flash_single as e4
from s3od_torch.experiments import exp_flash_softmax as e1
from s3od_torch.experiments import exp_layernorm as e2
from s3od_torch.experiments import flash_variants as fv

REPO = Path(__file__).resolve().parent.parent


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_pair(a):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.array(_np(j))).to(torch.bfloat16)


def _assert_close(port, ref, frac=0.01):
    port = np.asarray(torch.as_tensor(port).float(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    diff = np.abs(port - ref)
    assert diff.max() <= 2.0**-7 * np.abs(ref).max(), diff.max()
    assert (diff > 0).mean() < frac, (diff > 0).mean()


@pytest.fixture
def pallas_calls(monkeypatch):
    """Force interpret mode on every pallas_call and record (inputs,
    outputs) of each call as numpy arrays."""
    orig = pl.pallas_call
    calls = []

    def forced(kernel, *args, **kwargs):
        kwargs["interpret"] = True
        if kwargs.get("grid") == (256,):  # E3b: 8 programs write every block
            kwargs["grid"] = (8,)
        fn = orig(kernel, *args, **kwargs)

        def run(*ins):
            out = fn(*ins)
            jax.debug.callback(lambda i, o: calls.append((i, o)), ins, out)
            return out

        return run

    monkeypatch.setattr(pl, "pallas_call", forced)
    return calls


@pytest.fixture
def script_main(monkeypatch, pallas_calls):
    """Run a script's main() under argv with slope_time stubbed to one
    call; returns the recorded pallas calls."""
    import s3od_tpu.profiling

    monkeypatch.setattr(s3od_tpu.profiling, "slope_time",
                        lambda fn, readback, **kw: (readback(fn()), 1e-3)[1])

    def run(mod, argv=()):
        monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
        mod.main()
        jax.effects_barrier()
        return pallas_calls

    return run


def _qkv(bh, n, d, scales, seed=0):
    rng = np.random.default_rng(seed)
    return [_bf16_pair(rng.standard_normal((bh, n, d)) * s) for s in scales]


# ----------------------------------------------------------------------------
# E1: online-softmax variants
# ----------------------------------------------------------------------------


def _exp2_as_on_the_tpu(orig):
    """jnp.exp2 as the TPU's Mosaic lowering computes it (`math.exp2` of
    the value itself, then rounded to its dtype). XLA's CPU lowering, which
    interpret mode uses, is exp(ln2 * x) in the input dtype: in bf16 that
    rounds ln 2 to 0.69140625 (-0.25%) and the product to bf16, so p moves
    by up to ~1.5% and most bf16 outputs differ from the true exp2's."""
    def exp2(x):
        x = jnp.asarray(x)
        if x.dtype == jnp.bfloat16:
            return orig(x.astype(jnp.float32)).astype(jnp.bfloat16)
        return orig(x)
    return exp2


def _e1_case(variant, block_k):
    mod = _script("exp_flash_softmax")
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 128, 64, (1.0, 1.0, 1.0))
    scale = 64 ** -0.5
    ref = mod.make_kernel(variant)(qj, kj, vj, scale, 64, block_k)
    return e1.flash_softmax_plain(qt, kt, vt, scale, variant, block_k), _np(ref)


@pytest.mark.parametrize("block_k", [128, 64], ids=["nk1", "nk2"])
@pytest.mark.parametrize("variant", e1.VARIANTS)
def test_e1_plain_matches_pallas_interpret(monkeypatch, pallas_calls, variant,
                                           block_k):
    """(2, 128, 64), block_q 64: one K block and two (the online rescale
    across blocks); logits of unit scale, so the row max matters. exp2 is
    evaluated as on the TPU (`_exp2_as_on_the_tpu`)."""
    monkeypatch.setattr(jnp, "exp2", _exp2_as_on_the_tpu(jnp.exp2))
    _assert_close(*_e1_case(variant, block_k))


@pytest.mark.parametrize("block_k", [128, 64], ids=["nk1", "nk2"])
def test_e1_exp2_bf16_against_the_xla_lowering(pallas_calls, block_k):
    """With XLA's own exp2 lowering (bf16 ln 2) the interpret kernel still
    agrees within 2^-7 of its largest output, though most outputs differ."""
    got, ref = _e1_case("exp2_bf16", block_k)
    _assert_close(got, ref, frac=1.0)


# ----------------------------------------------------------------------------
# E4: single-K-block variants with lse
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("variant", e4.VARIANTS)
def test_e4_plain_matches_pallas_interpret(pallas_calls, variant):
    """(2, 128, 64), block_q 64, -1e30 on the last 3 keys; o and lse."""
    mod = _script("exp_flash_single")
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, 128, 64, (1.0, 1.0, 1.0), seed=1)
    bias = np.zeros((1, 128), np.float32)
    bias[:, -3:] = -1e30
    scale = 64 ** -0.5
    o_ref, lse_ref = mod.make_run(variant)(qj, kj, vj, jnp.asarray(bias), scale, 64)
    o, lse = e4.flash_single_plain(qt, kt, vt, torch.from_numpy(bias), scale,
                                   variant)
    _assert_close(o, _np(o_ref))
    np.testing.assert_allclose(lse.numpy(), _np(lse_ref)[..., 0], atol=1e-3)


# ----------------------------------------------------------------------------
# E3a: the static-bound forward in base 2
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("n, blocks, n_valid", [
    (150, (152, 152), 150),   # one K block (_exp2_single_kernel)
    (150, (64, 64), 150),     # 3 K blocks, 42 padded keys (_exp2_stream_kernel)
    (150, (64, 64), 141),     # and keys at or past n_valid masked
], ids=["single", "stream", "stream-masked"])
def test_e3a_plain_matches_pallas_interpret(pallas_calls, n, blocks, n_valid):
    mod = _script("exp_exp2")
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2, n, 64, (0.5, 0.5, 1.0), seed=2)
    scale = 64 ** -0.5
    ref = mod._exp2_flash(qj, kj, vj, scale, *blocks, n_valid, interpret=True)
    jax.effects_barrier()
    lse_ref = np.asarray(pallas_calls[-1][1][1], np.float32)[:, :n, 0]
    o, lse = e3.exp2_flash_plain(qt, kt, vt, scale, *blocks, n_valid)
    _assert_close(o, _np(ref))
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-3)


def test_pick_blocks_is_the_jax_rule():
    from s3od_tpu.ops.flash_attention import _pick_blocks

    for n in (150, 4101, 4104, 16389, 20000):
        assert e3.pick_blocks(n, 64) == _pick_blocks(n, 64)
    assert e3.padded_len(16389, *e3.pick_blocks(16389, 64)) == 16896
    assert e3.padded_len(4101, *e3.pick_blocks(4101, 64)) == 4104


# ----------------------------------------------------------------------------
# E3b and E2: closures inside the scripts' main()
# ----------------------------------------------------------------------------


class _Stop(Exception):
    pass


def test_e3b_plain_matches_pallas_interpret(monkeypatch, script_main,
                                            pallas_calls):
    """Section A of the script: the five loops, f^16 over (512, 512) fp32
    in [-40, 0] (exp and exp2 overflow to inf after five steps)."""
    import s3od_tpu.ops.flash_attention as jfa

    def stop(*args, **kwargs):
        raise _Stop

    monkeypatch.setattr(jfa, "flash_attention", stop)
    with pytest.raises(_Stop):
        script_main(_script("exp_exp2"))
    jax.effects_barrier()
    assert len(pallas_calls) == len(e3.LOOP_VARIANTS)
    for name, (ins, out) in zip(e3.LOOP_VARIANTS, pallas_calls):
        x, ref = np.asarray(ins[0]), np.asarray(out)
        got = e3.exp_loop_plain(torch.from_numpy(x), name).numpy()
        assert got.shape == ref.shape == (4096, 512)
        if name == "mul (baseline)":  # 16 rounded products: exact
            np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(np.isinf(got), np.isinf(ref), err_msg=name)
        fin = np.isfinite(ref)
        if fin.any():
            err = np.abs(got[fin] - ref[fin]).max()
            assert err <= 1e-5 * np.abs(ref[fin]).max(), (name, err)
    assert np.isinf(np.asarray(pallas_calls[1][1])).all()  # exp overflows


@pytest.mark.parametrize("name, step", [("exp", np.exp), ("exp2", np.exp2)])
def test_e3b_plain_takes_every_step(name, step):
    """At 1-4 steps exp and exp2 of [-40, 0] stay finite and move every
    value at every step, so a loop that drops one differs."""
    x = np.random.default_rng(4).uniform(-40, 0, (16, 16)).astype(np.float32)
    a = x.astype(np.float64)
    for reps in (1, 2, 3, 4):
        a = step(a)
        got = e3.exp_loop_plain(torch.from_numpy(x), name, reps).numpy()
        assert got.shape == (8 * 16, 16) and np.isfinite(got).all()
        np.testing.assert_allclose(got[:16], a, rtol=1e-4)
        np.testing.assert_array_equal(got[16:32], got[:16])


def test_e2_plain_matches_pallas_interpret(script_main):
    """The script at --batch 1 --n 456 --c 128: one 456-row block."""
    calls = script_main(_script("exp_layernorm"),
                        ["--batch", "1", "--n", "456", "--c", "128"])
    assert calls
    (x, w, b), ref = calls[0]
    x = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(np.asarray(w)).reshape(-1)
    b = torch.from_numpy(np.asarray(b)).reshape(-1)
    got = e2.layer_norm_single_pass_plain(x, w, b)
    _assert_close(got, np.asarray(ref, np.float32))
    # the script's XLA variants agree with the kernel's function in bf16
    for fn in (e2.layer_norm_base_plain, e2.layer_norm_mxu_plain):
        _assert_close(fn(x, w, b), np.asarray(ref, np.float32), frac=0.1)


def test_e2_plain_matches_pallas_interpret_at_vit_b_width(script_main):
    """The script at --batch 1 --n 456 --c 768 (ViT-B's width, the
    script's default C): one 456-row block."""
    calls = script_main(_script("exp_layernorm"),
                        ["--batch", "1", "--n", "456", "--c", "768"])
    (x, w, b), ref = calls[0]
    assert x.shape[-1] == 768
    x = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(np.asarray(w)).reshape(-1)
    b = torch.from_numpy(np.asarray(b)).reshape(-1)
    _assert_close(e2.layer_norm_single_pass_plain(x, w, b),
                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("c", [768, 64, 1000, 4096])
def test_e2_kernel_plan(c):
    """The Python mirror of E2's launch: a lane's 16-byte vectors cover
    the row (none idle at C = 768), w and b held in registers up to C =
    1024, a ring of 2-4 stages of 8 rows within a block's shared memory,
    enough blocks for every row."""
    rows = 8 * 4104
    p = e2.plan(rows, c)
    assert 32 * p["vectors"] * 8 >= c > 32 * (p["vectors"] - 1) * 8
    assert p["idle_lanes"] == 32 * p["vectors"] - c // 8
    assert p["weights_held"] == (c <= 1024)
    assert 2 <= p["stages"] <= 4 and p["smem"] <= e2.MAX_SMEM
    assert p["blocks"] * e2.BULK_WARPS >= rows
    if c == 768:
        assert (p["vectors"], p["idle_lanes"], p["stages"]) == (3, 0, 4)


@pytest.mark.parametrize("case", ["width", "wide", "dtype", "affine"])
def test_e2_kernel_input_checks(case):
    """Non-CPU tensors go to the CUDA kernel, which takes bf16 x, fp32 (C,)
    w and b and C a multiple of 8 up to 4096; anything else raises before
    a launch ('meta' tensors need no card)."""
    m = lambda *s, dtype=torch.bfloat16: torch.empty(*s, dtype=dtype, device="meta")
    f32 = torch.float32
    args = {"width": (m(4, 100), m(100, dtype=f32), m(100, dtype=f32)),
            "wide": (m(4, 4104), m(4104, dtype=f32), m(4104, dtype=f32)),
            "dtype": (m(4, 64, dtype=f32), m(64, dtype=f32), m(64, dtype=f32)),
            "affine": (m(4, 64), m(64), m(64))}[case]
    with pytest.raises(ValueError):
        e2.layer_norm_single_pass(*args)


# ----------------------------------------------------------------------------
# Entry points and wrappers on the CPU
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("mod, argv, lines", [
    (e1, ["--bh", "2", "--n", "128", "--block-q", "64"], 3),
    (e4, ["--bh", "2", "--n", "128", "--block-q", "64"], 5),
    (e2, ["--batch", "1", "--n", "456", "--c", "128"], 5),
    (e3, [], 7),
], ids=["E1", "E4", "E2", "E3"])
def test_entry_points_run_on_the_cpu(monkeypatch, capsys, mod, argv, lines):
    """Timing on the CPU says nothing of the card, and many timed calls
    slow a loaded test run: slope_time is stubbed to one call here. E3's
    script has no flags: its shapes are cut through its constants."""
    monkeypatch.setattr(mod, "slope_time",
                        lambda fn, readback, **kw: (readback(fn()), 1e-3)[1])
    monkeypatch.setattr(e3, "SHAPES", (("T", 150, 2),))
    monkeypatch.setattr(e3, "LOOP_BLOCK", 64)
    monkeypatch.setattr(e3, "LOOP_PROGRAMS", 8)
    res = mod.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == lines, out
    entries = {e1: lambda: res.values(), e4: lambda: res.values(),
               e2: lambda: [res], e3: lambda: [*res["loop"].values(),
                                               *res["flash"].values()]}[mod]()
    for r in entries:
        assert r["rel_vs_plain"] == 0.0 and r["max_abs_err"] == 0.0
        assert r["plain_ms"] == 1.0
    if mod is e3:
        assert all(r["bit_equal"] and r["inf_positions_equal"]
                   for r in res["loop"].values())
        assert res["flash"]["T"]["lse_max_abs_err"] == 0.0


def test_slope_time_calls_and_reads_back_in_order():
    from s3od_torch.profiling import slope_time

    log = []
    t = slope_time(lambda: log.append("call") or len(log),
                   lambda out: log.append(("read", out)) or 0.0,
                   n_small=2, n_large=5, repeats=2)
    assert isinstance(t, float)
    # one call, then warm-up 2, then 2 x 2 and 2 x 5, each run read once
    assert log.count("call") == 1 + 2 + 2 * 2 + 2 * 5
    assert [e for e in log if e != "call"] == [
        ("read", i) for i in (1, 4, 7, 10, 16, 22)]


def test_experiments_leave_jax_triton_and_s3od_tpu_out():
    """The four modules, and a CPU run of two entry points, import
    neither jax, nor triton, nor any module of s3od_tpu."""
    code = (
        "import sys\n"
        "from s3od_torch.experiments import exp_exp2, exp_flash_single, "
        "exp_flash_softmax, exp_layernorm\n"
        "exp_flash_single.main(['--bh', '1', '--n', '64', '--block-q', '32',"
        " '--device', 'cpu'])\n"
        "exp_layernorm.main(['--batch', '1', '--n', '8', '--c', '64',"
        " '--device', 'cpu'])\n"
        "print('jax' in sys.modules, 'triton' in sys.modules,\n"
        "      any(m.split('.')[0] == 's3od_tpu' for m in sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-3:] == ["False", "False", "False"]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in (e1, e2, e3, e4):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])


def test_cpu_tensors_take_the_plain_versions_without_counting():
    (_, q), (_, k), (_, v) = _qkv(2, 100, 64, (1.0, 1.0, 1.0), seed=3)
    bias = torch.zeros(100)
    bias[-3:] = -1e30
    x = torch.rand(32, 32) * -40
    xl = torch.randn(2, 8, 64).to(torch.bfloat16)
    w, b = torch.randn(64), torch.randn(64)
    calls = [
        (e1.flash_softmax, lambda: e1.flash_softmax(q, k, v, 0.125, "exp2_bf16"),
         lambda: e1.flash_softmax_plain(q, k, v, 0.125, "exp2_bf16")),
        (e4.flash_single, lambda: e4.flash_single(q, k, v, bias, 0.125, "nomax")[0],
         lambda: e4.flash_single_plain(q, k, v, bias, 0.125, "nomax")[0]),
        (e3.exp2_flash, lambda: e3.exp2_flash(q, k, v, 0.125, 64, 64, 97)[1],
         lambda: e3.exp2_flash_plain(q, k, v, 0.125, 64, 64, 97)[1]),
        (e3.exp_loop, lambda: e3.exp_loop(x, "fma+clip+sub+exp2"),
         lambda: e3.exp_loop_plain(x, "fma+clip+sub+exp2")),
        (e2.layer_norm_single_pass, lambda: e2.layer_norm_single_pass(xl, w, b),
         lambda: e2.layer_norm_single_pass_plain(xl, w, b)),
    ]
    for wrapper, kernel_route, plain in calls:
        before = wrapper.launches
        assert torch.equal(kernel_route(), plain())
        assert wrapper.launches == before


def test_every_variant_has_a_kernel_instance():
    """Each experiment variant maps to a template instance of
    `csrc/exp_flash_variants.cu`, with the script's constants."""
    for v in e1.VARIANTS:
        assert e1.softmax_for(v, 0.125).code in fv.KERNEL_CODES
    for v in e4.VARIANTS:
        assert e4.softmax_for(v, 0.125).code in fv.KERNEL_CODES
    assert e3.SOFTMAX.code in fv.KERNEL_CODES
    assert e4.softmax_for("nomax_clip2", 0.125).lo == -20.0
    assert e4.softmax_for("nomax", 0.125).mult == 1.0
    assert e1.softmax_for("exp2", 0.125).mult == pytest.approx(0.125 * fv.LOG2E)
    assert e3.SOFTMAX.hi == pytest.approx(40.0 * fv.LOG2E)


SCRIPT_SOFTMAXES = ([(f"E1 {v}", e1.softmax_for(v, 0.125)) for v in e1.VARIANTS]
                    + [(f"E4 {v}", e4.softmax_for(v, 0.125)) for v in e4.VARIANTS]
                    + [("E3a", e3.SOFTMAX)])


@pytest.mark.parametrize("label,sm", SCRIPT_SOFTMAXES,
                         ids=[lbl for lbl, _ in SCRIPT_SOFTMAXES])
def test_script_softmax_maps_to_a_kernel_instance(label, sm):
    """Every Softmax the three scripts build reaches a template instance
    whose arguments are its own (online, base 2, bf16 argument), and the
    launch at the scripts' shapes — E1/E4 (96, 4104), E3a DIS (12, 16389)
    and ViT (96, 4101), a length of 1 mod 128 — fits the card: 192-row
    blocks and 128-key tiles cover N, Q and the K/V rings fit a block's
    shared memory."""
    assert fv.kernel_instance(sm) == (sm.online, sm.base2, sm.bf16_arg)
    for bh, n in ((96, 4104), (12, 16389), (96, 4101), (3, 385)):
        p = fv.plan(bh, n)
        blocks, heads = p["grid"]
        assert heads == bh and (blocks - 1) * fv.BLOCK_Q < n <= blocks * fv.BLOCK_Q
        assert (p["key_tiles"] - 1) * fv.BLOCK_K < n <= p["key_tiles"] * fv.BLOCK_K
        assert p["smem"] <= fv.MAX_SMEM


def test_unmade_instances_raise():
    """Codes 4, 5 and 7 (bf16 argument in base e, or under the static
    bound) have no instance: the launch raises before reaching the card."""
    for sm in (fv.Softmax(online=True, bf16_arg=True),
               fv.Softmax(online=False, base2=True, bf16_arg=True)):
        with pytest.raises(ValueError, match="no instance"):
            fv.kernel_instance(sm)


def test_unknown_variant_raises_on_the_cpu_route():
    q = torch.zeros(1, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown variant"):
        e1.flash_softmax(q, q, q, 0.125, "exp3")
    with pytest.raises(ValueError, match="unknown variant"):
        e4.flash_single(q, q, q, torch.zeros(8), 0.125, "nomax3")


@pytest.mark.parametrize("case", ["dtype", "shape", "head_dim", "bias"])
def test_kernel_input_checks(case):
    q = torch.zeros(2, 70, 64, dtype=torch.bfloat16)
    args = {"dtype": (q.float(), q, q, None), "shape": (q, q[:, :60], q, None),
            "head_dim": (q[..., :32], q[..., :32], q[..., :32], None),
            "bias": (q, q, q, torch.zeros(70, dtype=torch.float64))}[case]
    with pytest.raises(ValueError):
        fv.check_inputs("test", *args)
    fv.check_inputs("test", q, q, q, torch.zeros(70))
