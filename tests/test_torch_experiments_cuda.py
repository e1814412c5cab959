"""On the card: the experiments of `benchmarks/` (E1-E4,
`s3od_torch/experiments`) against their plain versions in bf16: each
script's `main()` at its defaults, every template instance of
`csrc/exp_flash_variants.cu` at ragged lengths with a planted fault
caught, E3b bit for bit, E2 at ragged and wide rows. The file imports no
JAX: run it on the card with

    python3 chip_smoke.py -k experiments
"""

import pytest
import torch

from s3od_torch.experiments import exp_exp2 as e3
from s3od_torch.experiments import exp_flash_single as e4
from s3od_torch.experiments import exp_flash_softmax as e1
from s3od_torch.experiments import exp_layernorm as e2
from s3od_torch.experiments import flash_variants as fv

from _cuda import LSE_TOL, REL_TOL, cuda, rel_norm  # noqa: F401

pytestmark = pytest.mark.cuda

# ||kernel - plain|| / ||plain|| of o per call, for each template instance
# of E1/E3a/E4: two bf16 roundings of o are at most 2^-8 apart; the planted
# o x 1.01 reads 1e-2
E_CALL_TOL = 5e-3
# ||kernel - plain|| / ||plain|| of E2's y: the two round the same fp32
# values, summed in another order, to bf16 (~1.4e-5 on the H100); half the
# planted y x 1.01
LN_NORM_TOL = 5e-3


def _rel(got, ref):
    return fv.errors(got, ref)["rel_vs_plain"]


@pytest.mark.parametrize("mod", [e1, e2, e3, e4], ids=["E1", "E2", "E3", "E4"])
def test_entry_points_run_on_cuda(cuda, mod):
    """Each script's `main()` at its defaults on the card (E1/E4 at (96,
    4104, 64), E3a at the DIS and the ViT shape, E3b at 16 steps, E2 at (8,
    4104, 768)), its kernels launched: every variant's kernel against its
    plain version as the script reports it, within REL_TOL (and LSE_TOL on
    lse; E2 by relative norm too; E3b bit-equal)."""
    kernels = {e1: [e1.flash_softmax], e2: [e2.layer_norm_single_pass],
               e3: [e3.exp2_flash, e3.exp_loop], e4: [e4.flash_single]}[mod]
    before = [fn.launches for fn in kernels]
    res = mod.main([])
    assert all(fn.launches > b for fn, b in zip(kernels, before))
    if mod is e3:
        assert all(r["bit_equal"] and r["inf_positions_equal"]
                   for r in res["loop"].values())
        entries = res["flash"].values()
    else:
        entries = [res] if mod is e2 else res.values()
    for r in entries:
        assert r["rel_vs_plain"] <= REL_TOL, r
        if mod in (e3, e4):
            assert r["lse_max_abs_err"] <= LSE_TOL, r
    if mod is e2:
        assert res["rel_norm_vs_plain"] <= LN_NORM_TOL


@pytest.mark.parametrize("n", [200, 4104])
def test_flash_experiments_match_plain_on_cuda(cuda, n):
    """E1, E4 and E3a at a ragged length (not a multiple of 64)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(4, n, 64, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(n, device=cuda)
    bias[-3:] = -1e30
    for variant in e1.VARIANTS:
        assert _rel(e1.flash_softmax(q, k, v, 0.125, variant),
                    e1.flash_softmax_plain(q, k, v, 0.125, variant)) <= REL_TOL
    for variant in e4.VARIANTS:
        o, lse = e4.flash_single(q, k, v, bias, 0.125, variant)
        o_ref, lse_ref = e4.flash_single_plain(q, k, v, bias, 0.125, variant)
        assert _rel(o, o_ref) <= REL_TOL
        assert float((lse - lse_ref).abs().max()) <= LSE_TOL
    blocks = e3.pick_blocks(n, 64)
    o, lse = e3.exp2_flash(q, k, v, 0.125, *blocks, n - 5)
    o_ref, lse_ref = e3.exp2_flash_plain(q, k, v, 0.125, *blocks, n - 5)
    assert _rel(o, o_ref) <= REL_TOL
    assert float((lse - lse_ref).abs().max()) <= LSE_TOL
    torch.cuda.synchronize()


def _plain_with_extra_keys(q, k, v, bias, sm, extra):
    """attention_plain over the n keys and `extra` appended zero keys with
    bias -1e30: the function the kernel computes with `extra_keys`."""
    if extra:
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, extra))
        k, v = pad(k), pad(v)
        bias = torch.cat([bias, torch.full((extra,), fv.NEG_INF, device=q.device)])
    return fv.attention_plain(q, k, v, bias, sm)


@pytest.mark.parametrize("n", [385, 4104])
def test_every_kernel_instance_matches_attention_plain_on_cuda(cuda, n):
    """Each template instance (codes 0, 1, 2, 3, 6) against
    `attention_plain` at a length of 1 mod 128 (the last key tile holds one
    key) and at the scripts' 4104, with the scripts' arguments: no bias and
    no lse (E1), a -1e30 bias on the last 3 keys and lse (E4), E3a's
    base-2 bound with the masked tail and extra keys. o within REL_TOL of
    max|plain| and E_CALL_TOL by relative norm, where a planted o x 1.01
    fails; lse within LSE_TOL."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(3, n, 64, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    bias = torch.zeros(n, device=cuda)
    bias[-3:] = -1e30
    cases = [(e1.softmax_for(var, 0.125), q, None, False, 0) for var in e1.VARIANTS]
    cases += [(e4.softmax_for(var, 0.125), e4._prepare(q, var, 0.125), bias, True, 0)
              for var in e4.VARIANTS]
    cases += [(e3.SOFTMAX, e3._scaled(q, 0.125), e3.key_bias(n, n - 5, cuda), True, 40)]
    codes = set()
    for sm, qq, bb, want_lse, extra in cases:
        o, lse = fv.launch(qq, k, v, bb, sm, want_lse=want_lse, extra_keys=extra)
        o_ref, lse_ref = _plain_with_extra_keys(qq, k, v, bb, sm, extra)
        assert _rel(o, o_ref) <= REL_TOL, sm
        assert rel_norm(o, o_ref) <= E_CALL_TOL, (sm, rel_norm(o, o_ref))
        assert rel_norm(o.float() * 1.01, o_ref) > E_CALL_TOL, sm
        if want_lse:
            assert float((lse - lse_ref).abs().max()) <= LSE_TOL, sm
        else:
            assert lse is None
        codes.add(sm.code)
    assert codes == set(fv.KERNEL_CODES)
    torch.cuda.synchronize()


def test_loop_matches_plain_on_cuda(cuda):
    """E3b bit-equal at 1-4 steps, where exp and exp2 stay finite and move
    every value at every step (a kernel that drops steps differs), and at
    16, where they are inf from step 5 on."""
    x = torch.rand(128, 128, device=cuda) * -40
    for name in e3.LOOP_VARIANTS:
        prev = x
        for reps in (1, 2, 3, 4, 16):
            ref = e3.exp_loop_plain(x, name, reps)
            assert torch.equal(e3.exp_loop(x, name, 16, reps), ref), (name, reps)
            if name in ("exp", "exp2") and reps < 16:
                assert bool(ref[:128].isfinite().all() and (ref[:128] != prev).all())
                prev = ref[:128]
    torch.cuda.synchronize()


@pytest.mark.parametrize("rows,c", [(37, 768), (37, 64), (5, 1000), (3, 4096),
                                    (912, 768), (8 * 4104, 768)])
def test_layernorm_kernel_matches_plain_on_cuda(cuda, rows, c):
    """E2's kernel at ragged row counts (37 rows: a stage part empty), at
    C = 64 (24 of 32 lanes idle), 1000 (not a multiple of 256) and 4096
    (w and b re-read), and at the script's (8 x 4104, 768), by max error
    and relative norm; a planted y x 1.01 caught."""
    xl, w, b = e2.inputs(1, rows, c, cuda)
    got = e2.layer_norm_single_pass(xl, w, b).float()
    ref = e2.layer_norm_single_pass_plain(xl, w, b).float()
    assert _rel(got, ref) <= REL_TOL
    assert rel_norm(got, ref) <= LN_NORM_TOL
    assert rel_norm(got * 1.01, ref) > LN_NORM_TOL
    torch.cuda.synchronize()
