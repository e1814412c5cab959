"""s3od_torch serving bundles (`s3od_torch/aot.py`) and the serving kernels'
registered ops on the CPU: every `s3od::` op passes `torch.library.opcheck`
and counts the FLOPs its plain version counts; a bundle round-trips
through disk, holds the weights once, verifies, and its predictor answers
bit-equal to the eager predictor (float32 and bf16 on the CPU) and within
the eager port's bound (1e-4, `tests/test_torch_predictor.py`) of the JAX
bundle predictor on the same tree; dtype and device mismatches raise, an
unknown batch takes the eager route, and an export leaves the eager
answer unchanged."""

import json
import shutil
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from s3od_torch import BackgroundRemoval, _build
from s3od_torch.aot import (graph_name, load_serving_bundle,
                            save_serving_bundle, verify_bundle)
from s3od_torch.convert import load_checkpoint
from s3od_torch.models.segmentation import S3ODSegmentation

FIXTURE = Path(__file__).parent / "fixture"
TINY = FIXTURE / "tiny_s3od.npz"
SIZE = 128


def _model():
    sd, cfg = load_checkpoint(TINY)
    model = S3ODSegmentation(cfg)
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def image():
    return np.array(Image.open(FIXTURE / "image.jpg").convert("RGB"))


@pytest.fixture(scope="module")
def bundle32(tmp_path_factory):
    return save_serving_bundle(tmp_path_factory.mktemp("b32") / "bundle",
                               _model(), image_size=SIZE, batches=(1, 2),
                               dtype="float32", device="cpu")


@pytest.fixture(scope="module")
def bundle16(tmp_path_factory):
    return save_serving_bundle(tmp_path_factory.mktemp("b16") / "bundle",
                               _model(), image_size=SIZE, batches=(1,),
                               dtype="bfloat16", device="cpu")


# ----------------------------------------------------------------------------
# The registered ops
# ----------------------------------------------------------------------------


def _op_cases():
    """(op, plain function, args) of every `s3od::` op at small shapes."""
    from s3od_torch.ops import attn_epilogue, flash_attention, layernorm
    from s3od_torch.ops import mask_logits, mlp_fused, qkv_project
    from s3od_torch.ops.experimental import mask_tail, winograd

    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16)

    b, n, c, h = 1, 64, 64, 2
    d = c // h
    x = r(b, n, c)
    cos, sin = torch.randn(n, d, generator=g), torch.randn(n, d, generator=g)
    nchw = lambda ch: r(1, ch, 8, 8).permute(0, 2, 3, 1)
    ops = torch.ops.s3od
    return {
        "layer_norm": (ops.layer_norm, layernorm.layer_norm_plain,
                       (x, r(c), r(c), 1e-6)),
        "qkv_project_rope": (ops.qkv_project_rope,
                             qkv_project.qkv_project_rope_plain,
                             (x, r(3 * c, c), r(3 * c), cos, sin, h, d**-0.5)),
        "flash_attention": (ops.flash_attention,
                            flash_attention.flash_attention_plain,
                            (r(b * h, n, d), r(b * h, n, d), r(b * h, n, d), 60)),
        "attn_epilogue": (ops.attn_epilogue, attn_epilogue.attn_epilogue_plain,
                          (r(b * h, n, d), r(c, c), r(c), x, r(c), r(c), r(c),
                           1e-6)),
        "mlp_fused": (ops.mlp_fused, mlp_fused.mlp_fused_plain,
                      (x, r(128, c), r(128), r(c, 128), r(c), r(b, n, c), r(c))),
        "winograd_conv": (ops.winograd_conv, winograd.winograd_conv_plain,
                          (nchw(128), r(3, 3, 128, 128), r(128))),
        "winograd_rcu": (ops.winograd_rcu, winograd.winograd_rcu_plain,
                         (nchw(128), r(3, 3, 128, 128), r(128),
                          r(3, 3, 128, 128), r(128))),
        "mask_tail": (ops.mask_tail, mask_tail.mask_tail_plain,
                      (nchw(64), r(3, 3, 64, 64), r(64), r(3, 3, 64, 96), r(96),
                       r(96, 3), r(3))),
        "mask_logits": (ops.mask_logits, mask_logits.mask_logits_plain,
                        (r(1, 96, 8, 8), r(96), r(3, 32), r(3))),
    }


OPS = ["layer_norm", "qkv_project_rope", "flash_attention", "attn_epilogue",
       "mlp_fused", "winograd_conv", "winograd_rcu", "mask_tail", "mask_logits"]


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    op, plain, args = _op_cases()[name]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("name", OPS)
def test_op_matches_plain_and_counts_its_flops(name):
    """On CPU tensors the op runs the plain version (bit for bit), and
    FlopCounterMode counts the op by its formula as it counts the plain
    version's aten products (within 1%; LayerNorm has none)."""
    from torch.utils.flop_counter import FlopCounterMode

    op, plain, args = _op_cases()[name]
    with FlopCounterMode(display=False) as fc_op:
        got = op(*args)
    with FlopCounterMode(display=False) as fc_plain:
        ref = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(got, ref):  # mlp_fused's op also returns its hidden
        assert a.shape == b.shape and torch.equal(a, b)
    n_op, n_plain = fc_op.get_total_flops(), fc_plain.get_total_flops()
    assert abs(n_op - n_plain) <= 0.01 * n_plain, (n_op, n_plain)
    assert (n_op > 0) == (name != "layer_norm")


def test_model_flops_through_ops_match_plain_route():
    """The tiny model's bf16 forward on the CPU: the count with every
    wrapper sent through its op is the plain route's within 1%, and the
    encoder's products are in it (K2-K5 by their formulas)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = _model().prepare_serving_(torch.bfloat16)
    x = torch.randn(2, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    with torch.no_grad(), FlopCounterMode(display=False) as fc_plain:
        ref = model(x, serving_fast_output=True)
    with torch.no_grad(), _build.through_ops(), \
            FlopCounterMode(display=False) as fc_ops:
        got = model(x, serving_fast_output=True)
    assert not _build.via_ops()
    assert torch.equal(got["pred_masks"], ref["pred_masks"])
    by_op = {str(k): v for k, v in fc_ops.get_flop_counts()["Global"].items()}
    for op in ("qkv_project_rope", "flash_attention", "attn_epilogue",
               "mlp_fused"):
        assert by_op.get(f"s3od.{op}", 0) > 0, by_op
    n_ops, n_plain = fc_ops.get_total_flops(), fc_plain.get_total_flops()
    assert abs(n_ops - n_plain) <= 0.01 * n_plain, (n_ops, n_plain)


# ----------------------------------------------------------------------------
# Bundles
# ----------------------------------------------------------------------------


def test_bundle_layout_and_verify(bundle32):
    names = sorted(p.name for p in bundle32.iterdir())
    assert names == ["meta.json", "serving_b1.best.pt2", "serving_b1.pt2",
                     "serving_b2.best.pt2", "serving_b2.pt2", "weights.npz"]
    meta = json.loads((bundle32 / "meta.json").read_text())
    assert meta["format"] == "s3od_torch.serving_bundle.v1"
    assert meta["device"] == "cpu" and meta["dtype"] == "float32"
    assert meta["payloads"] == {"full": [1, 2], "best": [1, 2]}
    assert not meta["use_bn"]
    bundle = load_serving_bundle(bundle32)
    assert sorted(bundle.graphs) == [(1, "best"), (1, "full"), (2, "best"),
                                     (2, "full")]
    assert verify_bundle(bundle, n=2) <= 1e-5


def test_bundle_holds_the_weights_once(bundle32):
    """No graph carries a weight, a lifted constant or its example inputs
    (which hold the weights): the weights live in weights.npz alone."""
    for name in ("serving_b1.pt2", "serving_b2.best.pt2"):
        ep = torch.export.load(str(bundle32 / name))
        assert not ep.state_dict and not ep.constants
        assert ep.example_inputs is None
        with zipfile.ZipFile(bundle32 / name) as z:
            data = sum(i.file_size for i in z.infolist()
                       if "/data/" in i.filename)
        assert data < 4096, data


def test_bundle_predictor_bit_equal_to_eager_fp32(bundle32, image):
    eager = BackgroundRemoval(str(TINY), image_size=SIZE, device="cpu",
                              dtype="float32")
    aot = BackgroundRemoval.from_serving_bundle(bundle32, device="cpu")
    assert aot.image_size == SIZE and aot._aot_canvas == SIZE
    # graphs are read at their first call
    assert all(g._module is None for g in aot._aot.values())
    aot.remove_background(image)
    assert [k for k, g in aot._aot.items() if g._module is not None] == [(1, "full")]
    for payload in ("full", "best"):
        a = aot.remove_background(image, payload=payload)
        e = eager.remove_background(image, payload=payload)
        np.testing.assert_array_equal(a.all_masks, e.all_masks)
        np.testing.assert_array_equal(a.all_ious, e.all_ious)
    flipped = np.ascontiguousarray(image[:, ::-1])
    for a, e in zip(aot.remove_background_batch([image, flipped]),
                    eager.remove_background_batch([image, flipped])):
        np.testing.assert_array_equal(a.all_masks, e.all_masks)


def test_bf16_bundle_runs_the_ops_bit_equal_to_eager(bundle16, image):
    """A bf16 bundle exported on the CPU: its graph calls the five encoder
    ops (whose CPU implementations are the plain versions) and answers as
    the eager bf16 predictor does, bit for bit."""
    ep = torch.export.load(str(bundle16 / graph_name(1, "full")))
    calls = [n for n in ep.graph.nodes if n.op == "call_function"]
    targets = {str(n.target) for n in calls}
    for op in ("layer_norm", "qkv_project_rope", "flash_attention",
               "attn_epilogue", "mlp_fused"):
        assert f"s3od.{op}.default" in targets
    # no cast of a tensor to its own dtype is left (`drop_noop_casts`):
    # the bf16 weights' `.to(bf16)`; the images' and logits' casts stay
    casts = [n for n in calls if n.target is torch.ops.aten.to.dtype]
    assert casts and all(n.args[0].meta["val"].dtype != n.args[1] for n in casts)
    eager = BackgroundRemoval(str(TINY), image_size=SIZE, device="cpu",
                              dtype="bfloat16")
    aot = BackgroundRemoval.from_serving_bundle(bundle16, device="cpu")
    a, e = aot.remove_background(image), eager.remove_background(image)
    np.testing.assert_array_equal(a.all_masks, e.all_masks)
    np.testing.assert_array_equal(a.all_ious, e.all_ious)
    # the loaded graph calls the ops' functions, not the ops' dispatch
    called = {n.target for n in aot._aot[(1, "full")]._module.graph.nodes
              if n.op == "call_function"}
    assert set(_build.OP_FUNCTIONS.values()) >= {
        t for t in called if getattr(t, "__module__", "").startswith("s3od_torch.ops")}
    assert not any(str(t).startswith("s3od.") for t in called)
    assert sum(t in set(_build.OP_FUNCTIONS.values()) for t in called) == 5


def test_bundle_matches_jax_bundle_predictor(bundle32, tmp_path, image):
    """Each package's bundle of the same tree, float32, on the fixture
    image: within 1e-4 on masks and IoU scores."""
    from s3od_tpu.aot import save_serving_bundle as jax_save
    from s3od_tpu.convert import load_native_segmentation
    from s3od_tpu.predictor import BackgroundRemoval as JaxBackgroundRemoval

    params, state, cfg = load_native_segmentation(str(TINY))
    out = jax_save(tmp_path / "jax", params, state, cfg, image_size=SIZE,
                   batches=(1,), dtype="float32", payloads=("full",))
    ref = JaxBackgroundRemoval.from_serving_bundle(out, dtype="float32"
                                                   ).remove_background(image)
    got = BackgroundRemoval.from_serving_bundle(bundle32, device="cpu"
                                                ).remove_background(image)
    assert np.abs(got.all_masks - ref.all_masks).max() <= 1e-4
    assert np.abs(got.all_ious - ref.all_ious).max() <= 1e-4


def test_unknown_batch_takes_the_eager_route(bundle32, image):
    """Batches the bundle holds run its graph (the model's own forward is
    never called); any other batch runs the eager forward."""
    aot = BackgroundRemoval.from_serving_bundle(bundle32, device="cpu")
    calls = []
    forward = aot.model.forward
    aot.model.forward = lambda *a, **k: calls.append(1) or forward(*a, **k)
    aot.remove_background(image)
    aot.remove_background_batch([image] * 2)
    assert calls == []
    res = aot.remove_background_batch([image] * 3)
    assert calls == [1] and len(res) == 3


def test_bundle_rejects_non_bundle_dir(tmp_path):
    (tmp_path / "meta.json").write_text('{"format": "something-else"}')
    with pytest.raises(ValueError, match="not a serving bundle"):
        load_serving_bundle(tmp_path)
    with pytest.raises(ValueError, match="not a serving bundle"):
        BackgroundRemoval.from_serving_bundle(tmp_path / "missing", device="cpu")


def test_bf16_weights_round_trip_exactly(bundle16):
    """bf16 weights are stored as fp32 and come back bit for bit: the
    loaded model equals the model prepared at export."""
    ref = _model().prepare_serving_(torch.bfloat16)
    got = load_serving_bundle(bundle16).model
    ref_sd, got_sd = ref.state_dict(), got.state_dict()
    assert ref_sd.keys() == got_sd.keys()
    for k in ref_sd:
        assert got_sd[k].dtype == torch.bfloat16 == ref_sd[k].dtype, k
        assert torch.equal(got_sd[k], ref_sd[k]), k


def test_dtype_and_device_conflicts_raise(bundle32, tmp_path):
    with pytest.raises(ValueError, match="conflicts"):
        BackgroundRemoval.from_serving_bundle(bundle32, device="cpu",
                                              dtype="bfloat16")
    # The bundle was exported on the CPU: a CUDA load raises before any
    # graph is read, on any host.
    with pytest.raises(ValueError, match="exported for 'cpu'"):
        load_serving_bundle(bundle32, device="cuda")
    # A bundle marked as exported on the card never runs on the CPU.
    card = tmp_path / "card"
    shutil.copytree(bundle32, card)
    meta = json.loads((card / "meta.json").read_text())
    meta["device"] = "cuda"
    (card / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        BackgroundRemoval.from_serving_bundle(card, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eager_answer_unchanged_after_export(dtype, image, tmp_path):
    """An export fills no cache with the trace's fake tensors: with the
    RoPE-table cache empty, a model exported without given tables (the
    tables built in the trace) and then run eagerly answers as before."""
    from s3od_torch.models import dinov3

    pred = BackgroundRemoval(str(TINY), image_size=SIZE, device="cpu",
                             dtype=dtype)
    before = pred.remove_background(image)
    dinov3._full_tables.cache_clear()

    class Plain(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            return self.model(x, serving_fast_output=True)["pred_masks"]

    x = torch.zeros(1, SIZE, SIZE, 3, dtype=pred.compute_dtype)
    with torch.no_grad():
        torch.export.export(Plain(pred.model), (x,))
    assert dinov3._full_tables.cache_info().currsize == 0
    save_serving_bundle(tmp_path / "b", pred.model, image_size=SIZE,
                        batches=(1,), dtype=dtype, device="cpu",
                        payloads=("best",))
    after = pred.remove_background(image)
    np.testing.assert_array_equal(after.all_masks, before.all_masks)
    np.testing.assert_array_equal(after.all_ious, before.all_ious)
