"""Serving bundles: the serving forward exported ahead of time with
`torch.export`, beside the prepared weights (counterpart of
`s3od_tpu/aot.py:123-322`).

A bundle is a directory:

    weights.npz                the prepared serving tree (BN folded, cast
                               to the bundle's dtype), through
                               `convert.save_native` in the JAX layout;
                               bf16 leaves stored as fp32, which is exact
    meta.json                  format, image size, dtype, batches and
                               payloads, the device the graphs were
                               exported for, the decoder gates at export
    serving_b{N}[.{payload}].pt2
                               one `torch.export` graph per (batch,
                               payload) ("full" has no suffix)

The graphs hold no weights. Each is the export of `ServingGraph`, a
function of (weights, inputs, images): `weights` the model's parameters
and buffers by name, `inputs` the normalisation constants and the
encoder's RoPE tables (made once at load, outside the trace, by the
calls the eager forward makes), `images` (B, S, S, 3) uint8 canvases.
A ViT-B bundle thus holds its 116.1 M parameters once, in
`weights.npz`, as the JAX graphs take (params, state, images).

A loaded graph (`GraphRunner`) is read from disk at its first call, so a
fresh process pays only for the graphs it runs, and is then called with
its flat inputs, bound once: the exported module's own entry would
flatten ~330 weights and check each one's shape and device on every
call, milliseconds of host time a forward. Its `s3od::` op calls become
direct calls of the functions the ops run (`_build.OP_FUNCTIONS`), as
in the eager forward, which saves the ops' dispatch (~20 us each, ~55 a
ViT-B forward).

The serving kernels reach a graph as the registered ops `s3od::*`
(`s3od_torch/_build.py`), since the ctypes launches cannot run on the
trace's fake tensors. The routes resolve while the graph is traced: a
bundle exported on the CPU runs the plain versions behind those ops, one
exported on the card the kernels, and the decoder gates (`S3OD_WINOGRAD`,
`models.dpt.MASK_TAIL_FUSED`) are baked in as they stood. So a bundle
records its device, and loading it for another device raises: a graph
is never run on a device it was not exported for.

Not ported from `s3od_tpu/aot.py`: `enable_compilation_cache` (XLA's
persistent compile cache) and `device_put_packed` (one upload per dtype
to save relay round trips). Eager PyTorch compiles no graph, the kernel
library is cached by source hash under `build/`, and the weights load
from a local file onto a local card.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

# Registers every `s3od::` op of the serving graphs, which a loaded graph
# calls by name.
import s3od_torch.ops.attn_epilogue  # noqa: F401
import s3od_torch.ops.experimental.mask_tail  # noqa: F401
import s3od_torch.ops.flash_attention  # noqa: F401
import s3od_torch.ops.layernorm  # noqa: F401
import s3od_torch.ops.mlp_fused  # noqa: F401
import s3od_torch.ops.qkv_project  # noqa: F401
from s3od_torch import _build
from s3od_torch.convert import (convert_state_dict, load_native_segmentation,
                                save_native, state_dict_from_jax)
from s3od_torch.models import dpt
from s3od_torch.models.dinov3 import encoder_tables
from s3od_torch.models.segmentation import S3ODSegmentation
from s3od_torch.ops import conv as conv_ops
from s3od_torch.predictor import (_DTYPES, IMAGENET_MEAN, IMAGENET_STD,
                                  serving_forward)

FORMAT = "s3od_torch.serving_bundle.v1"


def serving_tree(model: S3ODSegmentation):
    """(params, state, cfg) of a prepared model in the JAX layout, with
    `use_bn` False once its BatchNorms are folded (state is None then):
    the tree `weights.npz` holds."""
    folded = not any(isinstance(m, torch.nn.BatchNorm2d)
                     for m in model.modules())
    cfg = dataclasses.replace(model.cfg, use_bn=model.cfg.use_bn and not folded)
    return convert_state_dict(model.state_dict(), cfg)


def graph_weights(model: S3ODSegmentation) -> Dict[str, torch.Tensor]:
    """The weights input of a serving graph: every parameter and buffer of
    the prepared model, by name."""
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    return {k: v.detach() for k, v in named.items()}


def graph_inputs(model: S3ODSegmentation, image_size: int
                 ) -> Dict[str, torch.Tensor]:
    """The other tensors a serving graph takes: the normalisation constants
    and the RoPE tables of the encoder at `image_size`, made by the calls
    the eager forward makes (so both routes read the same bits)."""
    p = next(model.parameters())
    route = "kernel" if p.dtype == torch.bfloat16 else "exact"
    cos, sin = encoder_tables(model.cfg.encoder, image_size, image_size,
                              route, p.device)
    return {"mean": torch.tensor(IMAGENET_MEAN * 255.0, device=p.device),
            "inv_std": torch.tensor(1.0 / (IMAGENET_STD * 255.0),
                                    device=p.device),
            "rope_cos": cos, "rope_sin": sin}


class ServingGraph(torch.nn.Module):
    """What `torch.export` traces: the serving forward of `model` as a
    function of (weights, inputs, images). The model is held outside the
    module's registry, so the export lifts none of its weights."""

    def __init__(self, model: S3ODSegmentation, payload: str):
        super().__init__()
        self.__dict__["served"] = model
        self.payload = payload
        self.dtype = next(model.parameters()).dtype

    def forward(self, weights: Dict[str, torch.Tensor],
                inputs: Dict[str, torch.Tensor], images: torch.Tensor):
        tables = (inputs["rope_cos"], inputs["rope_sin"])

        def run(x):
            return torch.func.functional_call(
                self.served, weights, (x,),
                {"serving_fast_output": True, "rope_tables": tables})

        return serving_forward(run, images, inputs["mean"], inputs["inv_std"],
                               self.dtype, self.payload)


def drop_noop_casts(ep) -> int:
    """Remove from an exported graph each cast of a tensor to the dtype it
    has (the model's `weight.to(x.dtype)` on weights prepared in that
    dtype) with the dtype assertion export puts before it: ~600 calls a
    ViT-B forward that change no value and cost ~3 ms of host time.
    Returns the number of casts removed."""
    graph = ep.graph_module.graph
    cast = torch.ops.aten.to.dtype
    check = torch.ops.aten._assert_tensor_metadata.default
    removed = 0
    for node in list(graph.nodes):
        if node.op != "call_function" or node.target is not cast:
            continue
        src = node.args[0]
        if node.kwargs or len(node.args) != 2 or src.meta["val"].dtype != node.args[1]:
            continue
        prev = node.prev
        node.replace_all_uses_with(src)
        graph.erase_node(node)
        if (prev.op == "call_function" and prev.target is check
                and prev.args == (src,) and not prev.users):
            graph.erase_node(prev)
        removed += 1
    ep.graph_module.recompile()
    return removed


def export_serving(model: S3ODSegmentation, *, image_size: int, batch: int,
                   payload: str = "full"):
    """Export the serving forward of a prepared model (on its device, in
    its dtype) for one (batch, payload) -> `torch.export.ExportedProgram`,
    its no-op casts removed (`drop_noop_casts`)."""
    p = next(model.parameters())
    images = torch.zeros((batch, image_size, image_size, 3), dtype=torch.uint8,
                         device=p.device)
    with torch.no_grad():
        ep = torch.export.export(
            ServingGraph(model, payload),
            (graph_weights(model), graph_inputs(model, image_size), images))
    drop_noop_casts(ep)
    return ep


def graph_name(batch: int, payload: str) -> str:
    suffix = "" if payload == "full" else f".{payload}"
    return f"serving_b{batch}{suffix}.pt2"


@contextlib.contextmanager
def decoder_gates(winograd: bool, mask_tail: bool):
    """The decoder's two gates set as given for the scope, then restored."""
    old = conv_ops._WINOGRAD_ENABLED, dpt.MASK_TAIL_FUSED
    conv_ops._WINOGRAD_ENABLED, dpt.MASK_TAIL_FUSED = winograd, mask_tail
    try:
        yield
    finally:
        conv_ops._WINOGRAD_ENABLED, dpt.MASK_TAIL_FUSED = old


class GraphRunner:
    """One serving graph of a bundle bound to the prepared model's weights:
    `runner(images)` -> (masks, ious), as `serving_forward` gives them.
    The graph is read at the first call (under a lock: stream workers may
    call at once); its input structure must be the model's, or the load
    raises."""

    def __init__(self, path: Path, model: S3ODSegmentation, image_size: int):
        self.path, self.model, self.image_size = Path(path), model, image_size
        self._lock = threading.Lock()
        self._module = None
        self._inputs: list = []

    def _load(self) -> None:
        ep = torch.export.load(str(self.path))
        if ep.state_dict or ep.constants:
            raise ValueError(f"{self.path} holds tensors: not a serving graph")
        dummy = torch.empty(0)
        flat, spec = pytree.tree_flatten(((graph_weights(self.model),
                                           graph_inputs(self.model, self.image_size),
                                           dummy), {}))
        if spec != ep.call_spec.in_spec:
            raise ValueError(f"{self.path}: the graph's inputs are not the "
                             "bundle model's")
        module = ep.graph_module
        for node in module.graph.nodes:
            if node.op == "call_function" and node.target in _build.OP_FUNCTIONS:
                node.target = _build.OP_FUNCTIONS[node.target]
        module.recompile()
        self._inputs = flat[:-1]
        self._module = module

    def __call__(self, images: torch.Tensor):
        if self._module is None:
            with self._lock:
                if self._module is None:
                    self._load()
        return tuple(self._module(*self._inputs, images))


@dataclass
class ServingBundle:
    model: S3ODSegmentation   # prepared, on the bundle's device
    meta: dict
    graphs: Dict[Tuple[int, str], GraphRunner]  # (batch, payload) -> graph


def save_serving_bundle(
    path, model: S3ODSegmentation, *,
    image_size: int = 1024,
    batches: Sequence[int] = (1, 16),
    dtype: str = "bfloat16",
    device: str = "cuda",
    fold_bn: bool = True,
    payloads: Sequence[str] = ("full", "best"),
) -> Path:
    """Prepare a copy of `model` (a checkpoint's model; it is not changed)
    as the predictor does, write its weights, and export one graph per
    (batch, payload) on `device`. Returns the bundle directory; each
    graph's export seconds are in meta.json ("export_s").

    Export a bundle for the card on the card: the trace resolves each
    kernel's route by the device of its tensors, so a bundle exported on
    the CPU holds the plain versions (and is marked "cpu")."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
    dev = torch.device(device)
    prepared = copy.deepcopy(model).prepare_serving_(_DTYPES[dtype], fold_bn)
    prepared.to(dev)
    out = Path(path)
    out.mkdir(parents=True, exist_ok=True)
    params, state, cfg = serving_tree(prepared)
    save_native(str(out / "weights.npz"), params, state)

    payload_map: Dict[str, list] = {}
    export_s: Dict[str, float] = {}
    for payload in payloads:
        for b in batches:
            t0 = time.perf_counter()
            ep = export_serving(prepared, image_size=image_size, batch=b,
                                payload=payload)
            # The example inputs hold the weights: saved, they would
            # repeat weights.npz in every graph.
            ep.example_inputs = None
            torch.export.save(ep, str(out / graph_name(b, payload)))
            export_s[graph_name(b, payload)] = time.perf_counter() - t0
            payload_map.setdefault(payload, []).append(b)
    meta = {
        "format": FORMAT,
        "encoder_hidden": cfg.encoder.hidden_size,
        "use_bn": cfg.use_bn,  # False once fold_bn ran
        "image_size": image_size,
        "dtype": dtype,
        "batches": payload_map.get("full", []),
        "payloads": payload_map,
        "device": dev.type,
        "gates": {"winograd": bool(conv_ops._WINOGRAD_ENABLED),
                  "mask_tail": bool(dpt.MASK_TAIL_FUSED)},
        "torch": torch.__version__,
        "export_s": export_s,
    }
    (out / "meta.json").write_text(json.dumps(meta, indent=2))
    return out


def load_serving_bundle(path, device: Optional[str] = None) -> ServingBundle:
    """Load a bundle: the prepared model on `device` (default: the one the
    graphs were exported for) and a `GraphRunner` per graph, which reads
    its graph at its first call. Raises `ValueError` when `device` is not
    of the type the graphs were exported for."""
    p = Path(path)
    meta_path = p / "meta.json"
    meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a serving bundle: {p}")
    dev = torch.device(device or meta["device"])
    if dev.type != meta["device"]:
        raise ValueError(
            f"the serving bundle {p} was exported for {meta['device']!r} and "
            f"cannot run on {dev.type!r}: its graphs hold that device's "
            "routes; export a bundle on this device instead")
    params, state, cfg = load_native_segmentation(p / "weights.npz")
    cfg = dataclasses.replace(cfg, use_bn=meta["use_bn"])
    model = S3ODSegmentation(cfg)
    model.load_state_dict(state_dict_from_jax(params, state), strict=True)
    model.prepare_serving_(_DTYPES[meta["dtype"]], fold_bn=False).to(dev)
    graphs = {(b, payload): GraphRunner(p / graph_name(b, payload), model,
                                        meta["image_size"])
              for payload, batches in meta["payloads"].items() for b in batches}
    return ServingBundle(model, meta, graphs)


def _diff(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max())


@torch.inference_mode()
def verify_bundle(bundle: ServingBundle, n: int = 2, tol: float = 1e-5,
                  seed: int = 0) -> float:
    """Hold every graph against the eager serving forward (with the
    bundle's decoder gates) on `n` random uint8 batches. Returns the worst
    max-abs difference; raises `AssertionError` over `tol`. On "best", a
    difference of one uint8 step is benign (a mask value at a rounding
    boundary), as in `s3od_tpu/aot.py:verify_bundle`; larger ones count."""
    model = bundle.model
    size = bundle.meta["image_size"]
    dtype = _DTYPES[bundle.meta["dtype"]]
    dev = next(model.parameters()).device
    inputs = graph_inputs(model, size)
    gates = bundle.meta["gates"]
    gen = torch.Generator().manual_seed(seed)
    worst = 0.0
    with decoder_gates(gates["winograd"], gates["mask_tail"]):
        for (b, payload), graph in bundle.graphs.items():
            for _ in range(n):
                imgs = torch.randint(0, 255, (b, size, size, 3), generator=gen,
                                     dtype=torch.uint8).to(dev)
                got_m, got_i = graph(imgs)
                ref_m, ref_i = serving_forward(
                    lambda x: model(x, serving_fast_output=True), imgs,
                    inputs["mean"], inputs["inv_std"], dtype, payload)
                mask_diff = _diff(got_m, ref_m)
                if payload != "full" and mask_diff <= 1.0:
                    mask_diff = 0.0
                worst = max(worst, mask_diff, _diff(got_i, ref_i))
    if worst > tol:
        raise AssertionError(
            f"bundle verification failed: max-abs-diff {worst:.2e} > {tol}")
    return worst
