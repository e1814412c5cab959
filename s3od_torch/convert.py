"""Weights carried across: JAX pytrees, native `.npz` files and reference
`.pt` files <-> the port's state dict (the port's own copy of the parts of
`s3od_tpu/convert.py` it needs, under the same names).

The port's modules use the reference checkpoint's parameter names, so a
reference `{'state_dict': ...}` loads as it is. The JAX package's param
pytree differs in layout:

- Linear `weight` (out, in)            -> kernel (in, out)
- Conv2d `weight` (out, in, kh, kw)    -> kernel (kh, kw, in, out)  [HWIO]
- patch embed conv (hid, 3, p, p)      -> kernel (p*p*3, hid), (kh, kw, c) order
- ConvT k==s (in, out, k, k)           -> kernel (in, k*k*out)
- ConvT k=4 s=2 p=1 (in, out, 4, 4)    -> spatially-flipped equivalent forward
  conv HWIO (4, 4, in, out)
- BatchNorm weight/bias -> params; running_mean/var -> state

`convert_state_dict` maps a state dict to that pytree and
`export_torch_state_dict` maps it back; `save_native` / `load_native` keep
the pytree in the JAX package's flat `.npz` format, which both packages
read (`load_native_segmentation` infers the configuration).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s3od_torch.configs import (
    SegmentationConfig,
    segmentation_config,
    tiny_test_config,
)


def _t(arr) -> np.ndarray:
    """torch tensor or numpy array -> numpy float32."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().float().cpu().numpy()
    return np.asarray(arr, dtype=np.float32)


def _linear(sd: Dict, prefix: str, bias: bool = True) -> dict:
    p = {"kernel": np.asarray(_t(sd[prefix + ".weight"]).T)}
    if bias and prefix + ".bias" in sd:
        p["bias"] = np.asarray(_t(sd[prefix + ".bias"]))
    return p


def _conv(sd: Dict, prefix: str) -> dict:
    w = _t(sd[prefix + ".weight"])  # (out, in, kh, kw)
    p = {"kernel": np.asarray(w.transpose(2, 3, 1, 0))}
    if prefix + ".bias" in sd:
        p["bias"] = np.asarray(_t(sd[prefix + ".bias"]))
    return p


def _convt_block(sd: Dict, prefix: str, factor: int) -> dict:
    w = _t(sd[prefix + ".weight"])  # (in, out, k, k), k == factor
    cin, cout = w.shape[0], w.shape[1]
    # (in, out, kh, kw) -> (in, kh, kw, out) -> (in, k*k*out)
    w = w.transpose(0, 2, 3, 1).reshape(cin, factor * factor * cout)
    return {
        "kernel": np.asarray(w),
        "bias": np.asarray(_t(sd[prefix + ".bias"])),
    }


def _convt_general(sd: Dict, prefix: str) -> dict:
    w = _t(sd[prefix + ".weight"])  # (in, out, kh, kw)
    # Equivalent forward conv: flip spatial, treat as (kh, kw, in, out) HWIO.
    w = w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return {
        "kernel": np.asarray(np.ascontiguousarray(w)),
        "bias": np.asarray(_t(sd[prefix + ".bias"])),
    }


def _bn(sd: Dict, prefix: str) -> Tuple[dict, dict]:
    p = {
        "weight": np.asarray(_t(sd[prefix + ".weight"])),
        "bias": np.asarray(_t(sd[prefix + ".bias"])),
    }
    s = {
        "mean": np.asarray(_t(sd[prefix + ".running_mean"])),
        "var": np.asarray(_t(sd[prefix + ".running_var"])),
    }
    return p, s


def _fused_qkv(sd: Dict, prefix: str) -> dict:
    """Concatenate q/k/v projections into one (C, 3C) kernel. Missing
    biases (key_bias=False) become zeros — numerically identical."""
    kernels, biases = [], []
    dim = _t(sd[prefix + ".q_proj.weight"]).shape[1]
    for name in ("q_proj", "k_proj", "v_proj"):
        kernels.append(_t(sd[f"{prefix}.{name}.weight"]).T)
        bkey = f"{prefix}.{name}.bias"
        biases.append(
            _t(sd[bkey]) if bkey in sd else np.zeros((dim,), np.float32)
        )
    return {
        "kernel": np.asarray(np.concatenate(kernels, axis=1)),
        "bias": np.asarray(np.concatenate(biases)),
    }


def convert_encoder(sd: Dict, cfg) -> dict:
    """`encoder.*` keys of the state_dict -> encoder param pytree."""
    pe_w = _t(sd["encoder.embeddings.patch_embeddings.weight"])  # (hid,3,p,p)
    hid = pe_w.shape[0]
    # (hid, c, kh, kw) -> (kh, kw, c, hid) -> (kh*kw*c, hid)
    pe_k = pe_w.transpose(2, 3, 1, 0).reshape(-1, hid)

    blocks = []
    i = 0
    while f"encoder.layer.{i}.norm1.weight" in sd:
        pre = f"encoder.layer.{i}"
        blocks.append(
            {
                "norm1": {
                    "weight": np.asarray(_t(sd[f"{pre}.norm1.weight"])),
                    "bias": np.asarray(_t(sd[f"{pre}.norm1.bias"])),
                },
                "attention": {
                    "qkv": _fused_qkv(sd, f"{pre}.attention"),
                    "o_proj": _linear(sd, f"{pre}.attention.o_proj"),
                },
                "ls1": np.asarray(_t(sd[f"{pre}.layer_scale1.lambda1"])),
                "norm2": {
                    "weight": np.asarray(_t(sd[f"{pre}.norm2.weight"])),
                    "bias": np.asarray(_t(sd[f"{pre}.norm2.bias"])),
                },
                "mlp": {
                    "up_proj": _linear(sd, f"{pre}.mlp.up_proj"),
                    "down_proj": _linear(sd, f"{pre}.mlp.down_proj"),
                },
                "ls2": np.asarray(_t(sd[f"{pre}.layer_scale2.lambda1"])),
            }
        )
        i += 1

    return {
        "cls_token": np.asarray(_t(sd["encoder.embeddings.cls_token"])),
        "register_tokens": np.asarray(_t(sd["encoder.embeddings.register_tokens"])),
        "patch_embed": {
            "kernel": np.asarray(pe_k),
            "bias": np.asarray(_t(sd["encoder.embeddings.patch_embeddings.bias"])),
        },
        "blocks": blocks,
    }


def convert_head(sd: Dict, cfg: SegmentationConfig) -> Tuple[dict, Optional[dict]]:
    """`seg_head.*` keys -> (head params, bn state)."""

    def rcu(prefix):
        p = {"conv1": _conv(sd, prefix + ".conv1"), "conv2": _conv(sd, prefix + ".conv2")}
        s = None
        if cfg.use_bn:
            p["bn1"], s1 = _bn(sd, prefix + ".bn1")
            p["bn2"], s2 = _bn(sd, prefix + ".bn2")
            s = {"bn1": s1, "bn2": s2}
        return p, s

    def refinenet(prefix):
        p1, s1 = rcu(prefix + ".resConfUnit1")
        p2, s2 = rcu(prefix + ".resConfUnit2")
        p = {"out_conv": _conv(sd, prefix + ".out_conv"), "rcu1": p1, "rcu2": p2}
        s = {"rcu1": s1, "rcu2": s2} if cfg.use_bn else None
        return p, s

    params = {
        "projects": [_conv(sd, f"seg_head.projects.{i}") for i in range(4)],
        "resize": [
            _convt_block(sd, "seg_head.resize_layers.0", 4),
            _convt_block(sd, "seg_head.resize_layers.1", 2),
            None,
            _conv(sd, "seg_head.resize_layers.3"),
        ],
        "scratch": {
            f"layer{i + 1}_rn": _conv(sd, f"seg_head.scratch.layer{i + 1}_rn")
            for i in range(4)
        },
        "classifier": {
            "fc1": _linear(sd, "seg_head.classifier_head.2"),
            "fc2": _linear(sd, "seg_head.classifier_head.4"),
        },
        "mask_head": {
            "output_conv1": _conv(sd, "seg_head.mask_head.output_conv1"),
            "up_deconv": _convt_general(sd, "seg_head.mask_head.upsample_2x.0"),
            "up_conv": _conv(sd, "seg_head.mask_head.upsample_2x.2"),
            "heads": [
                {
                    "conv0": _conv(sd, f"seg_head.mask_head.mask_heads.{i}.0"),
                    "conv1": _conv(sd, f"seg_head.mask_head.mask_heads.{i}.2"),
                }
                for i in range(cfg.num_outputs)
            ],
        },
    }
    state = {} if cfg.use_bn else None
    for i in (1, 2, 3, 4):
        p, s = refinenet(f"seg_head.scratch.refinenet{i}")
        params[f"refinenet{i}"] = p
        if cfg.use_bn:
            state[f"refinenet{i}"] = s
    return params, state


def convert_state_dict(
    sd: Dict, cfg: Optional[SegmentationConfig] = None
) -> Tuple[dict, Optional[dict], SegmentationConfig]:
    """Full state dict (torch tensors or numpy arrays) -> (params,
    bn_state, cfg)."""
    if cfg is None:
        cfg = config_from_state_dict(sd)
    head_params, state = convert_head(sd, cfg)
    params = {"encoder": convert_encoder(sd, cfg.encoder), "head": head_params}
    return params, state, cfg


# Keys of an HF DINOv3 checkpoint that the JAX package's converter does not
# read (`s3od_tpu/convert.py:101-144`): the mask token and the final
# LayerNorm, dead for the DPT taps. The port's encoder keeps its own.
HF_UNREAD = ("embeddings.mask_token", "norm.weight", "norm.bias")


def load_hf_dinov3(path: str) -> Dict[str, torch.Tensor]:
    """Pretrained DINOv3 encoder weights (`s3od_tpu.convert.load_hf_dinov3`)
    from a local HF snapshot directory (`model.safetensors` or
    `pytorch_model.bin`), a `.safetensors` file or a `.bin` file -> the HF
    state dict, whose keys are the port encoder's (the `encoder.*` subtree
    without the prefix). The reference pulls these through
    `AutoModel.from_pretrained` (`model_training/model.py:14,25`); the
    port makes no network call, so a hub id raises."""
    p = Path(path)
    if p.is_dir():
        for name in ("model.safetensors", "pytorch_model.bin"):
            if (p / name).exists():
                p = p / name
                break
    if not p.is_file():
        raise FileNotFoundError(
            f"pretrained_encoder {path!r} is not a local HF snapshot "
            "directory, .safetensors or .bin file; hub ids are not "
            "downloaded (no network): fetch the snapshot first and pass "
            "its directory")
    if p.suffix == ".safetensors":
        from safetensors.torch import load_file

        return load_file(str(p))
    return torch.load(str(p), map_location="cpu", weights_only=True)


def load_hf_encoder_(encoder: torch.nn.Module, path: str) -> torch.nn.Module:
    """Copy `load_hf_dinov3(path)` into the port's `DINOv3Encoder`: every
    weight the JAX converter reads must be present (`KeyError` otherwise),
    keys it does not read are ignored as it ignores them, and a key bias
    (which the JAX converter would fuse into the qkv bias, and the
    reference layout cannot hold) must be zero."""
    sd = load_hf_dinov3(path)
    want = [k for k in encoder.state_dict() if k not in HF_UNREAD]
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{path}: not a DINOv3 checkpoint of this width and "
                       f"depth, missing {missing[:4]}")
    for k, v in sd.items():
        if k.endswith("attention.k_proj.bias") and float(v.abs().max()) > 1e-6:
            raise ValueError(f"{path}: {k} is nonzero; the encoder has no "
                             "key bias")
    encoder.load_state_dict({k: sd[k].float() for k in want}, strict=False)
    return encoder


def export_torch_state_dict(params: dict, state: Optional[dict]) -> Dict:
    """Produce a state_dict in the exact layout `src/s3od/predictor.py:65-76`
    consumes, so checkpoints trained here load into the PyTorch reference.

    Returns numpy arrays; wrap with torch.from_numpy + {'state_dict': ...}
    for a reference-format .pt file.
    """
    sd: Dict[str, np.ndarray] = {}

    def put(key, arr):
        sd[key] = np.asarray(arr, dtype=np.float32)

    enc = params["encoder"]
    hid_dim = np.asarray(enc["cls_token"]).shape[-1]
    put("encoder.embeddings.cls_token", enc["cls_token"])
    put("encoder.embeddings.mask_token", np.zeros_like(np.asarray(enc["cls_token"])))
    # Final encoder LayerNorm: dead code for the DPT taps (hidden_states
    # [2,5,8,11] never pass through it) so we don't keep it — emit identity
    # values to satisfy the reference's strict load.
    put("encoder.norm.weight", np.ones((hid_dim,), np.float32))
    put("encoder.norm.bias", np.zeros((hid_dim,), np.float32))
    put("encoder.embeddings.register_tokens", enc["register_tokens"])
    pe = np.asarray(enc["patch_embed"]["kernel"])  # (p*p*3, hid)
    hid = pe.shape[1]
    patch = int(round((pe.shape[0] / 3) ** 0.5))
    put(
        "encoder.embeddings.patch_embeddings.weight",
        pe.reshape(patch, patch, 3, hid).transpose(3, 2, 0, 1),
    )
    put("encoder.embeddings.patch_embeddings.bias", enc["patch_embed"]["bias"])

    for i, blk in enumerate(enc["blocks"]):
        pre = f"encoder.layer.{i}"
        put(f"{pre}.norm1.weight", blk["norm1"]["weight"])
        put(f"{pre}.norm1.bias", blk["norm1"]["bias"])
        qkv_k = np.asarray(blk["attention"]["qkv"]["kernel"])  # (C, 3C)
        qkv_b = np.asarray(blk["attention"]["qkv"]["bias"])
        c = qkv_k.shape[0]
        for j, name in enumerate(("q_proj", "k_proj", "v_proj")):
            put(f"{pre}.attention.{name}.weight", qkv_k[:, j * c : (j + 1) * c].T)
            if name != "k_proj":
                put(f"{pre}.attention.{name}.bias", qkv_b[j * c : (j + 1) * c])
            else:
                # key_bias=False in the reference config, so the .pt format
                # cannot represent a key bias. It is NOT droppable when
                # nonzero: RoPE rotates keys AFTER the projection, so the
                # bias contributes a position-dependent q.R_j.b term to the
                # logits. Training keeps this segment frozen at zero
                # (training/optim.py, the key-bias freeze); fail loudly if it drifted.
                k_bias = qkv_b[j * c : (j + 1) * c]
                if float(np.abs(k_bias).max()) > 1e-6:
                    raise ValueError(
                        f"layer {i}: fused-QKV key-bias segment is nonzero "
                        f"(max |b_k| = {float(np.abs(k_bias).max()):.2e}); "
                        "the reference .pt format has key_bias=False and a "
                        "nonzero key bias changes outputs under RoPE. "
                        "Retrain with the key-bias freeze or zero it "
                        "explicitly before export."
                    )
        put(f"{pre}.attention.o_proj.weight",
            np.asarray(blk["attention"]["o_proj"]["kernel"]).T)
        put(f"{pre}.attention.o_proj.bias", blk["attention"]["o_proj"]["bias"])
        put(f"{pre}.layer_scale1.lambda1", blk["ls1"])
        put(f"{pre}.norm2.weight", blk["norm2"]["weight"])
        put(f"{pre}.norm2.bias", blk["norm2"]["bias"])
        put(f"{pre}.mlp.up_proj.weight", np.asarray(blk["mlp"]["up_proj"]["kernel"]).T)
        put(f"{pre}.mlp.up_proj.bias", blk["mlp"]["up_proj"]["bias"])
        put(f"{pre}.mlp.down_proj.weight",
            np.asarray(blk["mlp"]["down_proj"]["kernel"]).T)
        put(f"{pre}.mlp.down_proj.bias", blk["mlp"]["down_proj"]["bias"])
        put(f"{pre}.layer_scale2.lambda1", blk["ls2"])

    head = params["head"]

    def conv_out(key, p):
        put(key + ".weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            put(key + ".bias", p["bias"])

    for i in range(4):
        conv_out(f"seg_head.projects.{i}", head["projects"][i])
    for i, factor in ((0, 4), (1, 2)):
        k = np.asarray(head["resize"][i]["kernel"])  # (in, f*f*out)
        cin = k.shape[0]
        cout = k.shape[1] // (factor * factor)
        put(
            f"seg_head.resize_layers.{i}.weight",
            k.reshape(cin, factor, factor, cout).transpose(0, 3, 1, 2),
        )
        put(f"seg_head.resize_layers.{i}.bias", head["resize"][i]["bias"])
    conv_out("seg_head.resize_layers.3", head["resize"][3])
    for i in range(4):
        put(
            f"seg_head.scratch.layer{i + 1}_rn.weight",
            np.asarray(head["scratch"][f"layer{i + 1}_rn"]["kernel"]).transpose(3, 2, 0, 1),
        )

    def bn_out(key, p, s):
        put(key + ".weight", p["weight"])
        put(key + ".bias", p["bias"])
        put(key + ".running_mean", s["mean"])
        put(key + ".running_var", s["var"])
        sd[key + ".num_batches_tracked"] = np.zeros((), dtype=np.int64)

    for i in (1, 2, 3, 4):
        rn = head[f"refinenet{i}"]
        rs = state[f"refinenet{i}"] if state else None
        base = f"seg_head.scratch.refinenet{i}"
        conv_out(base + ".out_conv", rn["out_conv"])
        for rcu_name, ref_name in (("rcu1", "resConfUnit1"), ("rcu2", "resConfUnit2")):
            conv_out(f"{base}.{ref_name}.conv1", rn[rcu_name]["conv1"])
            conv_out(f"{base}.{ref_name}.conv2", rn[rcu_name]["conv2"])
            if "bn1" in rn[rcu_name]:
                bn_out(f"{base}.{ref_name}.bn1", rn[rcu_name]["bn1"],
                       rs[rcu_name]["bn1"])
                bn_out(f"{base}.{ref_name}.bn2", rn[rcu_name]["bn2"],
                       rs[rcu_name]["bn2"])

    mh = head["mask_head"]
    conv_out("seg_head.mask_head.output_conv1", mh["output_conv1"])
    # up_deconv stored as flipped-HWIO of the equivalent forward conv; invert:
    k = np.asarray(mh["up_deconv"]["kernel"])  # (4,4,in,out)
    put(
        "seg_head.mask_head.upsample_2x.0.weight",
        k[::-1, ::-1].transpose(2, 3, 0, 1),
    )
    put("seg_head.mask_head.upsample_2x.0.bias", mh["up_deconv"]["bias"])
    conv_out("seg_head.mask_head.upsample_2x.2", mh["up_conv"])
    for i, h in enumerate(mh["heads"]):
        conv_out(f"seg_head.mask_head.mask_heads.{i}.0", h["conv0"])
        conv_out(f"seg_head.mask_head.mask_heads.{i}.2", h["conv1"])

    put("seg_head.classifier_head.2.weight",
        np.asarray(head["classifier"]["fc1"]["kernel"]).T)
    put("seg_head.classifier_head.2.bias", head["classifier"]["fc1"]["bias"])
    put("seg_head.classifier_head.4.weight",
        np.asarray(head["classifier"]["fc2"]["kernel"]).T)
    put("seg_head.classifier_head.4.bias", head["classifier"]["fc2"]["bias"])
    return sd


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix[:-1] + "#none"] = np.zeros((0,), np.float32)
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for key, val in flat.items():
        is_none = key.endswith("#none")
        if is_none:
            key = key[: -len("#none")]
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = None if is_none else np.asarray(val)

    def listify(node):
        if isinstance(node, dict):
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def save_native(path: str, params: dict, state: Optional[dict] = None) -> None:
    flat = _flatten({"params": params, "state": state})
    np.savez(path, **flat)


def load_native(path: str):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    return tree["params"], tree.get("state")



# hidden size -> named encoder variant (`configs.py` family)
_HIDDEN_TO_ENCODER = {384: "dinov3_small", 768: "dinov3_base",
                      1024: "dinov3_large"}


def load_native_segmentation(path: str):
    """Load a native .npz segmentation checkpoint and infer its config
    from the encoder width: -> (params, state, SegmentationConfig).
    Single source of truth for every predictor's npz-load path."""
    params, state = load_native(str(path))
    hid = int(np.asarray(params["encoder"]["cls_token"]).shape[-1])
    if hid == 64:
        # The deterministic tiny test model (configs.tiny_test_config) —
        # e.g. the committed trained fixture checkpoint
        # tests/fixture/tiny_s3od.npz.
        return params, state, tiny_test_config(
            num_layers=len(params["encoder"]["blocks"]))
    if hid not in _HIDDEN_TO_ENCODER:
        raise ValueError(
            f"unknown encoder hidden size {hid} in {path}; known: "
            f"{sorted(_HIDDEN_TO_ENCODER)} and 64 (tiny test config)"
        )
    return params, state, segmentation_config(_HIDDEN_TO_ENCODER[hid])


def state_dict_from_jax(params: dict, state: Optional[dict]) -> Dict[str, torch.Tensor]:
    """JAX params/BN-state pytree (numpy arrays, as `load_native` returns
    them) -> the port's state dict, loadable with `strict=True`."""
    return {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in export_torch_state_dict(params, state).items()
    }


def config_from_state_dict(sd: Dict[str, torch.Tensor]) -> SegmentationConfig:
    """Infer the configuration from the encoder width, as
    `load_native_segmentation` does (width 64 is the tiny test model, whose
    depth is read from the layer count)."""
    hid = int(sd["encoder.embeddings.cls_token"].shape[-1])
    if hid == 64:
        n = sum(1 for k in sd if k.startswith("encoder.layer.")
                and k.endswith(".norm1.weight"))
        return tiny_test_config(num_layers=n)
    if hid not in _HIDDEN_TO_ENCODER:
        raise ValueError(f"unknown encoder hidden size {hid}")
    return segmentation_config(_HIDDEN_TO_ENCODER[hid])


def load_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], SegmentationConfig]:
    """A reference `.pt` ({'state_dict': ...}, Lightning 'model.' prefix
    allowed) or a JAX `.npz` -> (state dict, config)."""
    path = Path(path)
    if path.suffix == ".npz":
        params, state, cfg = load_native_segmentation(str(path))
        return state_dict_from_jax(params, state), cfg
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    if any(k.startswith("model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    return sd, config_from_state_dict(sd)


# ----------------------------------------------------------------------------
# Factory models: MMDiT, T5, CLIP, VAE trees and the teacher's fusion
# ----------------------------------------------------------------------------
#
# The factory modules name their parameters after the JAX pytree paths, so
# one rule carries every tree across: the path joined by '.', `kernel`
# becoming `weight` — (din, dout) -> (dout, din) for a linear, HWIO -> OIHW
# for a conv. Configurations may ride beside the weights in the `.npz`'s
# state, as {"config": {field: value}}.

# Int8 residency (`ops/quant.py`): a node's `kernel_q` (din, dout) int8 and
# `kernel_scale` (dout,) fp32 are a `QuantLinear`'s `weight_q` (dout, din)
# and `weight_scale`, kept in their dtypes.
_QUANT_TO_SD = {"kernel_q": "weight_q", "kernel_scale": "weight_scale"}
_SD_TO_QUANT = {v: k for k, v in _QUANT_TO_SD.items()}


def tree_to_state_dict(tree) -> Dict[str, torch.Tensor]:
    """A JAX param tree (numpy leaves) -> a state dict of float32 tensors
    (int8 for a quantized kernel)."""
    sd = {}
    for key, arr in _flatten(tree).items():
        if key.endswith("#none"):
            continue
        parts = key.split("/")
        leaf = parts[-1]
        parts[-1] = _QUANT_TO_SD.get(leaf, "weight" if leaf == "kernel"
                                     else leaf)
        arr = np.asarray(arr, np.int8 if leaf == "kernel_q" else np.float32)
        if leaf in ("kernel", "kernel_q"):
            # one writable copy in the torch layout
            arr = np.ascontiguousarray(
                arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1))
        else:
            arr = np.array(arr)  # a writable copy
        sd[".".join(parts)] = torch.from_numpy(arr)
    return sd


def state_dict_to_tree(sd: Dict[str, torch.Tensor]):
    """Inverse of `tree_to_state_dict`: numpy float32 leaves (int8 for a
    quantized kernel)."""
    flat = {}
    for name, t in sd.items():
        parts = name.split(".")
        if parts[-1] == "weight_q":
            arr = t.detach().cpu().numpy().T
        else:
            arr = t.detach().float().cpu().numpy()
        if parts[-1] in _SD_TO_QUANT:
            parts[-1] = _SD_TO_QUANT[parts[-1]]
        elif parts[-1] == "weight" and arr.ndim >= 2:
            parts[-1] = "kernel"
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        flat["/".join(parts)] = np.ascontiguousarray(arr)
    return _unflatten(flat)


def quantized_paths(tree, prefix: str = "") -> list:
    """Module paths ('dual_blocks.0.img_attn.qkv', ...) of a tree's nodes
    that hold `kernel_q`."""
    out = []
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            out.append(prefix[:-1])
        for k, v in tree.items():
            out += quantized_paths(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out += quantized_paths(v, f"{prefix}{i}.")
    return out


def load_tree_(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX tree into `module` (strict: every name must match)."""
    module.load_state_dict(tree_to_state_dict(tree), strict=True)
    return module


def config_to_meta(cfg) -> dict:
    return {f.name: np.asarray(getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


def config_from_meta(meta: Optional[dict], default):
    """The dataclass stored as `meta['config']`, or `default` if absent."""
    if not meta or "config" not in meta:
        return default
    vals = {}
    for f in dataclasses.fields(default):
        ref, arr = getattr(default, f.name), np.asarray(meta["config"][f.name])
        if isinstance(ref, tuple):
            vals[f.name] = tuple(int(x) for x in arr.ravel())
        else:
            vals[f.name] = type(ref)(arr.item())
    return dataclasses.replace(default, **vals)


def save_factory_npz(path: str, module: torch.nn.Module, cfg) -> None:
    """A factory module's weights and configuration, in the format
    `load_native` reads (and the JAX package's loaders take)."""
    save_native(path, state_dict_to_tree(module.state_dict()),
                {"config": config_to_meta(cfg)})


def load_mmdit(path: str, cfg=None, device=None, dtype=torch.float32):
    """MMDiT from a converted `.npz` (the JAX `init_mmdit_params` /
    `convert_flux.py` tree), made in `dtype` on `device`. Nodes holding
    `kernel_q` (a `quantize_tree_int8` tree) load as `QuantLinear`s and
    stay int8 on the device."""
    from s3od_torch.models.mmdit import MMDiT, MMDiTConfig, quantize_linears_

    tree, meta = load_native(path)
    cfg = cfg or config_from_meta(meta, MMDiTConfig())
    model = MMDiT(cfg, device="meta", dtype=dtype)
    quantize_linears_(model, set(quantized_paths(tree)))
    model = model.to_empty(device=device or "cpu")
    return load_tree_(model, tree).eval()


def load_t5(path: str, cfg=None):
    from s3od_torch.models.text_encoders import T5Config, T5Encoder

    tree, meta = load_native(path)
    cfg = cfg or config_from_meta(meta, T5Config())
    return load_tree_(T5Encoder(cfg), tree).eval()


def load_clip_text(path: str, cfg=None):
    from s3od_torch.models.text_encoders import CLIPTextConfig, CLIPTextEncoder

    tree, meta = load_native(path)
    cfg = cfg or config_from_meta(meta, CLIPTextConfig())
    return load_tree_(CLIPTextEncoder(cfg), tree).eval()


def load_vae_modules(path: str, cfg=None):
    """{'enc', 'dec'} trees -> (encoder, decoder, config)."""
    from s3od_torch.models.vae import VAEConfig, VAEDecoder, VAEEncoder

    tree, meta = load_native(path)
    cfg = cfg or config_from_meta(meta, VAEConfig())
    return (load_tree_(VAEEncoder(cfg), tree["enc"]).eval(),
            load_tree_(VAEDecoder(cfg), tree["dec"]).eval(), cfg)


def _fusion_part_sd(prefix: str, p: dict, s: Optional[dict], sd: Dict) -> None:
    """One fusion level's params/state subtree -> state-dict entries: convs
    by the shared rule, BatchNorms from params (weight, bias) and state
    (mean, var)."""
    for name, sub in p.items():
        key = f"{prefix}.{name}"
        if "kernel" in sub:  # a conv
            for k, v in tree_to_state_dict(sub).items():
                sd[f"{key}.{k}"] = v
        elif "weight" in sub:  # a BatchNorm
            st = s[name]
            for k, arr in (("weight", sub["weight"]), ("bias", sub["bias"]),
                           ("running_mean", st["mean"]),
                           ("running_var", st["var"])):
                sd[f"{key}.{k}"] = torch.from_numpy(
                    np.asarray(arr, dtype=np.float32).copy())
            sd[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        else:
            _fusion_part_sd(key, sub, s.get(name) if s else None, sd)


def teacher_config(params: dict, base: SegmentationConfig):
    """FluxTeacherConfig read off the fusion params' shapes."""
    from s3od_torch.models.flux_teacher import FluxTeacherConfig

    f0 = params["head"]["fusion"][0]
    kw = {"use_dino_features": "vit" in f0, "use_flux_features": "flux" in f0,
          "use_concept_maps": "concept" in f0}
    if "flux" in f0:
        kw["flux_dim"] = int(np.asarray(f0["flux"]["conv"]["kernel"]).shape[2])
    if "concept" in f0:
        kw["num_concept_channels"] = int(
            np.asarray(f0["concept"]["conv"]["kernel"]).shape[2])
    return FluxTeacherConfig(base=base, **kw)


def teacher_state_dict_from_jax(params: dict, state: dict) -> Dict[str, torch.Tensor]:
    """The JAX teacher's (params, BN state) -> the port's `FluxTeacher`
    state dict: the base model's names plus `fusion.{level}.*`."""
    sd = state_dict_from_jax(params, state)
    for i, (p, s) in enumerate(zip(params["head"]["fusion"], state["fusion"])):
        _fusion_part_sd(f"fusion.{i}", p, s, sd)
    return sd


def load_teacher(path: str):
    """A FLUX-teacher checkpoint (`.npz`, the JAX `save_native` format of
    `init_flux_teacher_params` / teacher training) -> FluxTeacher (eval,
    float32 weights)."""
    from s3od_torch.models.flux_teacher import FluxTeacher

    params, state, base = load_native_segmentation(path)
    model = FluxTeacher(teacher_config(params, base))
    model.load_state_dict(teacher_state_dict_from_jax(params, state), strict=True)
    return model.eval()


def teacher_tree_from_state_dict(sd: Dict[str, torch.Tensor]):
    """Inverse of `teacher_state_dict_from_jax` -> (params, state), for
    `save_native`."""
    base = {k: v for k, v in sd.items() if not k.startswith("fusion.")}
    params, state, _ = convert_state_dict(base)
    fus_p: Dict[int, dict] = {}
    fus_s: Dict[int, dict] = {}
    for name, t in sd.items():
        if not name.startswith("fusion."):
            continue
        parts = name.split(".")
        level, path, leaf = int(parts[1]), parts[2:-1], parts[-1]
        arr = t.detach().float().cpu().numpy()
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            node = fus_s.setdefault(level, {})
            leaf = "mean" if leaf == "running_mean" else "var"
        else:
            node = fus_p.setdefault(level, {})
            if leaf == "weight" and arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    params["head"]["fusion"] = [fus_p[i] for i in sorted(fus_p)]
    state = dict(state or {})
    state["fusion"] = [fus_s[i] for i in sorted(fus_s)]
    return params, state
