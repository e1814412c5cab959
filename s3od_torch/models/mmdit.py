"""FLUX-style MMDiT with a concept-attention stream, in PyTorch
(counterpart of `s3od_tpu/models/mmdit.py`).

- dual-stream blocks (text + image, joint attention, AdaLN-Zero
  modulation) with a THIRD concept stream that uses the text projections
  and norms, attends jointly over [concepts, image] with its own RoPE and
  carries its own AdaLN gates;
- single-stream blocks (text + image concatenated, parallel attention +
  MLP) with the feature taps returned explicitly;
- 3-axis RoPE over (id, y, x) token coordinates, interleaved pairs, fp32.

Parameters mirror the JAX pytree path for path (`dual_blocks.0.img_attn.
qkv.weight` <-> `dual_blocks/0/img_attn/qkv/kernel`), with one fused qkv
`nn.Linear` per stream whose output is ordered (3, heads, head_dim) as in
JAX; `convert.py` carries the trees across. Mixed precision as in JAX:
the timestep/guidance/pooled embeddings and the AdaLN modulation run in
fp32 on the weights' values (`_modulation`), the streams in the compute
dtype, LayerNorm/RMSNorm and RoPE in fp32 with the result cast back.
Every attention runs through `_joint_attention`. Where K7 runs on the card
(bf16, N >= 1024, CUDA tensors), the step from each stream's qkv linear
output to K7's inputs (q/k RMSNorm, RoPE, q's scale, the head layout) is
one Triton pass, `ops.qk_norm_rope` (its backward a second), and K7 takes
its outputs through `ops.attention.flash_attention_heads`. Elsewhere (CPU,
fp32, N < 1024) the eager chain runs: `qk_norm_heads`, `apply_rope`, then
`ops.attention.multi_head_attention` (the MMDiT never asks for the static
bound).

While a profiler records, each block of a forward is a span
(`profiling.span`): `s3od.mmdit.dual_block` or `s3od.mmdit.single_block`
(a recompute under checkpointing replays outside it).

Int8 weight residency (`ops/quant.py`): `init_mmdit(int8_weights=True)`
or a tree holding `kernel_q` (`convert.load_mmdit`) makes every eligible
linear a `QuantLinear` (int8 weight + fp32 per-row scale as buffers),
which `_linear` dequantizes into the compute dtype at use, as the JAX
`_linear` does; no bf16 copy of the model stays resident.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from s3od_torch.ops import quant
from s3od_torch.ops.attention import (
    flash_attention_heads,
    multi_head_attention,
    resolve_attn_impl,
)
from s3od_torch.ops.flash_attention import flash_seq_len
from s3od_torch.ops.qk_norm_rope import (
    apply_rope,
    qk_norm_heads,
    qk_norm_rope_autograd,
)
from s3od_torch.profiling import span


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    hidden_size: int = 3072
    num_heads: int = 24
    num_dual_blocks: int = 19
    num_single_blocks: int = 38
    mlp_ratio: float = 4.0
    text_dim: int = 4096  # T5 features
    pooled_dim: int = 768  # CLIP pooled
    in_channels: int = 64  # packed 2x2 VAE latents
    axes_dims: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 10000.0
    guidance_embed: bool = True
    feature_taps: Tuple[int, ...] = (4, 16, 27, 36)  # single-block indices

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny_mmdit_config() -> MMDiTConfig:
    return MMDiTConfig(
        hidden_size=96, num_heads=4, num_dual_blocks=2, num_single_blocks=4,
        text_dim=64, pooled_dim=32, in_channels=16, axes_dims=(8, 8, 8),
        feature_taps=(1, 3),
    )


# ----------------------------------------------------------------------------
# Primitives
# ----------------------------------------------------------------------------


class QuantLinear(nn.Module):
    """A linear whose weight is resident as int8 (`weight_q`, (dout, din))
    with one fp32 scale per output row (`weight_scale`): the JAX
    `{"kernel_q", "kernel_scale", "bias"}` node. Inference only: the
    buffers take no gradient."""

    def __init__(self, din: int, dout: int, device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = din, dout
        self.register_buffer("weight_q", torch.zeros(
            dout, din, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            dout, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(dout, device=device, dtype=dtype))


def weight_of(mod: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """A linear's (dout, din) weight in `dtype`; a `QuantLinear`'s
    dequantized in the JAX order (`quant.dequant_weight`)."""
    if isinstance(mod, QuantLinear):
        return quant.dequant_weight(mod.weight_q, mod.weight_scale, dtype)
    return mod.weight.to(dtype)


def _linear(x, mod: nn.Module):
    """x @ W^T + b with the weights cast to x's dtype (JAX `_linear`)."""
    return F.linear(x, weight_of(mod, x.dtype), mod.bias.to(x.dtype))


def _layer_norm(x, eps=1e-6):
    """Affine-free LayerNorm in fp32, cast back to x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, fp32; t scaled by 1000 (flow-matching style)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / half)
    args = t.float()[:, None] * 1000.0 * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def rope_from_ids(ids, axes_dims: Sequence[int], theta: float):
    """ids (N, n_axes) -> (cos, sin) of shape (N, head_dim), fp32, in the
    interleaved pairwise layout (diffusers FLUX convention)."""
    cos, sin = [], []
    for a, dim in enumerate(axes_dims):
        pos = ids[:, a].float()
        freqs = 1.0 / theta ** (
            torch.arange(0, dim, 2, dtype=torch.float32, device=ids.device)
            / dim)
        angles = pos[:, None] * freqs[None]
        cos.append(torch.repeat_interleave(torch.cos(angles), 2, dim=-1))
        sin.append(torch.repeat_interleave(torch.sin(angles), 2, dim=-1))
    return torch.cat(cos, -1), torch.cat(sin, -1)


def _modulation(temb, mod: nn.Linear, n_chunks: int):
    """SiLU(temb) @ W in fp32 on the weights' values -> n_chunks vectors."""
    m = F.linear(F.silu(temb.float()), weight_of(mod, torch.float32),
                 mod.bias.float())
    return m.chunk(n_chunks, -1)


def _mod(x, shift, scale):
    """LayerNorm(x) * (1 + scale) + shift, the vectors cast to x's dtype."""
    dt = x.dtype
    return _layer_norm(x) * (1 + scale[:, None].to(dt)) + shift[:, None].to(dt)


# ----------------------------------------------------------------------------
# Modules
# ----------------------------------------------------------------------------


class QKNorm(nn.Module):
    def __init__(self, head_dim: int, **kw):
        super().__init__()
        self.q = nn.Parameter(torch.ones(head_dim, **kw))
        self.k = nn.Parameter(torch.ones(head_dim, **kw))


class Attention(nn.Module):
    """One stream's fused qkv, output projection and q/k RMSNorms."""

    def __init__(self, d: int, head_dim: int, **kw):
        super().__init__()
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.proj = nn.Linear(d, d, **kw)
        self.qk_norm = QKNorm(head_dim, **kw)


class MLP(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int, **kw):
        super().__init__()
        self.fc1 = nn.Linear(din, hidden, **kw)
        self.fc2 = nn.Linear(hidden, dout, **kw)


def _joint_attention(parts, rope, head_dim: int, attn_impl: str):
    """Attention over the token-ordered concatenation of `parts`, each
    (a stream's qkv linear output (B, N_s, 3 H D), its `QKNorm`), with the
    (N, D) RoPE tables `rope` of the whole sequence -> (B, N, H, D). Where
    `multi_head_attention` would take K7 (bf16, N >= 1024) on CUDA
    tensors, `qk_norm_rope` hands K7 its inputs in one pass; elsewhere
    the eager chain runs, each stream normalised, then concatenated,
    rotated and attended."""
    y0 = parts[0][0]
    n = sum(y.shape[1] for y, _ in parts)
    scale = head_dim**-0.5
    if y0.is_cuda and resolve_attn_impl(n, y0.dtype, attn_impl) == "flash":
        q, k, v = qk_norm_rope_autograd(
            [(y, norm.q, norm.k) for y, norm in parts], *rope, scale,
            flash_seq_len(n))
        return flash_attention_heads(q, k, v, y0.shape[0], n)
    heads = [qk_norm_heads(y, norm.q, norm.k, head_dim) for y, norm in parts]
    q, k, v = (torch.cat(t, 1) if len(t) > 1 else t[0] for t in zip(*heads))
    q, k = apply_rope(q, k, *rope)
    return multi_head_attention(q, k, v, scale=scale, impl=attn_impl)


class DualBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, **kw):
        super().__init__()
        d, mlp = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
        self.head_dim = cfg.head_dim
        self.img_mod = nn.Linear(d, 6 * d, **kw)
        self.txt_mod = nn.Linear(d, 6 * d, **kw)
        self.img_attn = Attention(d, cfg.head_dim, **kw)
        self.txt_attn = Attention(d, cfg.head_dim, **kw)
        self.img_mlp = MLP(d, mlp, d, **kw)
        self.txt_mlp = MLP(d, mlp, d, **kw)

    @staticmethod
    def _mlp(x, mlp: MLP):
        return _linear(F.gelu(_linear(x, mlp.fc1), approximate="tanh"), mlp.fc2)

    def forward(self, img, txt, concept, temb, concept_temb, rope_txt_img,
                rope_concept_img, attn_impl: str = "auto"):
        """-> (img, txt, concept, maps_vecs); maps_vecs is (concept
        vectors, image vectors), this block's POST-projection attention
        outputs before gating, or None without the concept stream."""
        d = self.head_dim
        shift_i, scale_i, gate_i, shift_mi, scale_mi, gate_mi = _modulation(
            temb, self.img_mod, 6)
        shift_t, scale_t, gate_t, shift_mt, scale_mt, gate_mt = _modulation(
            temb, self.txt_mod, 6)
        img_part = (_linear(_mod(img, shift_i, scale_i), self.img_attn.qkv),
                    self.img_attn.qk_norm)
        txt_part = (_linear(_mod(txt, shift_t, scale_t), self.txt_attn.qkv),
                    self.txt_attn.qk_norm)
        attn = _joint_attention([txt_part, img_part], rope_txt_img, d,
                                attn_impl)
        n_txt = txt.shape[1]
        attn_t = _linear(attn[:, :n_txt].flatten(2), self.txt_attn.proj)
        attn_i = _linear(attn[:, n_txt:].flatten(2), self.img_attn.proj)

        new_concept, maps_vecs = None, None
        if concept is not None:
            eff = concept_temb if concept_temb is not None else temb
            sc, scc, gc, smc, sccm, gcm = _modulation(eff, self.txt_mod, 6)
            concept_part = (_linear(_mod(concept, sc, scc),
                                    self.txt_attn.qkv), self.txt_attn.qk_norm)
            cattn = _joint_attention([concept_part, img_part],
                                     rope_concept_img, d, attn_impl)
            n_c = concept.shape[1]
            # the reference routes concepts through the image to_out
            attn_c = _linear(cattn[:, :n_c].flatten(2), self.img_attn.proj)
            maps_vecs = (attn_c, attn_i)
            dt = concept.dtype
            concept = concept + gc[:, None].to(dt) * attn_c
            ff_c = self._mlp(_mod(concept, smc, sccm), self.txt_mlp)
            new_concept = concept + gcm[:, None].to(dt) * ff_c

        dt = img.dtype
        img = img + gate_i[:, None].to(dt) * attn_i
        img = img + gate_mi[:, None].to(dt) * self._mlp(
            _mod(img, shift_mi, scale_mi), self.img_mlp)
        dt = txt.dtype
        txt = txt + gate_t[:, None].to(dt) * attn_t
        txt = txt + gate_mt[:, None].to(dt) * self._mlp(
            _mod(txt, shift_mt, scale_mt), self.txt_mlp)
        return img, txt, new_concept, maps_vecs


class SingleBlock(nn.Module):
    """Parallel attention + MLP over the concatenated stream."""

    def __init__(self, cfg: MMDiTConfig, **kw):
        super().__init__()
        d, mlp = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)
        self.head_dim = cfg.head_dim
        self.mod = nn.Linear(d, 3 * d, **kw)
        self.qkv = nn.Linear(d, 3 * d, **kw)
        self.qk_norm = QKNorm(cfg.head_dim, **kw)
        self.mlp_in = nn.Linear(d, mlp, **kw)
        self.proj_out = nn.Linear(d + mlp, d, **kw)

    def forward(self, x, temb, rope, attn_impl: str = "auto"):
        shift, scale, gate = _modulation(temb, self.mod, 3)
        x_n = _mod(x, shift, scale)
        attn = _joint_attention([(_linear(x_n, self.qkv), self.qk_norm)],
                                rope, self.head_dim, attn_impl).flatten(2)
        mlp = F.gelu(_linear(x_n, self.mlp_in), approximate="tanh")
        out = _linear(torch.cat([attn, mlp], -1), self.proj_out)
        return x + gate[:, None].to(x.dtype) * out


class MMDiT(nn.Module):
    def __init__(self, cfg: MMDiTConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        d = cfg.hidden_size
        self.cfg = cfg
        self.img_in = nn.Linear(cfg.in_channels, d, **kw)
        self.txt_in = nn.Linear(cfg.text_dim, d, **kw)
        self.time_in = MLP(256, d, d, **kw)
        self.guidance_in = MLP(256, d, d, **kw)
        self.vector_in = MLP(cfg.pooled_dim, d, d, **kw)
        self.dual_blocks = nn.ModuleList(
            DualBlock(cfg, **kw) for _ in range(cfg.num_dual_blocks))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg, **kw) for _ in range(cfg.num_single_blocks))
        self.final_mod = nn.Linear(d, 2 * d, **kw)
        self.proj_out = nn.Linear(d, cfg.in_channels, **kw)

    @staticmethod
    def _embed(mlp: MLP, x):
        """fc2(SiLU(fc1(x))) in fp32 on the weights' values."""
        f = lambda m, t: F.linear(t, weight_of(m, torch.float32),
                                  m.bias.float())
        return f(mlp.fc2, F.silu(f(mlp.fc1, x.float())))

    def forward(self, *, latents, txt, pooled, timestep, img_ids, txt_ids,
                guidance=None, concepts=None, pooled_concepts=None,
                concept_layers: Optional[Sequence[int]] = None,
                compute_dtype=torch.bfloat16, attn_impl: str = "auto",
                run_block: Optional[Callable] = None) -> Dict[str, object]:
        """latents (B, N_img, in_channels) packed; txt (B, N_txt, text_dim);
        pooled (B, pooled_dim); timestep (B,); img_ids (N_img, 3); txt_ids
        (N_txt, 3); concepts (B, N_c, text_dim). Returns {'output': velocity
        (B, N_img, in_channels) fp32, 'features': [tap outputs (B, N_img,
        hidden)], 'concept_maps': (L, B, N_c, N_img) softmax-over-patches
        maps, one per collected dual block (None without concepts),
        'concept_out', 'image_out'}. `run_block(block, *args)`, if given,
        runs each dual and single block in place of `block(*args)`: the
        LoRA step (`datagen/lora.py`) runs a block on its merged weights
        through it. Differentiable throughout (the weights' casts to the
        compute dtype included)."""
        cfg, dt = self.cfg, compute_dtype
        run = run_block or (lambda blk, *args: blk(*args))
        img = _linear(latents.to(dt), self.img_in)
        txt_h = _linear(txt.to(dt), self.txt_in)

        cond = self._embed(self.time_in, timestep_embedding(timestep, 256))
        if cfg.guidance_embed and guidance is not None:
            cond = cond + self._embed(self.guidance_in,
                                      timestep_embedding(guidance, 256))
        temb = cond + self._embed(self.vector_in, pooled)

        concept_temb = concept_h = None
        if concepts is not None:
            concept_h = _linear(concepts.to(dt), self.txt_in)
            if pooled_concepts is not None:
                concept_temb = cond + self._embed(self.vector_in,
                                                  pooled_concepts)

        rope_ti = rope_from_ids(torch.cat([txt_ids, img_ids]).float(),
                                cfg.axes_dims, cfg.rope_theta)
        rope_ci = None
        if concepts is not None:
            cids = torch.zeros(concepts.shape[1], 3, device=img_ids.device)
            rope_ci = rope_from_ids(torch.cat([cids, img_ids.float()]),
                                    cfg.axes_dims, cfg.rope_theta)

        maps: List[torch.Tensor] = []
        for bi, blk in enumerate(self.dual_blocks):
            with span("s3od.mmdit.dual_block"):
                img, txt_h, concept_h, mv = run(blk, img, txt_h, concept_h,
                                                temb, concept_temb, rope_ti,
                                                rope_ci, attn_impl)
            if mv is not None and (concept_layers is None
                                   or bi in concept_layers):
                maps.append(concept_maps_from_vectors(*mv))
        concept_out, image_out = concept_h, img

        x = torch.cat([txt_h, img], 1)
        n_txt = txt_h.shape[1]
        features: List[torch.Tensor] = []
        for i, blk in enumerate(self.single_blocks):
            with span("s3od.mmdit.single_block"):
                x = run(blk, x, temb, rope_ti, attn_impl)
            if i in cfg.feature_taps:
                features.append(x[:, n_txt:])

        shift, scale = _modulation(temb, self.final_mod, 2)
        out = _linear(_mod(x[:, n_txt:], shift, scale), self.proj_out)
        return {"output": out.float(), "features": features,
                "concept_maps": torch.stack(maps) if maps else None,
                "concept_out": concept_out, "image_out": image_out}


def concept_maps_from_vectors(concept_vectors, image_vectors):
    """One (timestep, layer) entry of the map postprocess: L2-normalize the
    concepts (eps 1e-8), dot with the image tokens, softmax over PATCHES
    -> (B, N_c, N_img), fp32."""
    c = concept_vectors.float()
    c = c / (torch.linalg.vector_norm(c, dim=-1, keepdim=True) + 1e-8)
    sim = torch.einsum("bnc,bmc->bnm", c, image_vectors.float())
    return torch.softmax(sim, -1)


def minmax_normalize(maps):
    """Per-batch GLOBAL min-max across concepts and space."""
    lo = maps.amin(dim=(-3, -2, -1), keepdim=True)
    hi = maps.amax(dim=(-3, -2, -1), keepdim=True)
    return (maps - lo) / (hi - lo + 1e-8)


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------


def quantize_linears_(model: nn.Module, names=None) -> nn.Module:
    """Replace linears of `model` by `QuantLinear`s of the same shape, on
    the same device (meta included): those named in `names` (module
    paths), or every one `quant.eligible` admits. The new buffers are
    uninitialised until loaded or drawn."""
    targets = [(n, m) for n, m in model.named_modules()
               if isinstance(m, nn.Linear)
               and (n in names if names is not None
                    else quant.eligible((m.in_features, m.out_features)))]
    for name, lin in targets:
        parent_name, _, leaf = name.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        setattr(parent, leaf, QuantLinear(
            lin.in_features, lin.out_features, device=lin.weight.device,
            dtype=lin.weight.dtype))
    return model


@torch.no_grad()
def quantize_mmdit(model: MMDiT) -> MMDiT:
    """The int8 residency form of a float MMDiT, beside it on its device:
    every linear `quant.eligible` admits becomes a `QuantLinear` holding
    the codes and scales of `quant.quantize_weight_int8` (the formula of
    `quantize_kernel_int8`, run on the card), the rest copied. The source is
    left as it was; the copy never holds a float weight of a quantized
    linear."""
    dev = next(model.parameters()).device
    out = quantize_linears_(MMDiT(model.cfg, device="meta",
                                  dtype=next(model.parameters()).dtype))
    out = out.to_empty(device=dev)
    src = dict(model.named_modules())
    for name, mod in out.named_modules():
        if isinstance(mod, QuantLinear):
            q, scale = quant.quantize_weight_int8(src[name].weight)
            mod.weight_q.copy_(q)
            mod.weight_scale.copy_(scale)
            mod.bias.copy_(src[name].bias)
            del q, scale
        elif not list(mod.children()):
            for pname, prm in mod.named_parameters(recurse=False):
                prm.copy_(getattr(src[name], pname))
    return out.eval()


@torch.no_grad()
def init_mmdit(cfg: MMDiTConfig, generator: torch.Generator, device=None,
               dtype=torch.float32, int8_weights: bool = False) -> MMDiT:
    """Seeded random weights in the JAX init scheme (`init_mmdit_params`):
    every Linear weight ~ N(0, 0.02), biases zero, q/k norms one. Built on
    the meta device and materialised directly in `dtype` on `device`
    (the generator's device): the full FLUX tree is ~12B parameters, and
    a host fp32 copy would be 48 GB. `int8_weights=True` draws every
    eligible linear in the int8 form as the JAX init does (`mmdit.py:
    443-456`): q uniform in [-127, 127], scale 0.02 / 127 per row, bias
    zero, so the full-depth model never exists in bf16."""
    model = MMDiT(cfg, device="meta", dtype=dtype)
    if int8_weights:
        quantize_linears_(model)
    model = model.to_empty(device=device or generator.device)
    for name, prm in model.named_parameters():
        if name.endswith(".q") or name.endswith(".k"):
            prm.fill_(1.0)
        elif name.endswith("bias"):
            prm.zero_()
        else:
            prm.normal_(0.0, 0.02, generator=generator)
    for name, buf in model.named_buffers():
        if name.endswith("weight_q"):
            buf.random_(-127, 128, generator=generator)
        elif name.endswith("weight_scale"):
            buf.fill_(0.02 / 127.0)
    return model.eval()
