"""Plain float32 reference of FLUX.1-dev's transformer with LoRA adapters,
trained by the rectified-flow loss: the comparison that decides the LoRA
cell's `correct`.

Written from the published model (black-forest-labs/flux,
`src/flux/model.py` and `modules/layers.py`; sizes from the
configuration file) in plain `torch`, float32; it imports nothing of the
program under test. TF32 must be off while it runs (`exact_float32()`).

- Conditioning: vec = MLP(sinusoid(1000 t)) + MLP(sinusoid(1000 g)) +
  MLP(pooled), each MLP fc2(SiLU(fc1(.))), the sinusoid [cos, sin] over
  256 dims at periods up to 10^4.
- Dual-stream block, per stream: shift, scale, gate (x2) = Linear(SiLU(
  vec)); LayerNorm (no affine, eps 1e-6), (1 + scale) x + shift; qkv laid
  out (3, heads, head dim); RMSNorm (eps 1e-6) with a learned scale on q
  and k; joint attention over [text, image] with RoPE; x += gate proj(o);
  x += gate MLP((1 + scale) LN(x) + shift), GELU (tanh).
- Single-stream block over [text, image]: shift, scale, gate; one
  modulated LN feeding qkv and the MLP's up-projection in parallel;
  x += gate proj_out([attention, GELU(up)]).
- RoPE over (id, row, column) with 16, 56, 56 of the 128 dims, theta
  10^4: frequencies theta^(-2k/dim) per axis, rotations of interleaved
  pairs (x0, x1) -> (cos x0 - sin x1, sin x0 + cos x1), angles in float64.
- Attention softmax(q k^T / sqrt(128)) v, materialised, a few heads at a
  time. Last layer: (1 + scale) LN(x) + shift, then Linear to 64.
- LoRA: y = x W^T + b + (alpha / r) (x A) B on each target, added to the
  output unrounded (W + (alpha / r) (A B)^T in exact arithmetic).
- Loss: mean((v(x_t, t) - (noise - x0))^2), x_t = (1 - t) x0 + t noise,
  guidance 1.0. AdamW: `reference.train.AdamW`, torch's written out.

Departures from the published description:
- The port's parameter layout is read: the single block's fused
  `linear1` is two Linears, `qkv` (3 d) and `mlp_in` (4 d), the same
  product's output columns split; `linear2` is `proj_out`; the embedders
  are `time_in`, `guidance_in`, `vector_in` (`fc1`, `fc2`); the last
  layer's modulation is `final_mod`, its Linear `proj_out`.
- Weights are read in their stored dtype (bf16 on the card) and upcast
  one block at a time; under `remat` each block is recomputed in the
  backward (`torch.utils.checkpoint`), so only the blocks' boundaries are
  kept in float32 between the passes. No number changes.

`Numerics(fp8=True)` (`reference.model`) rounds both operands of every
matrix product, q, k and v to float8 e4m3: the benchmark's control.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.model import PLAIN, Numerics, exact_float32  # noqa: F401
from perfbench.reference.train import AdamW

EPS = 1e-6

Adapters = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _param(sd, name):
    return sd[name].float()


def linear(x, sd, name: str, nm: Numerics, adapters: Optional[Adapters] = None,
           scale: float = 1.0):
    """x W^T + b, plus scale (x A) B where `adapters` holds `name`."""
    y = F.linear(nm.q(x), nm.q(_param(sd, name + ".weight")),
                 _param(sd, name + ".bias"))
    if adapters is not None and name in adapters:
        a, b = adapters[name]
        y = y + scale * (nm.q(nm.q(x) @ nm.q(a)) @ nm.q(b))
    return y


def modulation(vec, sd, name: str, n: int, nm: Numerics):
    return linear(F.silu(vec), sd, name, nm)[:, None].chunk(n, -1)


def layer_norm(x):
    return F.layer_norm(x, x.shape[-1:], eps=EPS)


def rms_norm(x, w):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * w.float()


def sinusoid(t, dim: int = 256, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = 1000.0 * t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


def embed(x, sd, name: str, nm: Numerics):
    return linear(F.silu(linear(x, sd, name + ".fc1", nm)), sd, name + ".fc2", nm)


def rope_tables(ids, axes: Sequence[int], theta: float):
    """(cos, sin), each (N, head_dim / 2): one angle a rotated pair."""
    angles = []
    for a, dim in enumerate(axes):
        omega = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64,
                                             device=ids.device) / dim)
        angles.append(ids[:, a].double()[:, None] * omega[None])
    ang = torch.cat(angles, -1)
    return ang.cos().float(), ang.sin().float()


def rope(x, tables):
    """x (B, H, N, D): each interleaved pair rotated by its angle."""
    cos, sin = tables
    x0, x1 = x.reshape(*x.shape[:-1], -1, 2).unbind(-1)
    return torch.stack([cos * x0 - sin * x1, sin * x0 + cos * x1], -1).reshape(x.shape)


def attention(q, k, v, nm: Numerics, chunk_elems: int):
    """softmax(q k^T / sqrt(D)) v over (B, H, N, D), a few heads at a time
    (at most `chunk_elems` logits; heads are independent)."""
    b, h, n, d = q.shape
    q, k, v = nm.q(q), nm.q(k), nm.q(v)
    heads = max(1, chunk_elems // max(1, b * n * n))
    outs = []
    for i in range(0, h, heads):
        s = (q[:, i: i + heads] @ k[:, i: i + heads].transpose(-1, -2)) * d ** -0.5
        outs.append(torch.softmax(s, -1) @ v[:, i: i + heads])
    return torch.cat(outs, 1)


def _heads(x, sd, name: str, norm: str, cfg: dict, nm, adapters, scale):
    b, n, _ = x.shape
    h, d = cfg["num_attention_heads"], cfg["attention_head_dim"]
    qkv = linear(x, sd, name, nm, adapters, scale).reshape(b, n, 3, h, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    return rms_norm(q, sd[norm + ".q"]), rms_norm(k, sd[norm + ".k"]), v


def _mlp(x, sd, pre: str, nm):
    return linear(F.gelu(linear(x, sd, pre + ".fc1", nm), approximate="tanh"),
                  sd, pre + ".fc2", nm)


def dual_block(img, txt, vec, tables, sd, pre: str, cfg: dict, nm: Numerics,
               adapters: Adapters, scale: float, chunk_elems: int):
    im = modulation(vec, sd, pre + "img_mod", 6, nm)
    tm = modulation(vec, sd, pre + "txt_mod", 6, nm)
    n_txt = txt.shape[1]
    qkv = [_heads((1 + m[1]) * layer_norm(x) + m[0], sd, pre + s + "_attn.qkv",
                  pre + s + "_attn.qk_norm", cfg, nm, adapters, scale)
           for x, m, s in ((txt, tm, "txt"), (img, im, "img"))]
    q, k, v = (torch.cat(pair, 2) for pair in zip(*qkv))
    o = attention(rope(q, tables), rope(k, tables), v, nm, chunk_elems)
    o = o.transpose(1, 2).flatten(2)
    out = []
    for x, m, s, part in ((img, im, "img", o[:, n_txt:]), (txt, tm, "txt", o[:, :n_txt])):
        x = x + m[2] * linear(part, sd, pre + s + "_attn.proj", nm, adapters, scale)
        x = x + m[5] * _mlp((1 + m[4]) * layer_norm(x) + m[3], sd, pre + s + "_mlp", nm)
        out.append(x)
    return out[0], out[1]


def single_block(x, vec, tables, sd, pre: str, cfg: dict, nm: Numerics,
                 adapters: Adapters, scale: float, chunk_elems: int):
    shift, sc, gate = modulation(vec, sd, pre + "mod", 3, nm)
    h = (1 + sc) * layer_norm(x) + shift
    q, k, v = _heads(h, sd, pre + "qkv", pre + "qk_norm", cfg, nm, adapters, scale)
    o = attention(rope(q, tables), rope(k, tables), v, nm, chunk_elems)
    up = F.gelu(linear(h, sd, pre + "mlp_in", nm), approximate="tanh")
    out = linear(torch.cat([o.transpose(1, 2).flatten(2), up], -1), sd,
                 pre + "proj_out", nm, adapters, scale)
    return x + gate * out


def velocity(sd, cfg: dict, adapters: Adapters, x_t, txt, pooled, t, img_ids,
             txt_ids, guidance, nm: Numerics = PLAIN, remat: bool = True,
             chunk_elems: int = 1 << 28):
    """The transformer's output (B, N_img, in_channels) at x_t, float32."""
    scale = cfg["lora"]["alpha"] / cfg["lora"]["rank"]
    run = ((lambda fn, *a: checkpoint(fn, *a, use_reentrant=False))
           if remat and torch.is_grad_enabled() else (lambda fn, *a: fn(*a)))
    img = linear(x_t, sd, "img_in", nm)
    txt = linear(txt, sd, "txt_in", nm)
    vec = (embed(sinusoid(t), sd, "time_in", nm)
           + embed(sinusoid(guidance), sd, "guidance_in", nm)
           + embed(pooled, sd, "vector_in", nm))
    tables = rope_tables(torch.cat([txt_ids, img_ids]), cfg["axes_dims_rope"],
                         cfg["rope_theta"])
    for i in range(cfg["num_layers"]):
        img, txt = run(lambda a, b, p=f"dual_blocks.{i}.": dual_block(
            a, b, vec, tables, sd, p, cfg, nm, adapters, scale, chunk_elems), img, txt)
    n_txt = txt.shape[1]
    x = torch.cat([txt, img], 1)
    for i in range(cfg["num_single_layers"]):
        x = run(lambda a, p=f"single_blocks.{i}.": single_block(
            a, vec, tables, sd, p, cfg, nm, adapters, scale, chunk_elems), x)
    shift, sc = modulation(vec, sd, "final_mod", 2, nm)
    return linear((1 + sc) * layer_norm(x[:, n_txt:]) + shift, sd, "proj_out", nm)


def lora_steps(sd: Dict[str, torch.Tensor], cfg: dict, recipe: dict,
               lora0: Dict[str, torch.Tensor], batches: List[dict],
               draws: List[tuple], nm: Numerics = PLAIN, remat: bool = True) -> dict:
    """`len(batches)` steps of the adapters from `lora0` ({"<linear>.A":
    (in, r), "<linear>.B": (r, out)}), step i on `batches[i]` with the
    draws (t, noise) `draws[i]`. Returns {"losses", "first": (the first
    step's velocity,), "grads1": {leaf: first gradient}, "params": {leaf:
    after the last step}, "initial": {leaf: at the start}}."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in lora0.items()}
    initial = {k: v.detach().clone() for k, v in params.items()}
    adapters = {k[: -len(".A")]: (params[k], params[k[:-1] + "B"])
                for k in params if k.endswith(".A")}
    opt = AdamW(params, {k: recipe["lr"] for k in params}, recipe["weight_decay"])
    losses, grads1, first = [], None, None
    for i, (batch, (t, noise)) in enumerate(zip(batches, draws)):
        x0 = batch["latents"].float()
        tt = t.float()[:, None, None]
        v = velocity(sd, cfg, adapters, (1 - tt) * x0 + tt * noise, batch["txt"].float(),
                     batch["pooled"].float(), t.float(), batch["img_ids"].float(),
                     batch["txt_ids"].float(), torch.ones_like(t, dtype=torch.float32),
                     nm, remat)
        loss = torch.mean((v - (noise - x0)) ** 2)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()),
                                                     allow_unused=True)))
        if i == 0:
            first = (v.detach().clone(),)
            grads1 = {k: (g.detach().clone() if g is not None
                          else torch.zeros_like(params[k])) for k, g in grads.items()}
        losses.append(loss.item())
        del v, loss
        opt.step(grads)
    return {"losses": losses, "first": first, "grads1": grads1,
            "params": {k: v.detach() for k, v in params.items()}, "initial": initial}
