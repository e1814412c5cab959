"""FLUX text conditioning in PyTorch: T5 v1.1 encoder + CLIP text (pooled)
(counterpart of `s3od_tpu/models/text_encoders.py`). Plain modules, no
kernel: the JAX package runs them in XLA.

- T5: RMSNorm without mean-centering (variance in fp32), NO sqrt(d)
  attention scaling, bucketed relative-position bias computed from layer
  0's table and shared by all layers, gated tanh-GELU feed-forward, no
  biases, token embeddings unscaled, padding mask -1e9.
- CLIP text: learned absolute positions, pre-LN blocks, causal mask,
  quick-GELU, scaled attention with biases; pooled output is the final-LN
  hidden state at argmax(input_ids) (the end-of-text id is the largest).

Parameters mirror the JAX pytree path for path (`layers.0.attention.q.
weight` <-> `layers/0/attention/q/kernel`), so `convert.py` carries the
trees across. Weights are cast to the compute dtype at use.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _mm(x, lin: nn.Linear):
    b = lin.bias.to(x.dtype) if lin.bias is not None else None
    return F.linear(x, lin.weight.to(x.dtype), b)


# ----------------------------------------------------------------------------
# T5 v1.1 encoder
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6


def t5_xxl_config() -> T5Config:
    """google/t5-v1_1-xxl — the FLUX text_encoder_2."""
    return T5Config()


def _t5_rms_norm(x, weight, eps):
    """T5LayerNorm: variance in fp32, no mean subtraction, the weight in the
    compute dtype applied after the cast back."""
    var = x.float().square().mean(-1, keepdim=True)
    y = (x.float() * torch.rsqrt(var + eps)).to(x.dtype)
    return y * weight.to(x.dtype)


def _gelu_new(x):
    """transformers' NewGELUActivation (tanh approximation), in x's dtype."""
    c = float(np.sqrt(2.0 / np.pi))
    x3 = x + 0.044715 * x * x * x
    return 0.5 * x * (1.0 + torch.tanh(c * x3))


def t5_relative_position_bucket(relative_position, num_buckets: int,
                                max_distance: int):
    """Bidirectional bucketing (transformers'
    `T5Attention._relative_position_bucket`), log in fp32."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    rel = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (
        torch.log(rel.float() / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(is_small, rel, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias_table: bool, **kw):
        super().__init__()
        d, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
        self.layer_norm = nn.Parameter(torch.ones(d, **kw))
        self.q = nn.Linear(d, inner, bias=False, **kw)
        self.k = nn.Linear(d, inner, bias=False, **kw)
        self.v = nn.Linear(d, inner, bias=False, **kw)
        self.o = nn.Linear(inner, d, bias=False, **kw)
        if has_bias_table:
            self.relative_attention_bias = nn.Parameter(torch.zeros(
                cfg.relative_attention_num_buckets, cfg.num_heads, **kw))

    def forward(self, x, bias, mask, cfg: T5Config):
        b, n, _ = x.shape
        h, dk = cfg.num_heads, cfg.d_kv
        heads = lambda t: t.reshape(b, n, h, dk).transpose(1, 2)
        q, k, v = heads(_mm(x, self.q)), heads(_mm(x, self.k)), heads(_mm(x, self.v))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores + bias.float()
        if mask is not None:
            scores = scores + torch.where(mask[:, None, None, :], 0.0, -1e9)
        attn = torch.softmax(scores, -1).to(x.dtype)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, h * dk)
        return _mm(ctx, self.o)


class T5FF(nn.Module):
    def __init__(self, cfg: T5Config, **kw):
        super().__init__()
        d = cfg.d_model
        self.layer_norm = nn.Parameter(torch.ones(d, **kw))
        self.wi_0 = nn.Linear(d, cfg.d_ff, bias=False, **kw)
        self.wi_1 = nn.Linear(d, cfg.d_ff, bias=False, **kw)
        self.wo = nn.Linear(cfg.d_ff, d, bias=False, **kw)


class T5Layer(nn.Module):
    def __init__(self, cfg: T5Config, first: bool, **kw):
        super().__init__()
        self.attention = T5Attention(cfg, first, **kw)
        self.ff = T5FF(cfg, **kw)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embedding = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model, **kw))
        self.layers = nn.ModuleList(T5Layer(cfg, i == 0, **kw)
                                    for i in range(cfg.num_layers))
        self.final_layer_norm = nn.Parameter(torch.ones(cfg.d_model, **kw))

    def position_bias(self, length: int, device):
        pos = torch.arange(length, device=device)
        buckets = t5_relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        table = self.layers[0].attention.relative_attention_bias
        return table[buckets].permute(2, 0, 1)[None]  # (1, H, q, k)

    def forward(self, input_ids, attention_mask=None,
                compute_dtype=torch.float32):
        """input_ids (B, L) -> last_hidden_state (B, L, d_model)."""
        cfg = self.cfg
        x = self.embedding[input_ids].to(compute_dtype)
        bias = self.position_bias(input_ids.shape[1], input_ids.device)
        eps = cfg.layer_norm_epsilon
        for layer in self.layers:
            a, f = layer.attention, layer.ff
            x = x + a(_t5_rms_norm(x, a.layer_norm, eps), bias,
                      attention_mask, cfg)
            h = _t5_rms_norm(x, f.layer_norm, eps)
            x = x + _mm(_gelu_new(_mm(h, f.wi_0)) * _mm(h, f.wi_1), f.wo)
        return _t5_rms_norm(x, self.final_layer_norm, eps)


@torch.no_grad()
def init_t5(cfg: T5Config, generator: torch.Generator, device=None,
            dtype=torch.float32) -> T5Encoder:
    """Seeded random weights in transformers' T5 scheme (the JAX
    `init_t5_params`): q ~ N(0, (d d_kv)^-1/2), k, v, wi ~ N(0, d^-1/2),
    o ~ N(0, (H d_kv)^-1/2), wo ~ N(0, d_ff^-1/2), embedding N(0, 1), the
    bias table N(0, d^-1/2), norms one; made on `device` in `dtype`."""
    model = T5Encoder(cfg, device="meta", dtype=dtype)
    model = model.to_empty(device=device or generator.device)
    d, dk, h, ff = cfg.d_model, cfg.d_kv, cfg.num_heads, cfg.d_ff
    std = {"q": (d * dk) ** -0.5, "k": d**-0.5, "v": d**-0.5,
           "o": (h * dk) ** -0.5, "wi_0": d**-0.5, "wi_1": d**-0.5,
           "wo": ff**-0.5, "relative_attention_bias": d**-0.5,
           "embedding": 1.0}
    for name, prm in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "layer_norm" or name == "final_layer_norm":
            prm.fill_(1.0)
        else:
            key = parts[-2] if parts[-1] == "weight" else parts[-1]
            prm.normal_(0.0, std[key], generator=generator)
    return model.eval()


# ----------------------------------------------------------------------------
# CLIP text model (pooled output)
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5


def clip_l_config() -> CLIPTextConfig:
    """openai/clip-vit-large-patch14 text tower — the FLUX text_encoder."""
    return CLIPTextConfig()


def _clip_layer_norm(x, ln: nn.LayerNorm, eps):
    """fp32 statistics, normalized value cast back, affine in x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)
    return y * ln.weight.to(x.dtype) + ln.bias.to(x.dtype)


class CLIPAttention(nn.Module):
    def __init__(self, d: int, **kw):
        super().__init__()
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.out = nn.Linear(d, d, **kw)

    def forward(self, x, heads: int, causal):
        b, n, d = x.shape
        dk = d // heads
        split = lambda t: t.reshape(b, n, heads, dk).transpose(1, 2)
        q = split(_mm(x, self.q) * (dk**-0.5))
        k, v = split(_mm(x, self.k)), split(_mm(x, self.v))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + causal
        attn = torch.softmax(scores, -1).to(x.dtype)
        ctx = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        return _mm(ctx, self.out)


class CLIPMLP(nn.Module):
    def __init__(self, d: int, ff: int, **kw):
        super().__init__()
        self.fc1 = nn.Linear(d, ff, **kw)
        self.fc2 = nn.Linear(ff, d, **kw)


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **kw):
        super().__init__()
        d = cfg.hidden_size
        self.ln1 = nn.LayerNorm(d, **kw)
        self.attn = CLIPAttention(d, **kw)
        self.ln2 = nn.LayerNorm(d, **kw)
        self.mlp = CLIPMLP(d, cfg.intermediate_size, **kw)


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.token_embedding = nn.Parameter(
            torch.zeros(cfg.vocab_size, cfg.hidden_size, **kw))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size, **kw))
        self.layers = nn.ModuleList(CLIPLayer(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, **kw)

    def forward(self, input_ids, compute_dtype=torch.float32):
        """input_ids (B, L) -> (last_hidden_state (B, L, D), pooled (B, D))."""
        cfg = self.cfg
        b, n = input_ids.shape
        x = self.token_embedding[input_ids].to(compute_dtype)
        x = x + self.position_embedding[:n].to(compute_dtype)
        causal = torch.triu(torch.full((n, n), -torch.inf,
                                       device=input_ids.device), 1)
        eps = cfg.layer_norm_eps
        for layer in self.layers:
            x = x + layer.attn(_clip_layer_norm(x, layer.ln1, eps),
                               cfg.num_heads, causal)
            h = _clip_layer_norm(x, layer.ln2, eps)
            h = _mm(h, layer.mlp.fc1)
            x = x + _mm(h * torch.sigmoid(1.702 * h), layer.mlp.fc2)
        x = _clip_layer_norm(x, self.final_layer_norm, eps)
        pooled = x[torch.arange(b, device=x.device), input_ids.argmax(-1)]
        return x, pooled


@torch.no_grad()
def init_clip_text(cfg: CLIPTextConfig, generator: torch.Generator,
                   device=None, dtype=torch.float32) -> CLIPTextEncoder:
    """Seeded random weights in the JAX `init_clip_text_params` scheme:
    linears and embeddings N(0, 0.02), biases zero, LayerNorms (1, 0)."""
    model = CLIPTextEncoder(cfg, device="meta", dtype=dtype)
    model = model.to_empty(device=device or generator.device)
    for name, prm in model.named_parameters():
        if ".ln" in name or name.startswith("final_layer_norm"):
            prm.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            prm.zero_()
        else:
            prm.normal_(0.0, 0.02, generator=generator)
    return model.eval()


# ----------------------------------------------------------------------------
# Converters: transformers state dicts -> the trees
# ----------------------------------------------------------------------------


def _numpy_sd(state_dict) -> dict:
    """Torch tensors (any float dtype) or numpy arrays -> numpy float32."""
    return {k: np.asarray(v.detach().float().cpu().numpy()
                          if isinstance(v, torch.Tensor) else v, np.float32)
            for k, v in state_dict.items()}


def convert_t5_encoder(state_dict, cfg: T5Config) -> dict:
    """transformers `T5EncoderModel.state_dict()` -> the T5 tree (the JAX
    `convert_t5_encoder`, `s3od_tpu/models/text_encoders.py:221`), numpy
    float32 leaves; linear weights transpose from (out, in) to (in, out)."""
    sd = _numpy_sd(state_dict)

    def lin(name):
        return {"kernel": sd[name].T}

    layers = []
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        att = {
            "layer_norm": sd[f"{pre}.0.layer_norm.weight"],
            "q": lin(f"{pre}.0.SelfAttention.q.weight"),
            "k": lin(f"{pre}.0.SelfAttention.k.weight"),
            "v": lin(f"{pre}.0.SelfAttention.v.weight"),
            "o": lin(f"{pre}.0.SelfAttention.o.weight"),
        }
        if i == 0:
            att["relative_attention_bias"] = sd[
                f"{pre}.0.SelfAttention.relative_attention_bias.weight"]
        layers.append({
            "attention": att,
            "ff": {
                "layer_norm": sd[f"{pre}.1.layer_norm.weight"],
                "wi_0": lin(f"{pre}.1.DenseReluDense.wi_0.weight"),
                "wi_1": lin(f"{pre}.1.DenseReluDense.wi_1.weight"),
                "wo": lin(f"{pre}.1.DenseReluDense.wo.weight"),
            },
        })
    return {"embedding": sd["shared.weight"], "layers": layers,
            "final_layer_norm": sd["encoder.final_layer_norm.weight"]}


def convert_clip_text(state_dict, cfg: CLIPTextConfig) -> dict:
    """transformers `CLIPTextModel.state_dict()` -> the CLIP text tree (the
    JAX `convert_clip_text`, `s3od_tpu/models/text_encoders.py:391`)."""
    sd = _numpy_sd(state_dict)

    def lin(name):
        return {"kernel": sd[f"{name}.weight"].T, "bias": sd[f"{name}.bias"]}

    def ln(name):
        return {"weight": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}

    layers = []
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        layers.append({
            "ln1": ln(f"{pre}.layer_norm1"),
            "attn": {"q": lin(f"{pre}.self_attn.q_proj"),
                     "k": lin(f"{pre}.self_attn.k_proj"),
                     "v": lin(f"{pre}.self_attn.v_proj"),
                     "out": lin(f"{pre}.self_attn.out_proj")},
            "ln2": ln(f"{pre}.layer_norm2"),
            "mlp": {"fc1": lin(f"{pre}.mlp.fc1"), "fc2": lin(f"{pre}.mlp.fc2")},
        })
    return {
        "token_embedding": sd["text_model.embeddings.token_embedding.weight"],
        "position_embedding":
            sd["text_model.embeddings.position_embedding.weight"],
        "layers": layers,
        "final_layer_norm": ln("text_model.final_layer_norm"),
    }
