"""What a run of the FLUX.1-dev LoRA cell feeds the program, made from
`--seed` on the run's device: the MMDiT's seeded weights by the port's
parameter names, the pool of cached samples (packed VAE latents, T5 and
CLIP embeddings, token ids), the generator of each step's draws, and the
adapters' initial values that the program, the reference and the control
all start from.

Weights follow the port's init scheme (`init_mmdit`, the JAX package's):
every Linear weight N(0, 0.02^2), biases 0, q/k RMSNorm scales 1, drawn in
the configuration's dtype from one generator, tensor after tensor in the
module's order. The samples stand in for the factory's cached latents and
text embeddings: unit normals (the FLUX VAE's latents are shifted and
scaled to about unit variance; T5 and CLIP features are unit normals
here), so every seed gives the same shapes and other values.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from perfbench.inputs import mix

PACK = 16  # pixels a packed latent token covers: the VAE's 8, then 2x2


def mlp_dim(cfg: dict) -> int:
    return int(cfg["hidden_size"] * cfg["mlp_ratio"])


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, law) of every parameter of the port's MMDiT
    (`models/mmdit.MMDiT`, in its order); laws: "normal" (a Linear
    weight), "zero" (a bias), "one" (a q/k RMSNorm scale)."""
    d, f, hd = cfg["hidden_size"], mlp_dim(cfg), cfg["attention_head_dim"]
    out: List[Tuple[str, tuple, str]] = []

    def linear(name, din, dout):
        out.append((name + ".weight", (dout, din), "normal"))
        out.append((name + ".bias", (dout,), "zero"))

    def attn(pre):
        linear(pre + ".qkv", d, 3 * d)
        linear(pre + ".proj", d, d)
        out.append((pre + ".qk_norm.q", (hd,), "one"))
        out.append((pre + ".qk_norm.k", (hd,), "one"))

    linear("img_in", cfg["in_channels"], d)
    linear("txt_in", cfg["joint_attention_dim"], d)
    for emb, din in (("time_in", 256), ("guidance_in", 256),
                     ("vector_in", cfg["pooled_projection_dim"])):
        linear(emb + ".fc1", din, d)
        linear(emb + ".fc2", d, d)
    for i in range(cfg["num_layers"]):
        b = f"dual_blocks.{i}."
        linear(b + "img_mod", d, 6 * d)
        linear(b + "txt_mod", d, 6 * d)
        attn(b + "img_attn")
        attn(b + "txt_attn")
        for s in ("img_mlp", "txt_mlp"):
            linear(b + s + ".fc1", d, f)
            linear(b + s + ".fc2", f, d)
    for i in range(cfg["num_single_layers"]):
        b = f"single_blocks.{i}."
        linear(b + "mod", d, 3 * d)
        linear(b + "qkv", d, 3 * d)
        out.append((b + "qk_norm.q", (hd,), "one"))
        out.append((b + "qk_norm.k", (hd,), "one"))
        linear(b + "mlp_in", d, f)
        linear(b + "proj_out", d + f, d)
    linear("final_mod", d, 2 * d)
    linear("proj_out", d, cfg["in_channels"])
    return out


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded weights in the configuration's dtype, on `device`."""
    dtype = getattr(torch, cfg["dtype"])
    g = torch.Generator(device=device).manual_seed(mix(seed, 1))
    sd: Dict[str, torch.Tensor] = {}
    for name, shape, law in param_specs(cfg):
        t = torch.empty(shape, dtype=dtype, device=device)
        if law == "normal":
            t.normal_(0.0, 0.02, generator=g)
        else:
            t.fill_(1.0 if law == "one" else 0.0)
        sd[name] = t
    return sd


def img_ids(grid: int, device) -> torch.Tensor:
    """(grid^2, 3) ids of the packed latent grid: (0, row, column)."""
    yy, xx = torch.meshgrid(torch.arange(grid), torch.arange(grid), indexing="ij")
    ids = torch.stack([torch.zeros_like(yy), yy, xx], -1).reshape(-1, 3)
    return ids.float().to(device)


def samples(cfg: dict, traffic: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The pool: `traffic["pool"]` samples of `traffic["batch"]` at the
    `traffic["size"]`^2 bucket, each {"latents": packed (B, grid^2,
    in_channels), "txt": (B, T5 tokens, joint_attention_dim), "pooled":
    (B, pooled_projection_dim), "img_ids", "txt_ids" (zeros)}, float32."""
    b, grid = traffic["batch"], traffic["size"] // PACK
    n_txt = cfg["max_t5_tokens"]
    ids = img_ids(grid, device)
    pool = []
    for i in range(traffic["pool"]):
        g = torch.Generator(device=device).manual_seed(mix(seed, 10 + i))
        pool.append({
            "latents": torch.randn(b, grid * grid, cfg["in_channels"],
                                   generator=g, device=device),
            "txt": torch.randn(b, n_txt, cfg["joint_attention_dim"],
                               generator=g, device=device),
            "pooled": torch.randn(b, cfg["pooled_projection_dim"],
                                  generator=g, device=device),
            "img_ids": ids,
            "txt_ids": torch.zeros(n_txt, 3, device=device)})
    return pool


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step `step`'s draws (t, then the noise)."""
    return torch.Generator(device=device).manual_seed(mix(seed, 100 + step))


def draws(generator: torch.Generator, latents: torch.Tensor):
    """(t, noise) as the recipe draws them from one generator: t =
    sigmoid(N(0, 1)) per sample, then the noise N(0, 1) in the latents'
    shape, float32."""
    dev = generator.device
    t = torch.sigmoid(torch.randn(latents.shape[0], generator=generator, device=dev))
    noise = torch.randn(latents.shape, generator=generator, dtype=torch.float32,
                        device=dev)
    return t, noise


def adapter_shapes(cfg: dict) -> Dict[str, Tuple[int, int]]:
    """{adapter's linear ("dual_blocks.0.img_attn.qkv", ...): (in, out)}
    for every target of the configuration's LoRA recipe."""
    shapes = {n[: -len(".weight")]: (s[1], s[0]) for n, s, _ in param_specs(cfg)
              if n.endswith(".weight")}
    out = {}
    for kind, key, count in (("dual_blocks", "dual_targets", cfg["num_layers"]),
                             ("single_blocks", "single_targets",
                              cfg["num_single_layers"])):
        for i in range(count):
            for target in cfg["lora"][key]:
                name = f"{kind}.{i}.{target}"
                out[name] = shapes[name]
    return out


def lora_init(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial adapters by leaf name ("<linear>.A" (in, r) ~ N(0, 1) / r,
    "<linear>.B" (r, out) = 0), float32: the recipe's law, drawn by the
    benchmark; the driver copies them into the port's leaves and starts the
    reference and the control from them."""
    r = cfg["lora"]["rank"]
    g = torch.Generator(device=device).manual_seed(mix(seed, 2))
    out = {}
    for name, (din, dout) in adapter_shapes(cfg).items():
        out[name + ".A"] = torch.randn(din, r, generator=g, device=device) / r
        out[name + ".B"] = torch.zeros(r, dout, device=device)
    return out
