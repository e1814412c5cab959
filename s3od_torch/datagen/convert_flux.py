"""Diffusers FLUX checkpoint -> the port's MMDiT / VAE trees (counterpart of
`s3od_tpu/datagen/convert_flux.py`).

Key mapping (diffusers `FluxTransformer2DModel` layout):

  x_embedder                            -> img_in
  context_embedder                      -> txt_in
  time_text_embed.timestep_embedder.*   -> time_in.fc1/fc2
  time_text_embed.guidance_embedder.*   -> guidance_in.fc1/fc2
  time_text_embed.text_embedder.*       -> vector_in.fc1/fc2
  transformer_blocks.N.norm1.linear     -> dual_blocks[N].img_mod
  ...norm1_context.linear               -> dual_blocks[N].txt_mod
  ...attn.{to_q,to_k,to_v}              -> img_attn.qkv (fused)
  ...attn.{norm_q,norm_k}               -> img_attn.qk_norm
  ...attn.{add_q_proj,add_k_proj,add_v_proj} -> txt_attn.qkv (fused)
  ...attn.{norm_added_q,norm_added_k}   -> txt_attn.qk_norm
  ...attn.to_out.0 / attn.to_add_out    -> img_attn.proj / txt_attn.proj
  ...ff.net.0.proj / ff.net.2           -> img_mlp.fc1/fc2 (GELU-tanh)
  ...ff_context.*                       -> txt_mlp.fc1/fc2
  single_transformer_blocks.N.norm.linear -> single_blocks[N].mod
  ...attn.{to_q,to_k,to_v} / norm_q/k   -> qkv / qk_norm
  ...proj_mlp / proj_out                -> mlp_in / proj_out
  norm_out.linear                       -> final_mod  (diffusers emits
      [scale, shift]; the final modulation consumes [shift, scale]: the
      converter swaps the halves)
  proj_out                              -> proj_out

The trees are the JAX package's, with numpy float32 leaves, written by
`convert.save_native` with no state, as the JAX converter writes them:
the port's `convert.load_mmdit` / `load_vae_modules` (whose default
configurations are FLUX.1-dev's and the FLUX VAE's; pass another) and
the JAX `load_native` read the same files.

    python -m s3od_torch.datagen.convert_flux \\
        --transformer flux/transformer/diffusion_pytorch_model.safetensors \\
        --vae flux/vae/diffusion_pytorch_model.safetensors \\
        --out_transformer flux_mmdit.npz --out_vae flux_vae.npz
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().float().numpy() if hasattr(x, "detach")
                      else x, dtype=np.float32)


def _lin(sd: Dict, prefix: str) -> dict:
    p = {"kernel": _t(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        p["bias"] = _t(sd[prefix + ".bias"])
    return p


def _fused_qkv(sd: Dict, q: str, k: str, v: str) -> dict:
    return {
        "kernel": np.concatenate([_t(sd[f"{n}.weight"]).T for n in (q, k, v)],
                                 axis=1),
        "bias": np.concatenate([_t(sd[f"{n}.bias"]) for n in (q, k, v)]),
    }


def convert_flux_transformer(sd: Dict) -> dict:
    """Full diffusers FLUX transformer state dict -> MMDiT tree."""
    tte = "time_text_embed"
    params = {
        "img_in": _lin(sd, "x_embedder"),
        "txt_in": _lin(sd, "context_embedder"),
        "time_in": {"fc1": _lin(sd, f"{tte}.timestep_embedder.linear_1"),
                    "fc2": _lin(sd, f"{tte}.timestep_embedder.linear_2")},
        "vector_in": {"fc1": _lin(sd, f"{tte}.text_embedder.linear_1"),
                      "fc2": _lin(sd, f"{tte}.text_embedder.linear_2")},
    }
    if f"{tte}.guidance_embedder.linear_1.weight" in sd:
        params["guidance_in"] = {
            "fc1": _lin(sd, f"{tte}.guidance_embedder.linear_1"),
            "fc2": _lin(sd, f"{tte}.guidance_embedder.linear_2"),
        }

    def qk_norm(b, q, k):
        return {"q": _t(sd[f"{b}.attn.{q}.weight"]),
                "k": _t(sd[f"{b}.attn.{k}.weight"])}

    dual = []
    while f"transformer_blocks.{len(dual)}.norm1.linear.weight" in sd:
        b = f"transformer_blocks.{len(dual)}"
        dual.append({
            "img_mod": _lin(sd, f"{b}.norm1.linear"),
            "txt_mod": _lin(sd, f"{b}.norm1_context.linear"),
            "img_attn": {
                "qkv": _fused_qkv(sd, f"{b}.attn.to_q", f"{b}.attn.to_k",
                                  f"{b}.attn.to_v"),
                "proj": _lin(sd, f"{b}.attn.to_out.0"),
                "qk_norm": qk_norm(b, "norm_q", "norm_k"),
            },
            "txt_attn": {
                "qkv": _fused_qkv(sd, f"{b}.attn.add_q_proj",
                                  f"{b}.attn.add_k_proj",
                                  f"{b}.attn.add_v_proj"),
                "proj": _lin(sd, f"{b}.attn.to_add_out"),
                "qk_norm": qk_norm(b, "norm_added_q", "norm_added_k"),
            },
            "img_mlp": {"fc1": _lin(sd, f"{b}.ff.net.0.proj"),
                        "fc2": _lin(sd, f"{b}.ff.net.2")},
            "txt_mlp": {"fc1": _lin(sd, f"{b}.ff_context.net.0.proj"),
                        "fc2": _lin(sd, f"{b}.ff_context.net.2")},
        })
    params["dual_blocks"] = dual

    single = []
    while f"single_transformer_blocks.{len(single)}.norm.linear.weight" in sd:
        b = f"single_transformer_blocks.{len(single)}"
        single.append({
            "mod": _lin(sd, f"{b}.norm.linear"),
            "qkv": _fused_qkv(sd, f"{b}.attn.to_q", f"{b}.attn.to_k",
                              f"{b}.attn.to_v"),
            "qk_norm": qk_norm(b, "norm_q", "norm_k"),
            "mlp_in": _lin(sd, f"{b}.proj_mlp"),
            "proj_out": _lin(sd, f"{b}.proj_out"),
        })
    params["single_blocks"] = single

    # diffusers' AdaLayerNormContinuous emits [scale, shift]; the final
    # modulation consumes [shift, scale]: swap the halves.
    fm = _lin(sd, "norm_out.linear")
    d = fm["kernel"].shape[1] // 2
    params["final_mod"] = {
        "kernel": np.concatenate([fm["kernel"][:, d:], fm["kernel"][:, :d]],
                                 axis=1),
        "bias": np.concatenate([fm["bias"][d:], fm["bias"][:d]]),
    }
    params["proj_out"] = _lin(sd, "proj_out")
    return params


def _conv(sd: Dict, prefix: str) -> dict:
    p = {"kernel": _t(sd[prefix + ".weight"]).transpose(2, 3, 1, 0)}
    if prefix + ".bias" in sd:
        p["bias"] = _t(sd[prefix + ".bias"])
    return p


def _gn(sd: Dict, prefix: str) -> dict:
    return {"weight": _t(sd[prefix + ".weight"]),
            "bias": _t(sd[prefix + ".bias"])}


def convert_diffusers_vae(sd: Dict):
    """diffusers `AutoencoderKL` state dict -> (enc, dec) trees: the
    standard layout (down/up blocks of resnets, mid block with one
    attention)."""

    def res(prefix):
        p = {"norm1": _gn(sd, f"{prefix}.norm1"),
             "conv1": _conv(sd, f"{prefix}.conv1"),
             "norm2": _gn(sd, f"{prefix}.norm2"),
             "conv2": _conv(sd, f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in sd:
            p["shortcut"] = _conv(sd, f"{prefix}.conv_shortcut")
        return p

    def attn(prefix):
        return {"norm": _gn(sd, f"{prefix}.group_norm"),
                "q": _lin(sd, f"{prefix}.to_q"),
                "k": _lin(sd, f"{prefix}.to_k"),
                "v": _lin(sd, f"{prefix}.to_v"),
                "proj": _lin(sd, f"{prefix}.to_out.0")}

    def stages(side, block_key, sample_key):
        out = []
        while f"{side}.{block_key}.{len(out)}.resnets.0.norm1.weight" in sd:
            pre = f"{side}.{block_key}.{len(out)}"
            stage = {"resnets": []}
            while f"{pre}.resnets.{len(stage['resnets'])}.norm1.weight" in sd:
                stage["resnets"].append(
                    res(f"{pre}.resnets.{len(stage['resnets'])}"))
            samp = f"{pre}.{sample_key}.0.conv"
            if f"{samp}.weight" in sd:
                key = "downsample" if "down" in sample_key else "upsample"
                stage[key] = _conv(sd, samp)
            out.append(stage)
        return out

    def mid(side):
        return {"res1": res(f"{side}.mid_block.resnets.0"),
                "attn": attn(f"{side}.mid_block.attentions.0"),
                "res2": res(f"{side}.mid_block.resnets.1")}

    enc = {"conv_in": _conv(sd, "encoder.conv_in"),
           "down": stages("encoder", "down_blocks", "downsamplers"),
           "mid": mid("encoder"),
           "norm_out": _gn(sd, "encoder.conv_norm_out"),
           "conv_out": _conv(sd, "encoder.conv_out")}
    dec = {"conv_in": _conv(sd, "decoder.conv_in"),
           "mid": mid("decoder"),
           "up": stages("decoder", "up_blocks", "upsamplers"),
           "norm_out": _gn(sd, "decoder.conv_norm_out"),
           "conv_out": _conv(sd, "decoder.conv_out")}
    return enc, dec


def read_state_dict(path: str) -> Dict:
    """A `.safetensors` or torch `.bin` state dict from a local file."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(str(path))
    import torch

    return torch.load(str(path), map_location="cpu", weights_only=True)


def convert_flux_checkpoint(transformer_path: str, vae_path: str,
                            out_transformer: str, out_vae: str) -> None:
    """Read the two state dicts, write the two `.npz` trees."""
    from s3od_torch.convert import save_native

    save_native(out_transformer,
                convert_flux_transformer(read_state_dict(transformer_path)))
    enc, dec = convert_diffusers_vae(read_state_dict(vae_path))
    save_native(out_vae, {"enc": enc, "dec": dec})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--transformer", required=True)
    ap.add_argument("--vae", required=True)
    ap.add_argument("--out_transformer", required=True)
    ap.add_argument("--out_vae", required=True)
    a = ap.parse_args(argv)
    convert_flux_checkpoint(a.transformer, a.vae, a.out_transformer, a.out_vae)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
