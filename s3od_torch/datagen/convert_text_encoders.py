"""Convert FLUX text-encoder checkpoints to the port's `.npz` trees
(counterpart of `scripts/convert_text_encoders.py`).

Given local `save_pretrained` directories of `google/t5-v1_1-xxl` and
`openai/clip-vit-large-patch14` (`config.json` beside `model.safetensors`,
`pytorch_model.bin` or their sharded index), writes the trees that
`convert.load_t5` / `load_clip_text` and `TorchTextEncoders.from_npz`
read (and the JAX package's `load_native`), with the configuration from
`config.json` stored beside the weights. The directories are read
directly, without `transformers`.

    python -m s3od_torch.datagen.convert_text_encoders \\
        --t5 /ckpts/t5-v1_1-xxl --clip /ckpts/clip-vit-large-patch14 \\
        --out-dir /ckpts/native [--verify]

`--verify` runs random token ids through the converted encoder and
through `transformers`' own model loaded from the same directory, in
float32: max-abs-diff < 1e-3, as the JAX script checks. It needs
`transformers` and raises where that is missing.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

VERIFY_TOL = 1e-3

_WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")
_INDEX_FILES = ("model.safetensors.index.json", "pytorch_model.bin.index.json")


def _load_file(path: Path) -> Dict[str, torch.Tensor]:
    if path.suffix == ".safetensors":
        from safetensors.torch import load_file

        return load_file(str(path))
    return torch.load(str(path), map_location="cpu", weights_only=True)


def read_pretrained(path: str):
    """A `save_pretrained` directory -> (config.json as a dict, state
    dict), from a single weight file or a sharded index."""
    d = Path(path)
    config = json.loads((d / "config.json").read_text())
    for name in _WEIGHT_FILES:
        if (d / name).exists():
            return config, _load_file(d / name)
    for name in _INDEX_FILES:
        if (d / name).exists():
            shards = sorted(set(json.loads((d / name).read_text())
                                ["weight_map"].values()))
            sd: Dict[str, torch.Tensor] = {}
            for shard in shards:
                sd.update(_load_file(d / shard))
            return config, sd
    raise FileNotFoundError(
        f"{path}: no {' / '.join(_WEIGHT_FILES + _INDEX_FILES)}; pass a "
        "local save_pretrained directory (nothing is downloaded)")


def t5_config(hf: dict):
    from s3od_torch.models.text_encoders import T5Config

    return T5Config(
        vocab_size=hf["vocab_size"], d_model=hf["d_model"], d_kv=hf["d_kv"],
        d_ff=hf["d_ff"], num_layers=hf["num_layers"],
        num_heads=hf["num_heads"],
        relative_attention_num_buckets=hf["relative_attention_num_buckets"],
        relative_attention_max_distance=hf.get(
            "relative_attention_max_distance", 128),
        layer_norm_epsilon=hf.get("layer_norm_epsilon", 1e-6))


def clip_config(hf: dict):
    from s3od_torch.models.text_encoders import CLIPTextConfig

    hf = hf.get("text_config", hf)  # a full CLIP config nests the text one
    return CLIPTextConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        max_position_embeddings=hf["max_position_embeddings"],
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5))


def convert_t5_dir(path: str):
    """-> (T5 tree, T5Config)."""
    from s3od_torch.models.text_encoders import convert_t5_encoder

    hf, sd = read_pretrained(path)
    if "shared.weight" not in sd:  # tied: saved once, under either name
        sd["shared.weight"] = sd["encoder.embed_tokens.weight"]
    cfg = t5_config(hf)
    return convert_t5_encoder(sd, cfg), cfg


def convert_clip_dir(path: str):
    """-> (CLIP text tree, CLIPTextConfig)."""
    from s3od_torch.models.text_encoders import convert_clip_text

    hf, sd = read_pretrained(path)
    cfg = clip_config(hf)
    return convert_clip_text(sd, cfg), cfg


def _transformers(name: str):
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError(
            "--verify compares against transformers, which is not "
            "installed; convert without --verify, or install it") from e
    return getattr(transformers, name)


def verify_t5(path: str, out_npz: str, seed: int = 0) -> float:
    """max|converted - transformers| of last_hidden_state on random ids."""
    from s3od_torch.convert import load_t5

    model = _transformers("T5EncoderModel").from_pretrained(
        path, torch_dtype=torch.float32).eval()
    ours = load_t5(out_npz)
    ids = torch.as_tensor(np.random.default_rng(seed).integers(
        0, ours.cfg.vocab_size, (1, 16)))
    with torch.no_grad():
        ref = model(input_ids=ids).last_hidden_state
        got = ours(ids)
    return float((got - ref).abs().max())


def verify_clip(path: str, out_npz: str, seed: int = 0) -> float:
    """max|converted - transformers| of the pooled output on random ids
    ending in the end-of-text id (the largest)."""
    from s3od_torch.convert import load_clip_text

    model = _transformers("CLIPTextModel").from_pretrained(
        path, torch_dtype=torch.float32).eval()
    ours = load_clip_text(out_npz)
    v = ours.cfg.vocab_size
    ids = np.random.default_rng(seed).integers(0, v - 1, (1, 12))
    ids[:, -1] = v - 1
    ids = torch.as_tensor(ids)
    with torch.no_grad():
        ref = model(input_ids=ids).pooler_output
        got = ours(ids)[1]
    return float((got - ref).abs().max())


def main(argv=None) -> int:
    from s3od_torch.convert import config_to_meta, save_native

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t5", help="T5EncoderModel save_pretrained directory")
    ap.add_argument("--clip", help="CLIPTextModel save_pretrained directory")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--verify", action="store_true")
    args = ap.parse_args(argv)
    if not (args.t5 or args.clip):
        ap.error("pass --t5 and/or --clip")
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jobs = [(args.t5, convert_t5_dir, verify_t5, "t5_encoder.npz", "t5"),
            (args.clip, convert_clip_dir, verify_clip, "clip_text.npz",
             "clip")]
    for src, convert, verify, name, label in jobs:
        if not src:
            continue
        tree, cfg = convert(src)
        save_native(str(out / name), tree, {"config": config_to_meta(cfg)})
        del tree
        print(f"wrote {out / name}")
        if args.verify:
            diff = verify(src, str(out / name))
            print(f"{label} verify max-abs-diff {diff:.2e}")
            if not diff < VERIFY_TOL:
                raise AssertionError(
                    f"{label}: max-abs-diff {diff:.2e} >= {VERIFY_TOL}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
