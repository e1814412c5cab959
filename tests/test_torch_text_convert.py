"""`s3od_torch.datagen.convert_text_encoders` and the converters it calls
(`models/text_encoders.convert_t5_encoder` / `convert_clip_text`) against
the JAX package's, on tiny `T5EncoderModel` / `CLIPTextModel`s built from
configs in code (nothing downloaded) and written with `save_pretrained`.

The trees must equal the JAX converters' exactly (they copy and
transpose); `--verify` holds the converted encoders against transformers
at max-abs-diff < 1e-3 in float32 (the JAX script's bound), and raises
where transformers is missing.
"""

import sys

import numpy as np
import pytest
import torch

import jax

from s3od_torch.datagen import convert_text_encoders as cte


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    from transformers import CLIPTextConfig, CLIPTextModel, T5Config
    from transformers.models.t5.modeling_t5 import T5EncoderModel

    root = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    t5 = T5EncoderModel(T5Config(
        vocab_size=97, d_model=32, d_kv=8, d_ff=48, num_layers=2,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, feed_forward_proj="gated-gelu",
        dropout_rate=0.0)).eval()
    # sharded: the reader follows the index, as for T5-XXL's checkpoint
    t5.save_pretrained(root / "t5", max_shard_size="40KB")
    clip = CLIPTextModel(CLIPTextConfig(
        vocab_size=61, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=16, hidden_act="quick_gelu",
        eos_token_id=60, bos_token_id=59, attention_dropout=0.0)).eval()
    clip.save_pretrained(root / "clip")
    return root, t5, clip


def _equal_trees(got, ref):
    ref = jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_trees_equal_jax(pretrained):
    from s3od_tpu.models import text_encoders as jt

    root, t5, clip = pretrained
    assert len(list((root / "t5").glob("*.safetensors"))) > 1
    tree, cfg = cte.convert_t5_dir(str(root / "t5"))
    assert (cfg.vocab_size, cfg.d_model, cfg.num_layers, cfg.num_heads,
            cfg.relative_attention_num_buckets) == (97, 32, 2, 4, 8)
    jcfg = jt.T5Config(**{f: getattr(cfg, f)
                          for f in cfg.__dataclass_fields__})
    _equal_trees(tree, jt.convert_t5_encoder(t5.state_dict(), jcfg))

    tree, cfg = cte.convert_clip_dir(str(root / "clip"))
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_layers,
            cfg.max_position_embeddings) == (61, 32, 2, 16)
    jcfg = jt.CLIPTextConfig(**{f: getattr(cfg, f)
                                for f in cfg.__dataclass_fields__})
    _equal_trees(tree, jt.convert_clip_text(clip.state_dict(), jcfg))


def test_cli_verify_and_the_npz_both_packages_read(pretrained, tmp_path,
                                                   capsys):
    from s3od_tpu.convert import load_native as jax_load
    from s3od_torch.convert import load_clip_text, load_t5

    root, t5, clip = pretrained
    out = tmp_path / "out"
    assert cte.main(["--t5", str(root / "t5"), "--clip", str(root / "clip"),
                     "--out-dir", str(out), "--verify"]) == 0
    text = capsys.readouterr().out
    diffs = [float(line.split()[-1]) for line in text.splitlines()
             if "verify max-abs-diff" in line]
    assert len(diffs) == 2 and max(diffs) < cte.VERIFY_TOL
    params, meta = jax_load(str(out / "t5_encoder.npz"))
    assert int(meta["config"]["d_model"]) == 32
    assert load_t5(str(out / "t5_encoder.npz")).cfg.d_ff == 48
    assert load_clip_text(str(out / "clip_text.npz")).cfg.num_heads == 4
    ids = torch.tensor([[5, 9, 60]])
    with torch.no_grad():
        ref = clip(input_ids=ids).pooler_output
        got = load_clip_text(str(out / "clip_text.npz"))(ids)[1]
    assert (got - ref).abs().max() < cte.VERIFY_TOL


def test_verify_without_transformers_raises(pretrained, tmp_path,
                                            monkeypatch):
    root, _, _ = pretrained
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="transformers"):
        cte.main(["--clip", str(root / "clip"), "--out-dir", str(tmp_path),
                  "--verify"])
    # conversion alone needs no transformers
    assert cte.main(["--clip", str(root / "clip"),
                     "--out-dir", str(tmp_path)]) == 0
