"""On-device text conditioning for the factory: the port's T5 + CLIP
encoders (counterpart of `s3od_tpu/datagen/text_encoding.py`).

The same `.encode(prompts)` / `.encode_concepts(concepts)` surface the
`ConceptAttentionPipeline` consumes, with the encoder math on the card.
Tokenization stays on the host: pass the matching transformers
tokenizers (local files) with real checkpoints; without them a
deterministic hash tokenizer (the JAX package's, copied so that ids are
identical) maps words to stable ids, so the full encoder graph runs with
seeded weights — the card has no `transformers`.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from s3od_torch.models.text_encoders import (
    CLIPTextConfig,
    CLIPTextEncoder,
    T5Config,
    T5Encoder,
    init_clip_text,
    init_t5,
)
from s3od_torch.utils import compute_dtype_for, resolve_device

T5_PAD_ID = 0
T5_EOS_ID = 1


def _hash_ids(text: str, vocab: int, lo: int) -> list:
    """Stable per-word ids in [lo, vocab): the fallback tokenizer."""
    out = []
    for w in text.lower().split():
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        out.append(lo + h % (vocab - lo))
    return out


class TorchTextEncoders:
    """CLIP (pooled) + T5 (sequence) encoders on the device (default
    "cuda"). The encoders are cast to the compute dtype once, as the JAX
    class casts its float32 leaves: `compute_dtype` "bfloat16" or
    "float32", by default bf16 on the card and float32 on the CPU."""

    def __init__(self, t5: T5Encoder, clip: CLIPTextEncoder, *,
                 t5_tokenizer=None, clip_tokenizer=None,
                 max_t5_tokens: int = 512,
                 compute_dtype: Optional[str] = None,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self.dtype = compute_dtype_for(self.device, compute_dtype)
        self.t5 = t5.to(self.device, self.dtype).eval()
        self.clip = clip.to(self.device, self.dtype).eval()
        self.t5_cfg, self.clip_cfg = t5.cfg, clip.cfg
        self.t5_tokenizer = t5_tokenizer
        self.clip_tokenizer = clip_tokenizer
        self.max_t5_tokens = max_t5_tokens

    # -- constructors --------------------------------------------------

    @classmethod
    def random_init(cls, seed: int = 0, t5_cfg: Optional[T5Config] = None,
                    clip_cfg: Optional[CLIPTextConfig] = None, **kw):
        """Seeded random-weight encoders (no checkpoints), made directly in
        the compute dtype on the device: T5-XXL is ~4.7B parameters."""
        device = resolve_device(kw.get("device"))
        dtype = compute_dtype_for(device, kw.get("compute_dtype"))
        gen = lambda s: torch.Generator(device=device).manual_seed(s)
        return cls(init_t5(t5_cfg or T5Config(), gen(seed), device, dtype),
                   init_clip_text(clip_cfg or CLIPTextConfig(), gen(seed + 1),
                                  device, dtype), **kw)

    @classmethod
    def from_npz(cls, t5_path: str, clip_path: str,
                 t5_cfg: Optional[T5Config] = None,
                 clip_cfg: Optional[CLIPTextConfig] = None, **kw):
        """Converted checkpoints (the JAX package's `.npz` trees); the
        configurations default to the ones stored beside the weights,
        else T5-XXL and CLIP-L."""
        from s3od_torch.convert import load_clip_text, load_t5

        return cls(load_t5(t5_path, t5_cfg), load_clip_text(clip_path, clip_cfg),
                   **kw)

    # -- tokenization (host) -------------------------------------------

    def _tok_t5(self, prompts: Sequence[str],
                max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.t5_tokenizer is not None:
            t = self.t5_tokenizer(
                list(prompts), padding="max_length", max_length=max_len,
                truncation=True, return_tensors="np")
            return (t["input_ids"].astype(np.int64),
                    t["attention_mask"].astype(bool))
        ids = np.full((len(prompts), max_len), T5_PAD_ID, np.int64)
        mask = np.zeros((len(prompts), max_len), bool)
        for i, p in enumerate(prompts):
            toks = _hash_ids(p, self.t5_cfg.vocab_size, 2)[: max_len - 1]
            toks.append(T5_EOS_ID)
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = True
        return ids, mask

    def _tok_clip(self, prompts: Sequence[str]) -> np.ndarray:
        n = self.clip_cfg.max_position_embeddings
        if self.clip_tokenizer is not None:
            t = self.clip_tokenizer(
                list(prompts), padding="max_length", max_length=n,
                truncation=True, return_tensors="np")
            return t["input_ids"].astype(np.int64)
        v = self.clip_cfg.vocab_size
        bos, eos = v - 2, v - 1  # eos = max id -> argmax pooling works
        ids = np.zeros((len(prompts), n), np.int64)
        for i, p in enumerate(prompts):
            toks = [bos] + _hash_ids(p, v - 2, 1)[: n - 2] + [eos]
            ids[i, : len(toks)] = toks
        return ids

    # -- the TextEncoders surface --------------------------------------

    @torch.inference_mode()
    def _t5(self, ids, mask):
        t = lambda a: torch.from_numpy(a).to(self.device)
        return self.t5(t(ids), t(mask), compute_dtype=self.dtype)

    @torch.inference_mode()
    def _clip_pooled(self, ids):
        ids = torch.from_numpy(ids).to(self.device)
        return self.clip(ids, compute_dtype=self.dtype)[1]

    @staticmethod
    def _np(t):
        return t.float().cpu().numpy()

    def encode(self, prompts: Sequence[str]):
        """-> (t5_features (B, L, d_model), clip_pooled (B, hidden)) numpy
        float32."""
        seq = self._t5(*self._tok_t5(prompts, self.max_t5_tokens))
        pooled = self._clip_pooled(self._tok_clip(prompts))
        return self._np(seq), self._np(pooled)

    def encode_concepts(self, concepts: Sequence[str]):
        """T5-embed each concept and keep the FIRST token; CLIP-pool the
        joined concept string for the concept stream's modulation.
        -> ((1, N_c, d_model), (1, hidden)) numpy float32."""
        seq = self._t5(*self._tok_t5(list(concepts), 8))
        vecs = self._np(seq)[:, 0]
        pooled = self._clip_pooled(self._tok_clip([" ".join(concepts)]))
        return vecs[None], self._np(pooled)
