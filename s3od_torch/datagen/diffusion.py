"""Rectified-flow diffusion pipeline with concept attention (FLUX-style), in
PyTorch (counterpart of `s3od_tpu/datagen/diffusion.py`).

- flow-matching Euler scheduler with the sequence-length mu-shift;
- 2x2 latent packing over the 16-channel VAE latent grid -> 64-channel
  tokens in diffusers' channel order, (0, y, x) RoPE ids;
- text conditioning: CLIP pooled + T5 sequence features, from
  `TextEncoders` (transformers, imported lazily and only when called), the
  on-device `TorchTextEncoders` (`datagen/text_encoding.py`), or
  embeddings supplied directly;
- concept tokens: the first T5 token of each concept word; the concept
  stream on the last 3 of 28 steps;
- feature taps compressed 3072 -> 768 by the mean over 4 adjacent
  channels; concept maps averaged over (step, layer), min-max normalized;
- img2img / single-step inversion for feature extraction;
- `mesh=` / `from_config(fsdp=)`: the MMDiT sharded over a
  `torch.distributed` device mesh with FSDP2 (`parallel.shard_module`),
  each dual and single block a unit whose weights are gathered for its
  forward and freed after. Every rank runs the same batch-1 sample
  (activations stay replicated), as under the JAX mesh.

The denoising loop is a Python loop over MMDiT forwards on the device
under `torch.inference_mode()` (`torch.no_grad()` when sharded): every
attention launches K7. The initial
noise comes from `initial_noise` (a `torch.Generator` seeded with `seed`),
the one place where the port's numbers differ from the JAX pipeline's
(`jax.random.normal`); tests replace it with JAX's draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from s3od_torch.models.mmdit import MMDiT, minmax_normalize
from s3od_torch.utils import compute_dtype_for, resolve_device

def fsdp_mesh(fsdp: int, device_type: str):
    """A ("data", "fsdp") mesh with `fsdp` ranks to a shard (-1 or 0: the
    whole world); raises unless it divides the world size."""
    from s3od_torch.parallel.distributed import expected_world_size
    from s3od_torch.parallel.mesh import make_mesh

    world = expected_world_size()
    n = world if fsdp in (-1, 0) else int(fsdp)
    if n < 1 or world % n:
        raise ValueError(f"fsdp={fsdp} does not divide the world size {world}")
    return make_mesh(dp=world // n, fsdp=n, device_type=device_type)


# ----------------------------------------------------------------------------
# Scheduler: flow-matching Euler with mu-shift
# ----------------------------------------------------------------------------


def calculate_shift(seq_len: int, base_seq: int = 256, max_seq: int = 4096,
                    base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    """FLUX mu-shift: linear in sequence length between the anchors,
    clamped to [base_shift, max_shift]."""
    m = (max_shift - base_shift) / (max_seq - base_seq)
    return max(base_shift, min(max_shift, seq_len * m + (base_shift - m * base_seq)))


def shifted_sigmas(num_steps: int, mu: float) -> np.ndarray:
    """sigmas_i in (0, 1]: linspace then time-shifted by exp(mu)."""
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps)
    e = math.exp(mu)
    return (e / (e + (1.0 / sigmas - 1.0))).astype(np.float32)


@dataclasses.dataclass
class FlowMatchSchedule:
    sigmas: np.ndarray  # (T,) descending; appended 0 terminal implicitly

    @classmethod
    def create(cls, num_steps: int, seq_len: int) -> "FlowMatchSchedule":
        return cls(shifted_sigmas(num_steps, calculate_shift(seq_len)))

    def scale_noise(self, latents, noise, step_index: int):
        """x_t = (1 - sigma) x0 + sigma * noise (img2img entry point)."""
        s = float(self.sigmas[step_index])
        return (1.0 - s) * latents + s * noise

    def step(self, x, velocity, step_index: int):
        """Euler step toward sigma_{i+1} (0 at the end)."""
        s = float(self.sigmas[step_index])
        s_next = (float(self.sigmas[step_index + 1])
                  if step_index + 1 < len(self.sigmas) else 0.0)
        return x + (s_next - s) * velocity


# ----------------------------------------------------------------------------
# Latent packing
# ----------------------------------------------------------------------------


def pack_latents(latents):
    """(B, H, W, C) VAE latents -> (B, H/2*W/2, 4C) 2x2-packed tokens in
    diffusers' channel order (index ch*4 + dy*2 + dx)."""
    b, h, w, c = latents.shape
    x = latents.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (b, h/2, w/2, c, 2, 2)
    return x.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents(tokens, h: int, w: int):
    """Inverse of pack_latents; h, w are the UNPACKED latent dims."""
    b, n, c4 = tokens.shape
    c = c4 // 4
    x = tokens.reshape(b, h // 2, w // 2, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (b, h/2, 2, w/2, 2, c)
    return x.reshape(b, h, w, c)


def make_img_ids(ph: int, pw: int) -> np.ndarray:
    yy, xx = np.mgrid[0:ph, 0:pw]
    return np.stack([np.zeros(ph * pw), yy.ravel(), xx.ravel()],
                    axis=-1).astype(np.float32)


def compress_features(feat, groups: int = 4):
    """hidden 3072 -> 768 by the mean over ADJACENT groups of `groups`
    channels (out[i] = mean(feat[groups*i : groups*(i+1)])), accumulated
    in fp32 and rounded to feat's dtype."""
    b, n, c = feat.shape
    return feat.float().reshape(b, n, c // groups, groups).mean(-1).to(feat.dtype)


def initial_noise(seed: int, shape, device) -> torch.Tensor:
    """The first latents x_T ~ N(0, 1), fp32, from a generator seeded
    with `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


# ----------------------------------------------------------------------------
# Text encoding via transformers (lazy; embeddings may be supplied directly)
# ----------------------------------------------------------------------------


class TextEncoders:
    """CLIP (pooled) + T5 (sequence) encoders via transformers, loaded at
    the first call. The card has no transformers: use
    `datagen.text_encoding.TorchTextEncoders` there."""

    def __init__(self, clip_id: str = "openai/clip-vit-large-patch14",
                 t5_id: str = "google/t5-v1_1-xxl", max_t5_tokens: int = 512):
        self.clip_id, self.t5_id = clip_id, t5_id
        self.max_t5_tokens = max_t5_tokens
        self._loaded = False

    def _load(self):
        from transformers import AutoTokenizer, CLIPTextModel, T5EncoderModel

        self.clip_tok = AutoTokenizer.from_pretrained(self.clip_id)
        self.clip = CLIPTextModel.from_pretrained(self.clip_id).eval()
        self.t5_tok = AutoTokenizer.from_pretrained(self.t5_id)
        self.t5 = T5EncoderModel.from_pretrained(self.t5_id).eval()
        self._loaded = True

    @torch.no_grad()
    def encode(self, prompts: Sequence[str]):
        """-> (t5_features (B, L, 4096), clip_pooled (B, 768)) numpy."""
        if not self._loaded:
            self._load()
        ct = self.clip_tok(list(prompts), padding="max_length", max_length=77,
                           truncation=True, return_tensors="pt")
        pooled = self.clip(**ct).pooler_output.numpy()
        tt = self.t5_tok(list(prompts), padding="max_length",
                         max_length=self.max_t5_tokens, truncation=True,
                         return_tensors="pt")
        return self.t5(**tt).last_hidden_state.numpy(), pooled

    @torch.no_grad()
    def encode_concepts(self, concepts: Sequence[str]):
        """T5-embed each concept, keep the FIRST token -> (1, N_c, 4096);
        plus the CLIP pooled vector of the joined concept string."""
        if not self._loaded:
            self._load()
        vecs = [self.t5(**self.t5_tok(c, return_tensors="pt"))
                .last_hidden_state[0][0].numpy() for c in concepts]
        ct = self.clip_tok(" ".join(concepts), padding="max_length",
                           max_length=77, truncation=True, return_tensors="pt")
        return np.stack(vecs)[None], self.clip(**ct).pooler_output.numpy()


# ----------------------------------------------------------------------------
# Pipeline
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class ConceptAttentionOutput:
    image: Optional[np.ndarray]            # uint8 HWC (None if no VAE)
    latents: np.ndarray                    # final unpacked latents
    features: List[np.ndarray]             # compressed tap features (B, N, 768)
    concept_maps: Dict[str, np.ndarray]    # name -> (H/16, W/16) in [0, 1]


class ConceptAttentionPipeline:
    """Text-to-image / img2img with concept observation + feature taps, on
    `device` (default "cuda"); `compute_dtype` "bfloat16" or "float32", by
    default bf16 on the card and float32 on the CPU. `lora`: LoRA adapters
    (a `flux_finetune` `.npz` path or a tree; `datagen/lora.read_lora`),
    merged once here into copies of the targeted weights, which every step
    runs on through `functional_call`: `model` itself is not changed.
    `mesh`: a `DeviceMesh` with an "fsdp" axis (`parallel.make_mesh`);
    the MMDiT is sharded over it in place after the LoRA merge, as the
    JAX pipeline shards its merged tree (`diffusion.py:289-295`), so
    under a mesh the merged weights replace the targeted ones."""

    def __init__(self, model: MMDiT, *,
                 text_encoders=None, vae=None, num_inference_steps: int = 28,
                 guidance_scale: float = 3.5,
                 concept_timesteps: Optional[Sequence[int]] = None,
                 concept_layers: Optional[Sequence[int]] = None,
                 compute_dtype: Optional[str] = None, lora=None,
                 lora_scale: Optional[float] = None, mesh=None,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.merged = None
        if lora is not None:
            from s3od_torch.datagen.lora import merge_lora, read_lora

            tree, lcfg = read_lora(lora, lora_scale, self.device)
            with torch.no_grad():
                self.merged = merge_lora(self.model, tree, lcfg)
        if mesh is not None:
            from s3od_torch.parallel.mesh import shard_module

            if self.merged is not None:
                with torch.no_grad():
                    params = dict(self.model.named_parameters())
                    for name, w in self.merged.items():
                        params[name].copy_(w)
                self.merged = None
            shard_module(self.model, mesh, wrap="fsdp")
        self.mesh = mesh
        self.cfg = model.cfg
        self.text_encoders = text_encoders or TextEncoders()
        self.vae = vae
        self.num_inference_steps = num_inference_steps
        self.guidance_scale = guidance_scale
        # The concept stream runs on the LAST 3 steps (timesteps 25-27 of 28).
        self.concept_timesteps = (
            list(concept_timesteps) if concept_timesteps is not None
            else list(range(max(0, num_inference_steps - 3),
                            num_inference_steps)))
        # Maps from dual blocks 0..17 of 19; None = all (tiny configs).
        self.concept_layers = (
            tuple(concept_layers) if concept_layers is not None
            else (tuple(range(18)) if self.cfg.num_dual_blocks == 19 else None))
        self.dtype = compute_dtype_for(self.device, compute_dtype)

    @classmethod
    def from_config(cls, checkpoint: Optional[str] = None,
                    fsdp: Optional[int] = None, **kwargs):
        """Build from a converted MMDiT `.npz` (the port's `load_native`;
        the configuration stored beside the weights, else FLUX.1-dev's),
        made in the compute dtype on the device. `fsdp`: shard the MMDiT
        over that many ranks (-1: all of them) of the process group (the
        launcher's, else this process alone); it must divide the world
        size, and the rest of the world replicates it."""
        from s3od_torch.convert import load_mmdit

        if not checkpoint:
            raise RuntimeError(
                "No diffusion checkpoint provided. Pass checkpoint=path to a "
                "converted MMDiT .npz, or use backend=procedural for offline "
                "testing.")
        device = resolve_device(kwargs.get("device"))
        dtype = compute_dtype_for(device, kwargs.get("compute_dtype"))
        if fsdp is not None and kwargs.get("mesh") is None:
            kwargs["mesh"] = fsdp_mesh(fsdp, device.type)
        return cls(load_mmdit(checkpoint, device=device, dtype=dtype), **kwargs)

    # -- internals ---------------------------------------------------------

    def _tensor(self, a):
        return torch.from_numpy(np.array(a, np.float32)).to(self.device)

    def _step(self, x, txt, pooled, t, guidance, img_ids, txt_ids,
              concepts, concept_pooled):
        kwargs = dict(
            latents=x, txt=txt, pooled=pooled, timestep=t, img_ids=img_ids,
            txt_ids=txt_ids, guidance=guidance, concepts=concepts,
            pooled_concepts=concept_pooled if concepts is not None else None,
            concept_layers=self.concept_layers, compute_dtype=self.dtype)
        if self.merged is not None:
            return torch.func.functional_call(self.model, self.merged, (),
                                              kwargs)
        return self.model(**kwargs)

    def _no_grad(self):
        """Inference mode, or no_grad for a sharded MMDiT: FSDP2's
        gathers keep version counters, which inference tensors lack."""
        return torch.no_grad() if self.mesh is not None else torch.inference_mode()

    def __call__(self, *args, **kwargs) -> ConceptAttentionOutput:
        with self._no_grad():
            return self._run(*args, **kwargs)

    def _run(self, prompt: str, *, height: int, width: int, seed: int = 0,
                 concepts: Optional[Sequence[str]] = None,
                 init_image_latents: Optional[np.ndarray] = None,
                 strength_step: Optional[int] = None,
                 num_inference_steps: Optional[int] = None,
                 prompt_embeds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 concept_embeds: Optional[np.ndarray] = None,
                 concept_pooled: Optional[np.ndarray] = None,
                 ) -> ConceptAttentionOutput:
        steps = num_inference_steps or self.num_inference_steps
        lh, lw = height // 8, width // 8          # VAE latent grid
        ph, pw = lh // 2, lw // 2                 # packed token grid
        n_tokens = ph * pw
        sched = FlowMatchSchedule(shifted_sigmas(steps, calculate_shift(n_tokens)))

        if prompt_embeds is not None:
            t5_feat, pooled = prompt_embeds
        else:
            t5_feat, pooled = self.text_encoders.encode([prompt])
        if concepts is not None and concept_embeds is None:
            concept_embeds, concept_pooled = (
                self.text_encoders.encode_concepts(concepts))

        noise = initial_noise(seed, (1, n_tokens, self.cfg.in_channels),
                              self.device)
        if init_image_latents is not None:
            packed = pack_latents(self._tensor(init_image_latents))
            start = strength_step if strength_step is not None else 0
            x = sched.scale_noise(packed, noise, start)
            step_range = range(start, steps)
        else:
            x, step_range = noise, range(steps)

        img_ids = self._tensor(make_img_ids(ph, pw))
        txt_ids = torch.zeros(np.shape(t5_feat)[1], 3, device=self.device)
        txt, pooled_t = self._tensor(t5_feat), self._tensor(pooled)
        guidance = torch.full((1,), self.guidance_scale, device=self.device)
        cemb = self._tensor(concept_embeds) if concept_embeds is not None else None
        # The concept stream's modulation vector: the concepts' own CLIP
        # pooled embedding when available, else the prompt's.
        cpool = (self._tensor(concept_pooled) if concept_pooled is not None
                 else pooled_t)

        features: List[torch.Tensor] = []
        heat, n_heat = None, 0
        for i in step_range:
            t = torch.full((1,), float(sched.sigmas[i]), device=self.device)
            with_c = cemb is not None and i in self.concept_timesteps
            out = self._step(x, txt, pooled_t, t, guidance, img_ids, txt_ids,
                             cemb if with_c else None, cpool)
            if with_c:
                # (L, B, N_c, N_img): every (step, layer) entry weighs the same
                cm = out["concept_maps"]
                hm = cm.sum(0).reshape(cm.shape[1], cm.shape[2], ph, pw)
                heat = hm if heat is None else heat + hm
                n_heat += cm.shape[0]
            features = out["features"]  # keep the last step's taps
            x = sched.step(x, out["output"], i)

        comp = [compress_features(f).float().cpu().numpy() for f in features]
        maps: Dict[str, np.ndarray] = {}
        if heat is not None and concepts is not None:
            mm = minmax_normalize(heat / n_heat)[0].cpu().numpy()
            maps = dict(zip(concepts, mm))
        latents = unpack_latents(x, lh, lw)
        image = self.vae.decode(latents) if self.vae is not None else None
        return ConceptAttentionOutput(image=image,
                                      latents=latents.cpu().numpy(),
                                      features=comp, concept_maps=maps)

    # Backend protocol for the generation orchestrator ---------------------

    def generate(self, prompt, concept, height, width, seed):
        out = self(prompt, height=height, width=width, seed=seed,
                   concepts=[concept, "background"])
        if out.image is None:
            raise RuntimeError("VAE decoder unavailable; cannot produce pixels")
        feats = [f[0] for f in out.features]
        cmaps = {"category": out.concept_maps.get(concept),
                 "background": out.concept_maps.get("background")}
        return out.image, feats, cmaps

    # Feature extraction (offline .npz path) -------------------------------

    def extract_features(self, image_latents: np.ndarray, prompt: str,
                         concepts: Sequence[str], height: int, width: int,
                         **kw) -> ConceptAttentionOutput:
        """Single-step img2img noise inversion at the LAST timestep of a
        50-step schedule with the concept stream active (both reference
        extraction paths invert at scheduler.set_timesteps(50)'s final
        timestep)."""
        steps = 50
        old = self.concept_timesteps
        self.concept_timesteps = [steps - 1]
        try:
            return self(prompt, height=height, width=width,
                        init_image_latents=image_latents,
                        strength_step=steps - 1, num_inference_steps=steps,
                        concepts=list(concepts), **kw)
        finally:
            self.concept_timesteps = old
