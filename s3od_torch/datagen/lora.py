"""LoRA fine-tuning of the MMDiT, in PyTorch (counterpart of
`s3od_tpu/datagen/lora.py`).

Low-rank adapters over the MMDiT's attention projections, kept as a
separate nested tree of fp32 leaf tensors ({'A': (in, r), 'B': (r, out)},
the JAX package's layout), merged functionally into the forward
(`W_eff = W + (scale A @ B)` rounded to W's dtype, the delta transposed
into `nn.Linear`'s (out, in) weight) and trained with the rectified-flow
matching loss. The base weights stay frozen and unchanged: each block runs
on its merged weights through `torch.func.functional_call`, so the
`nn.Module` itself is never written.

The step computes in bf16 (the JAX package's default compute dtype) with
guidance 1.0; at the 1024^2 bucket every attention is K7 forward and K8
backward at (24, 4608, 128). `remat=True` recomputes each block in the
backward (`torch.utils.checkpoint`, non-reentrant): the merge happens
inside the recomputed function, so no merged weight is kept between the
passes, and K7 runs twice per block. The random draws (A at init, t and
the noise of a step) come from the module-level functions `lora_normal`,
`draw_timesteps` and `draw_noise`, which tests replace with the JAX
package's draws.

While a profiler records, the step opens the training step's spans
(`profiling.span`): `s3od.train.step` > `s3od.train.forward` (the draws
and the model), `s3od.train.loss`, `s3od.train.backward`, then
`s3od.train.optimizer`; each block's merge is `s3od.lora.merge`, and
`merge_block.merges` counts the merges (one a targeted block a forward:
57 a FLUX.1-dev step, twice that under `remat`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from s3od_torch.profiling import span

# Paths of the linear layers (relative to a block) that receive adapters.
DUAL_TARGETS = [
    ("img_attn", "qkv"), ("img_attn", "proj"),
    ("txt_attn", "qkv"), ("txt_attn", "proj"),
]
SINGLE_TARGETS = [("qkv",), ("proj_out",)]

# optax.adamw's defaults (`flux_finetune.py` calls `optax.adamw(lr)`):
# weight decay 1e-4, not torch's 0.01.
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 16.0

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _get(tree, path):
    for k in path:
        tree = tree[k] if isinstance(tree, dict) else getattr(tree, k)
    return tree


def lora_normal(generator: torch.Generator, shape: Tuple[int, int]):
    """The N(0, 1) draw of one adapter's A (before the 1/r)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def draw_timesteps(generator: torch.Generator, batch: int):
    """t = sigmoid(N(0, 1)) per sample: the logit-normal timestep."""
    return torch.sigmoid(torch.randn(batch, generator=generator,
                                     device=generator.device))


def draw_noise(generator: torch.Generator, x0):
    """The step's noise, N(0, 1) in x0's shape and dtype."""
    return torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                       device=generator.device)


def _targets(model) -> Iterator[Tuple[str, int, object, list]]:
    """("dual_blocks" | "single_blocks", index, block, target paths)."""
    for kind, targets in (("dual_blocks", DUAL_TARGETS),
                          ("single_blocks", SINGLE_TARGETS)):
        for i, blk in enumerate(getattr(model, kind)):
            yield kind, i, blk, targets


def init_lora_params(generator: torch.Generator, model, cfg: LoRAConfig) -> dict:
    """LoRA tree mirroring the targeted linears, NESTED by path segment
    (the `.npz` codec joins keys with "/"): {'dual_blocks': [...],
    'single_blocks': [...]}, each adapter {'A': (in, r) ~ N(0, 1) / r,
    'B': (r, out) = 0} in fp32 on the generator's device, leaf tensors
    that require grad. The draws run in the JAX package's order: dual
    blocks then single blocks, the targets in list order."""
    tree: Dict[str, List[dict]] = {"dual_blocks": [], "single_blocks": []}
    for kind, _, blk, targets in _targets(model):
        out: dict = {}
        for path in targets:
            dout, din = _get(blk, path).weight.shape
            node = out
            for seg in path[:-1]:
                node = node.setdefault(seg, {})
            a = lora_normal(generator, (din, cfg.rank)) / cfg.rank
            node[path[-1]] = {
                "A": a.requires_grad_(),
                "B": torch.zeros((cfg.rank, dout), dtype=torch.float32,
                                 device=a.device, requires_grad=True)}
        tree[kind].append(out)
    return tree


def lora_parameters(lora: dict) -> List[torch.Tensor]:
    """The tree's leaves in a fixed order (blocks, targets, A then B)."""
    out = []

    def walk(node):
        if isinstance(node, dict) and "A" in node:
            out.extend([node["A"], node["B"]])
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        else:
            for v in node:
                walk(v)

    walk(lora)
    return out


def lora_tree_from_arrays(tree, device=None) -> dict:
    """A tree of numpy arrays (`load_native`'s) -> fp32 tensors."""
    if isinstance(tree, dict):
        return {k: lora_tree_from_arrays(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lora_tree_from_arrays(v, device) for v in tree]
    return torch.as_tensor(tree, dtype=torch.float32, device=device)


def merge_block(block, adapters: dict, targets: Sequence[tuple],
                cfg: LoRAConfig) -> Dict[str, torch.Tensor]:
    """{"<path>.weight": W + (scale A @ B)^T rounded to W's dtype} for one
    block's targeted linears: `lora.py:99` with the (out, in) layout."""
    out = {}
    with span("s3od.lora.merge"):
        for path in targets:
            w = _get(block, path).weight
            ad = _get(adapters, path)
            delta = cfg.scale * torch.matmul(ad["A"], ad["B"])
            out[".".join(path) + ".weight"] = w + delta.to(w.dtype).t()
    merge_block.merges += 1
    return out


merge_block.merges = 0


def merge_lora(model, lora: dict, cfg: LoRAConfig) -> Dict[str, torch.Tensor]:
    """The merged weights of every targeted linear, by parameter name
    (`dual_blocks.0.img_attn.qkv.weight`, ...): the dict that
    `functional_call(model, merged, ...)` runs the forward on."""
    out = {}
    for kind, i, blk, targets in _targets(model):
        for name, w in merge_block(blk, lora[kind][i], targets, cfg).items():
            out[f"{kind}.{i}.{name}"] = w
    return out


def lora_block_runner(model, lora: dict, cfg: LoRAConfig, remat: bool = False):
    """`MMDiT.forward`'s `run_block`: each block on its merged weights
    through `functional_call`, recomputed in the backward under `remat`."""
    adapters = {id(blk): (lora[kind][i], targets)
                for kind, i, blk, targets in _targets(model)}

    def run(blk, *args):
        ad, targets = adapters[id(blk)]

        def call(*a):
            return functional_call(blk, merge_block(blk, ad, targets, cfg), a)

        if remat:
            return checkpoint(call, *args, use_reentrant=False)
        return call(*args)

    return run


def lora_velocity(model, lora: dict, cfg: LoRAConfig, batch: dict,
                  generator: torch.Generator, *, compute_dtype=torch.bfloat16,
                  attn_impl: str = "auto", remat: bool = False):
    """(v_theta(x_t, t), noise - x0): the draws (t ~ logit-normal, then
    the noise), x_t = (1 - t) x0 + t noise and the model's velocity at
    guidance 1.0 (`lora.py:114-141`).

    batch: {'latents': packed (B, N, C), 'txt': (B, L, Dt), 'pooled':
    (B, Dp), 'img_ids': (N, 3), 'txt_ids': (L, 3)}, tensors on the model's
    device."""
    x0 = batch["latents"]
    b = x0.shape[0]
    t = draw_timesteps(generator, b).to(x0.device)
    noise = draw_noise(generator, x0).to(x0.device)
    xt = (1 - t[:, None, None]) * x0 + t[:, None, None] * noise
    out = model(latents=xt, txt=batch["txt"], pooled=batch["pooled"],
                timestep=t, img_ids=batch["img_ids"], txt_ids=batch["txt_ids"],
                guidance=torch.full((b,), 1.0, device=x0.device),
                compute_dtype=compute_dtype, attn_impl=attn_impl,
                run_block=lora_block_runner(model, lora, cfg, remat))
    return out["output"], noise - x0


def lora_loss(model, lora: dict, cfg: LoRAConfig, batch: dict,
              generator: torch.Generator, *, compute_dtype=torch.bfloat16,
              attn_impl: str = "auto", remat: bool = False):
    """|| v_theta(x_t, t) - (noise - x0) ||^2 averaged (`lora_velocity`)."""
    v, target = lora_velocity(model, lora, cfg, batch, generator,
                              compute_dtype=compute_dtype,
                              attn_impl=attn_impl, remat=remat)
    return torch.mean((v - target) ** 2)


def lora_optimizer(lora: dict, lr: float) -> torch.optim.AdamW:
    """AdamW over the tree's leaves with optax.adamw's defaults (betas
    0.9/0.999, eps 1e-8, weight decay 1e-4): the same update, up to fp32
    rounding (`s3od_torch/training/optim.py`, item 3)."""
    return torch.optim.AdamW(lora_parameters(lora), lr=lr, betas=ADAMW_BETAS,
                             eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)


def make_lora_train_step(model, lora_cfg: LoRAConfig, optimizer, *,
                         compute_dtype=torch.bfloat16, attn_impl: str = "auto",
                         remat: bool = False):
    """Rectified-flow matching step on the LoRA leaves only: freezes the
    base (requires_grad off on its parameters; their values never change)
    and returns step(lora, batch, generator) -> loss (a 0-d tensor), which
    runs the forward, the backward into the LoRA leaves and one update of
    `optimizer` (`lora_optimizer`) in place."""
    model.requires_grad_(False)

    def step(lora, batch, generator):
        with span("s3od.train.step"):
            with span("s3od.train.forward"):
                v, target = lora_velocity(
                    model, lora, lora_cfg, batch, generator,
                    compute_dtype=compute_dtype, attn_impl=attn_impl,
                    remat=remat)
            with span("s3od.train.loss"):
                loss = torch.mean((v - target) ** 2)
            optimizer.zero_grad(set_to_none=True)
            with span("s3od.train.backward"):
                loss.backward()
            with span("s3od.train.optimizer"):
                optimizer.step()
        return loss.detach()

    return step


PACK_ORDER = b"diffusers_v1"


def _first_a(node):
    """The first adapter's A: (in, rank)."""
    if isinstance(node, dict):
        return node["A"] if "A" in node else _first_a(node[next(iter(node))])
    return _first_a(node[0])


def read_lora(lora, lora_scale=None, device=None) -> Tuple[dict, LoRAConfig]:
    """The adapters a pipeline merges (`diffusion.py:238-288` of the JAX
    package): `lora` is a tree or the path of a `flux_finetune` `.npz`,
    whose state carries alpha, rank and the latent-pack-order tag. alpha
    is `lora_scale` when given, else the file's, else 16.0 (the trainer's
    default, not the rank: training merged W + (alpha / rank) A @ B). A
    `pack_order` other than diffusers_v1 raises ValueError; a missing tag
    warns. -> (tree of fp32 tensors on `device`, LoRAConfig)."""
    import warnings

    import numpy as np

    alpha = lora_scale
    if isinstance(lora, str):
        from s3od_torch.convert import load_native

        path = lora
        lora, meta = load_native(path)
        if alpha is None and (meta or {}).get("alpha") is not None:
            alpha = float(np.asarray(meta["alpha"]))
        pack_order = (meta or {}).get("pack_order")
        if pack_order is not None and np.asarray(pack_order).tobytes() != PACK_ORDER:
            raise ValueError(
                f"LoRA artifact pack_order={pack_order!r} does not match this "
                "build's diffusers_v1 latent packing (pack_latents channel "
                "order ch*4+dy*2+dx); it was trained against a different "
                "packing and its adapters would be misread. Re-train or "
                "convert (docs/MIGRATION.md).")
        if pack_order is None:
            warnings.warn(
                f"LoRA artifact {path} has no pack_order tag: if it was "
                "trained before the pack_latents channel-order fix "
                "(docs/MIGRATION.md 'Artifact versioning') its adapters will "
                "be misinterpreted.", stacklevel=3)
    tree = lora_tree_from_arrays(lora, device)
    rank = _first_a(tree["dual_blocks"][0]).shape[1]
    return tree, LoRAConfig(rank=rank, alpha=16.0 if alpha is None else float(alpha))
