"""The program under test as the LoRA cell reaches it: the port's MMDiT
(`s3od_torch.models.mmdit`) loaded from the seeded weights, and its LoRA
fine-tuning step (`s3od_torch.datagen.lora`) built as
`datagen/flux_finetune.run` builds it: `init_lora_params`,
`lora_optimizer`, `make_lora_train_step`. Beside `perfbench/program.py`,
the only modules of the benchmark that import the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from perfbench.inputs import mix


def mmdit_config(cfg: dict):
    from s3od_torch.models.mmdit import MMDiTConfig

    return MMDiTConfig(
        hidden_size=cfg["hidden_size"], num_heads=cfg["num_attention_heads"],
        num_dual_blocks=cfg["num_layers"], num_single_blocks=cfg["num_single_layers"],
        mlp_ratio=cfg["mlp_ratio"], text_dim=cfg["joint_attention_dim"],
        pooled_dim=cfg["pooled_projection_dim"], in_channels=cfg["in_channels"],
        axes_dims=tuple(cfg["axes_dims_rope"]), rope_theta=cfg["rope_theta"],
        guidance_embed=cfg["guidance_embeds"])


def build_model(cfg: dict, sd: Dict[str, torch.Tensor]):
    """The port's `MMDiT`, its parameters the tensors of `sd` themselves
    (built on the meta device, then assigned: no second copy)."""
    from s3od_torch.models.mmdit import MMDiT

    model = MMDiT(mmdit_config(cfg), device="meta", dtype=getattr(torch, cfg["dtype"]))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A LoRA tree ({"dual_blocks": [{"img_attn": {"qkv": {"A", "B"}}}],
    ...}) -> {"dual_blocks.0.img_attn.qkv.A": leaf, ...}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        name = f"{prefix}{k}"
        if isinstance(v, torch.Tensor):
            out[name] = v
        else:
            out.update(flatten(v, name + "."))
    return out


@dataclasses.dataclass
class LoRATrainer:
    """The port's LoRA step with its adapters and optimizer: built once,
    driven step after step."""
    model: torch.nn.Module
    lora: dict
    optimizer: torch.optim.Optimizer
    step_fn: object

    def step(self, batch, generator: torch.Generator):
        return self.step_fn(self.lora, batch, generator)

    def leaves(self) -> Dict[str, torch.Tensor]:
        return flatten(self.lora)


def trainer(cfg: dict, model, recipe: dict, seed: int, device) -> LoRATrainer:
    from s3od_torch.datagen.lora import (LoRAConfig, init_lora_params,
                                         lora_optimizer, make_lora_train_step)

    lcfg = LoRAConfig(rank=cfg["lora"]["rank"], alpha=cfg["lora"]["alpha"])
    lora = init_lora_params(torch.Generator(device=device).manual_seed(mix(seed, 2)),
                            model, lcfg)
    opt = lora_optimizer(lora, recipe["lr"])
    step = make_lora_train_step(model, lcfg, opt,
                                compute_dtype=getattr(torch, cfg["dtype"]),
                                remat=recipe["remat"])
    return LoRATrainer(model, lora, opt, step)


def counts() -> Tuple[int, int, Optional[int]]:
    """The port's running counts: K7's and K8's launches and the LoRA
    merges (None where the port does not count them)."""
    from s3od_torch.datagen import lora
    from s3od_torch.ops import flash_attention as fa

    return (fa.flash_attention_online.launches, fa.flash_attention_bwd.launches,
            getattr(lora.merge_block, "merges", None))


@contextlib.contextmanager
def single_adapters_dropped():
    """A planted fault for calibration: inside the block, each trainer that
    `trainer` builds runs its single-stream blocks without their adapters
    (the port's `SINGLE_TARGETS` emptied once the tree is built, so its
    single-block leaves take no gradient)."""
    from s3od_torch.datagen import lora

    real, old = globals()["trainer"], lora.SINGLE_TARGETS

    def faulty(*args, **kwargs):
        built = real(*args, **kwargs)
        lora.SINGLE_TARGETS = []
        return built

    globals()["trainer"] = faulty
    try:
        yield
    finally:
        globals()["trainer"] = real
        lora.SINGLE_TARGETS = old
