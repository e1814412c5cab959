"""The work of the benchmarked models counted from their shapes: the
floating-point operations of every matrix product and convolution of one
forward (two per multiply-add; elementwise work, norms and softmax not
counted), and the operations and bytes of the attention kernels' calls.

A training step counts three forwards (the forward, and a backward of
twice its products); a recomputation under checkpointing is not counted.
The H100 SXM's published dense peaks are the roofline.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def tokens(cfg: dict, h: int, w: int) -> int:
    p = cfg["patch_size"]
    return 1 + cfg["num_register_tokens"] + (h // p) * (w // p)


def encoder_flops(cfg: dict, h: int, w: int) -> float:
    """One image's encoder forward: the patch embedding and the blocks up
    to the last tap."""
    c, f, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    n = tokens(cfg, h, w)
    patches = (h // p) * (w // p)
    per_block = 2 * n * (4 * c * c + 2 * c * f) + 4 * n * n * c
    return 2 * patches * c * 3 * p * p + max(cfg["tap_layers"]) * per_block


def _conv(cin, cout, k, h_out, w_out) -> float:
    return 2.0 * cin * cout * k * k * h_out * w_out


def decoder_flops(cfg: dict, h: int, w: int) -> float:
    """One image's DPT neck, refinenets, IoU head and mask head."""
    p, c = cfg["patch_size"], cfg["hidden_size"]
    ph, pw = h // p, w // p
    neck, f = cfg["neck_channels"], cfg["features"]
    sizes = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw),
             ((ph + 1) // 2, (pw + 1) // 2)]
    total = 0.0
    for i, oc in enumerate(neck):
        total += _conv(c, oc, 1, ph, pw)
    total += _conv(neck[0], neck[0], 4, ph, pw)          # transposed, stride 4
    total += _conv(neck[1], neck[1], 2, ph, pw)          # transposed, stride 2
    total += _conv(neck[3], neck[3], 3, *sizes[3])       # stride 2
    for i, oc in enumerate(neck):
        total += _conv(oc, f, 3, *sizes[i])
    for level in range(4):                               # refinenet4..1
        hh, ww = sizes[3 - level]
        units = 1 if level == 0 else 2
        total += units * 2 * _conv(f, f, 3, hh, ww) + _conv(f, f, 1, hh, ww)
    hp, wp = 2 * sizes[0][0], 2 * sizes[0][1]            # path1
    inter, n = cfg["mask_inter_features"], cfg["num_outputs"]
    total += 2 * f * 64 + 2 * 64 * n                     # IoU head
    total += _conv(f, f // 2, 3, hp, wp)
    total += _conv(f // 2, 2 * inter, 4, hp, wp)         # transposed, stride 2
    total += _conv(2 * inter, 2 * inter, 3, 2 * hp, 2 * wp)
    total += n * (_conv(2 * inter, inter, 3, 2 * hp, 2 * wp)
                  + _conv(inter, 1, 1, 2 * hp, 2 * wp))
    return total


def fusion_flops(cfg: dict, h: int, w: int) -> float:
    """The teacher's four fusion levels."""
    p, f = cfg["patch_size"], cfg["features"]
    ph, pw = h // p, w // p
    sizes = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw),
             ((ph + 1) // 2, (pw + 1) // 2)]
    total = 0.0
    for hh, ww in sizes:
        total += _conv(f, f, 1, hh, ww)
        total += _conv(cfg["flux_dim"], f, 1, hh, ww)
        total += _conv(cfg["num_concept_channels"], f // 2, 3, hh, ww)
        total += _conv(2 * f + f // 2, f, 3, hh, ww)
        total += _conv(f, f, 1, hh, ww)
        total += _conv(2 * f, f, 1, hh, ww)
    return total


def forward_flops(cfg: dict, h: int, w: int) -> float:
    """One image's whole forward at (h, w)."""
    total = encoder_flops(cfg, h, w) + decoder_flops(cfg, h, w)
    if cfg.get("flux_dim"):
        total += fusion_flops(cfg, h, w)
    return total


def train_step_flops(cfg: dict, h: int, w: int, batch: int) -> float:
    return 3.0 * batch * forward_flops(cfg, h, w)


def attention_calls(cfg: dict, h: int, w: int, batch: int) -> List[Tuple[int, int, int]]:
    """The attention calls of one forward: (batch x heads, valid tokens,
    head dim), one a block that runs."""
    heads = cfg["num_attention_heads"]
    d = cfg["hidden_size"] // heads
    return [(batch * heads, tokens(cfg, h, w), d)] * max(cfg["tap_layers"])


def attention_fwd_least_s(bh: int, n: int, d: int) -> float:
    """Least time of one attention forward: its two products over the
    valid tokens at the bf16 peak, or q, k, v and o read or written once
    at the HBM peak, whichever is longer."""
    ops = 4.0 * bh * n * n * d
    nbytes = 4.0 * bh * n * d * 2
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def attention_bwd_least_s(bh: int, n: int, d: int) -> float:
    """Least time of one attention backward: its five products (S, dP,
    dV, dQ, dK), or q, k, v, o, dO read and dQ, dK, dV written once."""
    ops = 10.0 * bh * n * n * d
    nbytes = 8.0 * bh * n * d * 2
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)

