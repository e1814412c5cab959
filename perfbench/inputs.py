"""Everything a run feeds the program, made from `--seed`: the weights
(a state dict in the published checkpoint's layout), the serving cells'
image pools, the training batches and the teacher's FLUX features and
concept maps.

The weights, the training inputs and the serving images are made on the
run's device by seeded `torch.Generator`s (the weights in two large draws,
then sliced); the serving images are then copied to the host. Every seed gives the same set of image sizes and
buckets, in another order and with other pixels, so that the work a run
does does not depend on its seed.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ASPECTS = {"1:1": 1.0, "4:3": 4 / 3, "3:4": 3 / 4, "3:2": 1.5, "2:3": 2 / 3,
           "16:9": 16 / 9}


def mix(seed: int, salt: int) -> int:
    """A 63-bit stream number from the run's seed and a purpose."""
    return (int(seed) * 6364136223846793005 + salt * 1442695040888963407) % (1 << 63)


# --- weights ---------------------------------------------------------------

def leaf_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, law, scale) of every tensor of the model's state dict
    in the checkpoint layout. Laws: "normal" N(0, scale^2) clipped at two
    sigma; "uniform" U(-scale, scale); "one" 1 + U(-scale, scale);
    "range" U(scale, 2 scale); "zero"."""
    c = cfg["hidden_size"]
    f_mlp = cfg["intermediate_size"]
    p = cfg["patch_size"]
    out: List[Tuple[str, tuple, str, float]] = []
    add = lambda name, shape, law, scale=0.0: out.append((name, tuple(shape), law, scale))

    e = "encoder."
    add(e + "embeddings.cls_token", (1, 1, c), "normal", 0.02)
    add(e + "embeddings.mask_token", (1, 1, c), "zero")
    add(e + "embeddings.register_tokens", (1, cfg["num_register_tokens"], c), "normal", 0.02)
    add(e + "embeddings.patch_embeddings.weight", (c, 3, p, p), "normal", 0.02)
    add(e + "embeddings.patch_embeddings.bias", (c,), "normal", 0.02)
    for i in range(cfg["num_hidden_layers"]):
        b = f"{e}layer.{i}."
        add(b + "norm1.weight", (c,), "one", 0.25)
        add(b + "norm1.bias", (c,), "normal", 0.05)
        add(b + "attention.o_proj.weight", (c, c), "normal", 0.02)
        add(b + "attention.o_proj.bias", (c,), "normal", 0.02)
        add(b + "attention.q_proj.weight", (c, c), "normal", 0.02)
        add(b + "attention.q_proj.bias", (c,), "normal", 0.02)
        add(b + "attention.k_proj.weight", (c, c), "normal", 0.02)
        add(b + "attention.v_proj.weight", (c, c), "normal", 0.02)
        add(b + "attention.v_proj.bias", (c,), "normal", 0.02)
        add(b + "layer_scale1.lambda1", (c,), "range", 0.25)
        add(b + "norm2.weight", (c,), "one", 0.25)
        add(b + "norm2.bias", (c,), "normal", 0.05)
        add(b + "mlp.up_proj.weight", (f_mlp, c), "normal", 0.02)
        add(b + "mlp.up_proj.bias", (f_mlp,), "normal", 0.02)
        add(b + "mlp.down_proj.weight", (c, f_mlp), "normal", 0.02)
        add(b + "mlp.down_proj.bias", (c,), "normal", 0.02)
        add(b + "layer_scale2.lambda1", (c,), "range", 0.25)
    add(e + "norm.weight", (c,), "one", 0.25)
    add(e + "norm.bias", (c,), "normal", 0.05)

    def conv(name, cout, cin, k, bias=True, transposed=False):
        # Weights of variance 1 / fan_in, biases U(+-sqrt(1 / fan_in)):
        # the decoder's signal neither dies out nor saturates, so seeded
        # masks vary over the image (about 0.1-0.9) and the IoU scores
        # spread over (0, 1).
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        fan_in = (cout if transposed else cin) * k * k
        bound = math.sqrt(1.0 / fan_in)
        add(name + ".weight", shape, "uniform", math.sqrt(3.0) * bound)
        if bias:
            add(name + ".bias", (cout,), "uniform", bound)

    def bn(name, ch):
        add(name + ".weight", (ch,), "one", 0.5)
        add(name + ".bias", (ch,), "normal", 0.1)
        add(name + ".running_mean", (ch,), "normal", 0.1)
        add(name + ".running_var", (ch,), "range", 0.5)
        add(name + ".num_batches_tracked", (), "zero")

    s = "seg_head."
    neck = cfg["neck_channels"]
    f = cfg["features"]
    for i, oc in enumerate(neck):
        conv(f"{s}projects.{i}", oc, c, 1)
    conv(f"{s}resize_layers.0", neck[0], neck[0], 4, transposed=True)
    conv(f"{s}resize_layers.1", neck[1], neck[1], 2, transposed=True)
    conv(f"{s}resize_layers.3", neck[3], neck[3], 3)
    for i, oc in enumerate(neck):
        conv(f"{s}scratch.layer{i + 1}_rn", f, oc, 3, bias=False)
    for i in range(1, 5):
        r = f"{s}scratch.refinenet{i}."
        conv(r + "out_conv", f, f, 1)
        for u in ("resConfUnit1", "resConfUnit2"):
            conv(r + u + ".conv1", f, f, 3)
            conv(r + u + ".conv2", f, f, 3)
            if cfg["use_bn"]:
                bn(r + u + ".bn1", f)
                bn(r + u + ".bn2", f)
    conv(f"{s}classifier_head.2", 64, f, 1)
    conv(f"{s}classifier_head.4", cfg["num_outputs"], 64, 1)
    inter = cfg["mask_inter_features"]
    m = f"{s}mask_head."
    conv(m + "output_conv1", f // 2, f, 3)
    conv(m + "upsample_2x.0", 2 * inter, f // 2, 4, transposed=True)
    conv(m + "upsample_2x.2", 2 * inter, 2 * inter, 3)
    for i in range(cfg["num_outputs"]):
        conv(f"{m}mask_heads.{i}.0", inter, 2 * inter, 3)
        conv(f"{m}mask_heads.{i}.2", 1, inter, 1)

    if cfg.get("flux_dim"):
        for lvl in range(4):
            fu = f"fusion.{lvl}."
            conv(fu + "vit.conv", f, f, 1)
            bn(fu + "vit.bn", f)
            conv(fu + "flux.conv", f, cfg["flux_dim"], 1)
            bn(fu + "flux.bn", f)
            conv(fu + "concept.conv", f // 2, cfg["num_concept_channels"], 3)
            bn(fu + "concept.bn", f // 2)
            conv(fu + "fusion.conv1", f, 2 * f + f // 2, 3)
            bn(fu + "fusion.bn1", f)
            conv(fu + "fusion.conv2", f, f, 1)
            bn(fu + "fusion.bn2", f)
            conv(fu + "final", f, 2 * f, 1)
    # Linears of the classifier head are stored 2-D.
    return [(n, sh[:2] if "classifier_head" in n and len(sh) == 4 else sh, law, sc)
            for n, sh, law, sc in out]


def state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded float32 weights, on `device`: two draws (normal and
    uniform) over every element at once, sliced and scaled leaf by leaf."""
    specs = leaf_specs(cfg)
    total = sum(math.prod(sh) for _, sh, _, _ in specs)
    g = torch.Generator(device=device).manual_seed(mix(seed, 1))
    normal = torch.randn(total, generator=g, device=device).clamp_(-2.0, 2.0)
    unif = torch.rand(total, generator=g, device=device)
    sd: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape, law, scale in specs:
        n = math.prod(shape)
        z, u = normal[off: off + n].view(shape), unif[off: off + n].view(shape)
        off += n
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros((), dtype=torch.long, device=device)
        elif law == "normal":
            sd[name] = z * scale
        elif law == "uniform":
            sd[name] = (2 * u - 1) * scale
        elif law == "one":
            sd[name] = 1 + (2 * u - 1) * scale
        elif law == "range":
            sd[name] = scale * (1 + u)
        else:
            sd[name] = torch.zeros(shape, device=device)
    return sd


# --- serving images ----------------------------------------------------------

def image_sizes(traffic: dict) -> List[Tuple[int, int]]:
    """The pool's (height, width) list, the same for every seed: longest
    sides at the pool's quantiles of a log-uniform law over [lo, hi], the
    aspects cycled."""
    n = traffic["pool"]
    lo, hi = traffic["longest_side"]
    aspects = [ASPECTS[a] for a in traffic["aspects"]]
    out = []
    for i in range(n):
        side = lo * (hi / lo) ** ((i + 0.5) / n)
        a = aspects[i % len(aspects)]  # width / height
        if a >= 1:
            w, h = side, side / a
        else:
            h, w = side, side * a
        out.append((int(round(h)), int(round(w))))
    return out


def image_pool(traffic: dict, seed: int, device) -> List[np.ndarray]:
    """uint8 (H, W, 3) host images: a smooth seeded field (an 8 x 8 grid
    of colours, bilinearly enlarged) with seeded grain, made on `device`,
    in a seeded order of the fixed sizes."""
    sizes = image_sizes(traffic)
    rng = np.random.default_rng(mix(seed, 2))
    order = rng.permutation(len(sizes))
    g = torch.Generator(device=device).manual_seed(mix(seed, 3))
    pool = []
    for i in order:
        h, w = sizes[i]
        base = torch.rand((1, 3, 8, 8), generator=g, device=device) * 255
        img = F.interpolate(base, size=(h, w), mode="bilinear", align_corners=False)[0]
        grain = torch.randint(-24, 25, (3, h, w), generator=g, device=device,
                              dtype=torch.int16)
        img = (img.round().to(torch.int16) + grain).clamp_(0, 255).to(torch.uint8)
        pool.append(img.permute(1, 2, 0).contiguous().cpu().numpy())
    return pool


def passes(n_pool: int, seed: int) -> Iterator[int]:
    """Pool indices of the requests, without end: seeded passes over the
    pool, each a permutation of it."""
    rng = np.random.default_rng(mix(seed, 9))
    while True:
        yield from (int(i) for i in rng.permutation(n_pool))


# --- training inputs ---------------------------------------------------------

def _smooth(g, shape, cells, device):
    """(B, C, H, W) smooth seeded fields in [0, 1]: (cells x cells) noise
    enlarged bilinearly."""
    b, ch, h, w = shape
    coarse = torch.rand((b, ch, cells, cells), generator=g, device=device)
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def train_batches(traffic: dict, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """`pool` batches of `batch` rows at `size`^2, made on the device:
    images ImageNet-normalized fp32 (B, S, S, 3) (smooth colour fields
    with grain), masks {0, 1} fp32 (B, S, S) (a thresholded smooth field).
    Every row of every batch differs."""
    n, b, s = traffic["pool"], traffic["batch"], traffic["size"]
    g = torch.Generator(device=device).manual_seed(mix(seed, 5))
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    out = []
    for _ in range(n):
        img = _smooth(g, (b, 3, s, s), 8, device)
        img = img + 0.1 * (torch.rand((b, 3, s, s), generator=g, device=device) - 0.5)
        img = img.clamp(0, 1).permute(0, 2, 3, 1)
        masks = (_smooth(g, (b, 1, s, s), 6, device)[:, 0] > 0.5).float()
        out.append({"images": ((img - mean) / std).contiguous(), "masks": masks})
    return out


def teacher_samples(traffic: dict, cfg: dict, seed: int, device) -> List[dict]:
    """One batch-1 sample per bucket of `traffic["buckets"]`, in a seeded
    order: uint8 images (1, H, W, 3), masks {0, 1} fp32 (1, H, W), four
    FLUX feature maps (1, H/16 * W/16, flux_dim) (standard normal, rounded
    to float16 as the feature files store them) and the category and
    background concept maps (1, H/16, W/16) in [0, 1]."""
    g = torch.Generator(device=device).manual_seed(mix(seed, 6))
    order = np.random.default_rng(mix(seed, 7)).permutation(len(traffic["buckets"]))
    p = cfg["patch_size"]
    out = []
    for i in order:
        h, w = traffic["buckets"][i]
        img = _smooth(g, (1, 3, h, w), 8, device)
        img = img + 0.1 * (torch.rand((1, 3, h, w), generator=g, device=device) - 0.5)
        img = (img.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1)
        masks = (_smooth(g, (1, 1, h, w), 6, device)[:, 0] > 0.5).float()
        seq = (h // p) * (w // p)
        feats = [torch.randn((1, seq, cfg["flux_dim"]), generator=g, device=device)
                 .half().float() for _ in range(4)]
        cat = _smooth(g, (1, 1, h // p, w // p), 4, device)[:, 0]
        out.append({"images": img.contiguous(), "masks": masks,
                    "transformer_features": feats,
                    "concept_maps": {"category": cat, "background": 1 - cat}})
    return out
