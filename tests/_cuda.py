"""What the card's tests (`tests/test_torch_*_cuda.py`) share: the `cuda`
fixture, the comparison with the plain version, the kernel wrappers'
launch counters and the inputs made from the fixture pair. Imported by
its bare name, as `_vjp_cases` is. Like the card's tests it imports no
JAX: they run on the card without it (`python3 chip_smoke.py`).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
IMAGE = REPO / "tests" / "fixture" / "image.jpg"
MASK = REPO / "tests" / "fixture" / "mask.png"
TINY = REPO / "tests" / "fixture" / "tiny_s3od.npz"
TINY_1024 = REPO / "tests" / "fixture" / "tiny_s3od_1024.npz"

REL_TOL = 1e-2  # max|kernel - plain| / max|plain| per output, bf16
LSE_TOL = 1e-3  # max|kernel - plain| of the fp32 lse
# ||kernel o - plain o|| / ||plain o|| of K3/K6 per call: the two round
# the same fp32 sums to bf16, which differ in order only; half the planted
# o x 1.01 (1.0e-2), which REL_TOL alone sits on the edge of
FLASH_NORM_TOL = 5e-3
# ||kernel - plain|| / ||plain|| of each of K8's dq, dk, dv per call at
# D = 128, on every call of a LoRA step too: 1.5x the worst measured on an
# H100 80GB HBM3 at 700 W (5.06e-4, a call of the 832 x 1216 LoRA step;
# 2.6e-4 on random inputs), tighter than FLASH_NORM_TOL, which the planted
# dk x 1.01 at D = 64 (9.75e-3 to 9.93e-3) clears by less
K8D_CALL_TOL = 7.6e-4
# ||kernel - plain|| / ||plain|| of each K9a, K9b and K10 call, alone or in
# a gated forward on the call's own inputs: about 2x the largest measured
# on an H100 80GB HBM3 at 700 W (K9b 7.0e-5 at 1024^2 and 2048^2; K9a
# 3.8e-5, K10 2.5e-5); a planted K9b or K9a x 1.01 reads 1.0e-2
DEC_CALL_TOL = 1.5e-4
B16 = 16  # remove_background_batch's chunk: the batch-16 shapes


@pytest.fixture(scope="session")
def cuda():
    """The card, or a skip: decided here, never while a module is
    imported, so that every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run on the card only)")
    return torch.device("cuda")


def rel_norm(got, ref) -> float:
    """||got - ref|| / ||ref|| in fp64."""
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def close(got, ref, norm_tol=None, lse=None, rel=REL_TOL):
    """Each output of `got` against `ref`: finite, max|d| within `rel` of
    max|ref|; the output at index `lse` within LSE_TOL in absolute terms
    instead; with `norm_tol`, ||d|| / ||ref|| within it too."""
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        assert torch.isfinite(g).all(), f"output {i} not finite"
        err = float((g - r).abs().max())
        if i == lse:
            assert err <= LSE_TOL, f"lse max|d| {err}"
            continue
        assert err <= rel * float(r.abs().max()), f"output {i} max|d| {err}"
        if norm_tol is not None:
            assert rel_norm(g, r) <= norm_tol, f"output {i} rel. norm {rel_norm(g, r)}"


def planted(got, which, factor=1.01):
    """`got` with output `which` times `factor` (a planted fault)."""
    out = list(got)
    out[which] = (got[which].float() * factor).to(got[which].dtype)
    return out


@contextlib.contextmanager
def standing_in(module, name, fn):
    """`module.name` is `fn` inside the block. The kernel wrappers count
    their launches on whatever their module's name resolves to, so `fn`
    carries a count of its own while it stands in."""
    real = getattr(module, name)
    if not hasattr(fn, "launches"):
        fn.launches = 0
    setattr(module, name, fn)
    try:
        yield fn
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def tf32_restored():
    """TF32's process-wide flags (which float32 exact mode turns off) as
    they were before the block, after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def wrappers():
    """The wrapper of each encoder kernel; K3 and K6 are one CUDA kernel
    behind one wrapper, told apart by the path that runs it."""
    from s3od_torch.ops import (attn_epilogue, flash_attention, layernorm,
                                mlp_fused, qkv_project)

    return {"K1": layernorm.layer_norm, "K2": qkv_project.qkv_project_rope,
            "K3": flash_attention.flash_attention,
            "K4": attn_epilogue.attn_epilogue, "K5": mlp_fused.mlp_fused}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def k8_launches() -> int:
    from s3od_torch.ops.flash_attention import flash_attention_bwd

    return flash_attention_bwd.launches


def reset_counts():
    from s3od_torch.ops import attn_epilogue, mlp_fused, qkv_project
    from s3od_torch.ops.flash_attention import (flash_attention_bwd,
                                                flash_attention_online)
    from s3od_torch.ops.qk_norm_rope import qk_norm_rope, qk_norm_rope_bwd

    for fn in [*wrappers().values(), *decoder_wrappers().values(),
               qkv_project.rope_bwd, attn_epilogue.ln_bwd, mlp_fused.gelu_bwd,
               qk_norm_rope, qk_norm_rope_bwd, flash_attention_bwd,
               flash_attention_online]:
        fn.launches = 0


def decoder_wrappers() -> dict:
    from s3od_torch.ops.experimental import mask_tail, winograd

    return {"K9a": winograd.winograd_conv, "K9b": winograd.winograd_rcu,
            "K10": mask_tail.mask_tail}


def decoder_counts() -> dict:
    return {name: fn.launches for name, fn in decoder_wrappers().items()}


@contextlib.contextmanager
def decoder_gates(on: bool):
    """Both gates of the decoder (`S3OD_WINOGRAD` as read into
    `ops/conv._WINOGRAD_ENABLED`, and `models/dpt.MASK_TAIL_FUSED`), set
    and restored."""
    from s3od_torch.models import dpt
    from s3od_torch.ops import conv

    old = conv._WINOGRAD_ENABLED, dpt.MASK_TAIL_FUSED
    conv._WINOGRAD_ENABLED = dpt.MASK_TAIL_FUSED = on
    try:
        yield
    finally:
        conv._WINOGRAD_ENABLED, dpt.MASK_TAIL_FUSED = old


def decoder_rule_counts(cfg, size: int, training: bool = False):
    """K9a, K9b and K10 launches of one forward at a square canvas by the
    copied rule, from the decoder's 3x3/s1/p1 convs written out (ViT
    patch 16): serving folds the BNs, so an RCU whose shape both rules
    admit is one K9b launch and its convs are not single convs; training
    keeps the BNs (no K9b) and the unfused tail (no K10), and returns
    K9a's forward and dx launches (where the rule admits the gradient's
    shape)."""
    from s3od_torch.ops.experimental.winograd import (rcu_winograd_available,
                                                     winograd_available)

    p = size // cfg.encoder.patch_size
    f, neck, inter = cfg.features, cfg.neck_channels, cfg.mask_inter_features
    rn = [4 * p, 2 * p, p, -(-p // 2)]
    singles = [(rn[i], neck[i], f) for i in range(4)]
    singles += [(8 * p, f, f // 2), (16 * p, 2 * inter, 2 * inter),
                (16 * p, 2 * inter, 3 * inter)]
    rcus = [rn[i] for i in range(4) for _ in range(1 if i == 3 else 2)]
    ok = lambda s, c, k: winograd_available(s, s, c, k)
    if training:
        convs = singles + [(s, f, f) for s in rcus for _ in range(2)]
        return (sum(ok(*sh) for sh in convs),
                sum(ok(s, c, k) and ok(s, k, c) for s, c, k in convs))
    chained = [s for s in rcus if ok(s, f, f) and rcu_winograd_available(s, s, f)]
    k9a = sum(ok(*sh) for sh in singles[:5]) + 2 * sum(
        ok(s, f, f) for s in rcus if s not in chained)
    return {"K9a": k9a, "K9b": len(chained), "K10": 1}


def fixture_pair():
    """The fixture photo (RGB uint8) and its mask (L uint8)."""
    from PIL import Image

    return (np.array(Image.open(IMAGE).convert("RGB")),
            np.array(Image.open(MASK).convert("L")))


def iou(a, b) -> float:
    inter = np.logical_and(a > 0.5, b > 0.5).sum()
    union = np.logical_or(a > 0.5, b > 0.5).sum()
    return float(inter / union) if union else 1.0


def fixture_variants(image, n: int = 16):
    """n images of varied aspect and content from one image: flips,
    crops and transposes."""
    h, w = image.shape[:2]
    imgs = []
    for i in range(n):
        im = image
        if i % 2:
            im = im[:, ::-1]
        if i % 4 >= 2:
            im = im[::-1]
        top, left = (i * 7) % (h // 4), (i * 11) % (w // 4)
        im = im[top: h - (i % 3) * h // 8, left: w - (i % 5) * w // 16]
        if i % 8 >= 4:
            im = im.transpose(1, 0, 2)
        imgs.append(np.ascontiguousarray(im))
    return imgs


def seeded_model(seed: int, encoder: str = "dinov3_base", device="cuda"):
    """S3OD at an encoder's width with seeded weights (DPT decoder)."""
    from s3od_torch.configs import segmentation_config
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_

    model = S3ODSegmentation(segmentation_config(encoder))
    return init_weights_(model, torch.Generator().manual_seed(seed)).to(device)


def fixture_batch(n: int, size: int):
    """A device batch of n letterboxed fixture variants (uint8 images and
    masks), as the loader and its upload produce it."""
    from s3od_torch.training.data import letterbox

    image, mask = fixture_pair()
    ims, ms = [], []
    for i in range(n):
        im, m = (image, mask) if i % 2 == 0 else (image[:, ::-1], mask[:, ::-1])
        a, b = letterbox(np.ascontiguousarray(im), np.ascontiguousarray(m), size)
        ims.append(a)
        ms.append(b)
    return {"images": torch.from_numpy(np.stack(ims)).cuda(),
            "masks": torch.from_numpy(np.stack(ms)).cuda()}


def write_fixture_dataset(root: Path, n: int = 20) -> Path:
    """root/fixture/{images,masks}/ PNG pairs made from the fixture pair:
    flips and cyclic shifts."""
    from PIL import Image

    image, mask = fixture_pair()
    h, w = mask.shape
    ds = root / "fixture"
    (ds / "images").mkdir(parents=True)
    (ds / "masks").mkdir(parents=True)
    for i in range(n):
        im, m = image, mask
        if i % 2:
            im, m = im[:, ::-1], m[:, ::-1]
        if i % 4 >= 2:
            im, m = im[::-1], m[::-1]
        shift = ((i * 37) % (h // 4) - h // 8, (i * 53) % (w // 4) - w // 8)
        im, m = np.roll(im, shift, (0, 1)), np.roll(m, shift, (0, 1))
        Image.fromarray(np.ascontiguousarray(im)).save(ds / "images" / f"f{i:02d}.png")
        Image.fromarray(np.ascontiguousarray(m)).save(ds / "masks" / f"f{i:02d}.png")
    return ds


def train_args(root: Path, base: str, *extra):
    """The training entry point's arguments: dinob-sized by default, the
    paper's 1024^2 canvas at batch 4 (config/dataset/synth.yaml) on the
    fixture dataset with the test-mode transform, bf16 on one card."""
    return ["model=dinob", "backend=1chip", "dataset=synth",
            "dataset.paths=[fixture]", "dataset.transform_mode=test",
            "dataset.val_split=0.2", "dataset.test_datasets=[]",
            "loss=focal_iou", "optimizer=adamw", "scheduler=cosine",
            "train_stage=dev_train", "backend.num_threads=8",
            f"data_dir={root}", f"base_dir={root / base}", *extra]


def only_run(base: Path) -> Path:
    runs = list((base / "checkpoints").iterdir())
    assert len(runs) == 1, f"one run directory under {base}, got {runs}"
    return runs[0]
