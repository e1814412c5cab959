"""DPT decoder in PyTorch (counterpart of `s3od_tpu/models/dpt.py`).

NCHW; parameter names follow the reference checkpoint (`seg_head.*`
keys). Every conv runs cuDNN (every 3x3 through `ops/conv.conv2d`) unless
one of the JAX package's two gates is on, as there:
- `S3OD_WINOGRAD=1` (`ops/conv.py`): eligible 3x3 convs run K9a, and a
  BN-folded ResidualConvUnit (BN Identity, conv biases, both rules true)
  runs K9b as one call (`dpt.py:76-95`).
- `MASK_TAIL_FUSED` (below): the serving forward's mask-head tail runs
  K10 (`dpt.py:364-382`).
Both are off by default, and both act on the bf16 route only. With K10
off, the mask heads' tail after the fused 3x3 (its bias, the ReLU, the
1x1 convs) is one Triton pass each way on the bf16 route
(`ops/mask_logits.py`), training and serving alike. Structure:

  taps (B, N, C) x4 -> 1x1 project -> resize (convT x4, convT x2, id,
  3x3 s2) -> 3x3 scratch convs -> refinenet4..1 (RCUs + 1x1 out_conv +
  bilinear upsample) -> path1 -> IoU head (GAP -> 64 -> n) and mask head
  (3x3 -> convT x2 -> 3x3 -> n branch convs).

`fold_bn_` folds the eval-mode RCU BatchNorms into the preceding convs in
float64, as `fold_bn_inference` does (`dpt.py:514-564`).

Weights are cast to the input's dtype at use (`_conv`, `_linear`), so fp32
master weights train in bf16 as in the JAX package. The BatchNorms run
`batch_norm` (`s3od_tpu/ops/conv.py:batch_norm`): batch statistics in
training, with torch's running-stat convention. The decoder is not
checkpointed: at ViT-B, 1024^2, batch 4 its activations fit, and a
recompute would update the running statistics twice.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from s3od_torch.configs import SegmentationConfig
from s3od_torch.ops import conv as conv_ops
from s3od_torch.ops.experimental import winograd
from s3od_torch.ops.experimental.mask_tail import mask_tail
from s3od_torch.ops.experimental.winograd import rcu_winograd
from s3od_torch.ops.mask_logits import mask_logits_autograd
from s3od_torch.ops.resize import resize_bilinear

# The fused mask-head tail (K10) for the serving forward; off, as the JAX
# package ships it (`s3od_tpu/models/dpt.py:49`).
MASK_TAIL_FUSED = False


def _conv(mod: nn.Module, x):
    """`mod` (Conv2d, ConvTranspose2d or Identity) on x, its weights cast
    to x's dtype at use."""
    if isinstance(mod, nn.Identity):
        return x
    if isinstance(mod, nn.ConvTranspose2d):
        w = mod.weight.to(x.dtype)
        b = mod.bias.to(x.dtype) if mod.bias is not None else None
        return F.conv_transpose2d(x, w, b, mod.stride, mod.padding,
                                  mod.output_padding, mod.groups, mod.dilation)
    return conv_ops.conv2d(x, mod.weight, mod.bias, mod.stride[0],
                           mod.padding[0])


def _linear(mod: nn.Linear, x):
    return F.linear(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group; the backward sums the ranks' gradients
    (each rank's statistics feed every rank's loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def batch_norm(bn: nn.Module, x, training: bool, group=None):
    """BatchNorm2d over NCHW as `s3od_tpu/ops/conv.py:batch_norm` computes
    it: fp32 statistics (E[x^2] - E[x]^2 over the batch in training, the
    running ones otherwise), then y = x * scale + shift with scale and
    shift rounded to x's dtype. Training updates the running statistics
    in place with torch's convention: momentum 0.1, unbiased variance in
    the running statistics, biased in the normalization. Given a process
    `group` whose ranks hold different rows of one batch (the trainer's,
    under data parallelism), the training statistics are that global
    batch's, n counting every rank's rows; `nn.SyncBatchNorm` would round
    in another order. Without a group each rank's rows alone."""
    if isinstance(bn, nn.Identity):
        return x
    if training:
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        ex2 = (xf * xf).mean(dim=(0, 2, 3))
        n = x.numel() // x.shape[1]
        if group is not None:
            # The global batch's statistics, as the JAX step takes them
            # over its sharded batch: the ranks' [mean, E[x^2]] averaged
            # (equal row counts), through a collective that carries
            # autograd (its backward sums the ranks' gradients).
            w = dist.get_world_size(group)
            stats = _AllReduceSum.apply(torch.stack([mean, ex2]), group) / w
            mean, ex2 = stats[0], stats[1]
            n *= w
        var = ex2 - mean * mean
        m = bn.momentum
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            bn.running_mean.copy_((1 - m) * bn.running_mean + m * mean)
            bn.running_var.copy_((1 - m) * bn.running_var + m * unbiased)
            bn.num_batches_tracked += 1
    else:
        mean, var = bn.running_mean.float(), bn.running_var.float()
    scale = bn.weight.float() * torch.rsqrt(var + bn.eps)
    shift = bn.bias.float() - mean * scale
    return (x * scale.to(x.dtype)[:, None, None]
            + shift.to(x.dtype)[:, None, None])


class ResidualConvUnit(nn.Module):
    """ReLU -> conv -> [BN] -> ReLU -> conv -> [BN] -> + x."""

    def __init__(self, features: int, use_bn: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        bn = (lambda: nn.BatchNorm2d(features)) if use_bn else nn.Identity
        self.bn1, self.bn2 = bn(), bn()

    def forward(self, x, training: bool = False, bn_group=None):
        if self._chained(x):
            p1 = {"kernel": self.conv1.weight.to(x.dtype).permute(2, 3, 1, 0),
                  "bias": self.conv1.bias}
            p2 = {"kernel": self.conv2.weight.to(x.dtype).permute(2, 3, 1, 0),
                  "bias": self.conv2.bias}
            y = rcu_winograd(x.permute(0, 2, 3, 1), p1, p2)
            return y.permute(0, 3, 1, 2)
        out = batch_norm(self.bn1, _conv(self.conv1, F.relu(x)), training,
                         bn_group)
        out = batch_norm(self.bn2, _conv(self.conv2, F.relu(out)), training,
                         bn_group)
        return out + x

    def _chained(self, x) -> bool:
        """The BN-folded form with the Winograd gate on and both rules
        true: the whole unit is one K9b call (`dpt.py:76-95`)."""
        if not (isinstance(self.bn1, nn.Identity)
                and isinstance(self.bn2, nn.Identity)
                and self.conv1.bias is not None):
            return False
        _, c, h, w = x.shape
        return (conv_ops._winograd_eligible(x, self.conv1.weight, 1, 1)
                and winograd.rcu_winograd_available(h, w, c, x.dtype))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, use_bn: bool):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1)
        self.resConfUnit1 = ResidualConvUnit(features, use_bn)
        self.resConfUnit2 = ResidualConvUnit(features, use_bn)

    def forward(self, x, res: Optional[torch.Tensor], out_hw,
                training: bool = False, bn_group=None):
        if res is not None:
            x = x + self.resConfUnit1(res, training, bn_group)
        x = self.resConfUnit2(x, training, bn_group)
        # 1x1 conv and bilinear resize commute; the conv runs on 4x fewer
        # pixels first (as in the JAX package).
        return resize_bilinear(_conv(self.out_conv, x), out_hw)


class Scratch(nn.Module):
    def __init__(self, neck: Tuple[int, ...], features: int, use_bn: bool):
        super().__init__()
        for i, c in enumerate(neck):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features, use_bn))


class MaskHead(nn.Module):
    def __init__(self, features: int, inter: int, num_outputs: int):
        super().__init__()
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.upsample_2x = nn.Sequential(
            nn.ConvTranspose2d(features // 2, 2 * inter, 4, stride=2, padding=1),
            nn.ReLU(),
            nn.Conv2d(2 * inter, 2 * inter, 3, padding=1),
        )
        self.mask_heads = nn.ModuleList(
            nn.Sequential(nn.Conv2d(2 * inter, inter, 3, padding=1), nn.ReLU(),
                          nn.Conv2d(inter, 1, 1))
            for _ in range(num_outputs)
        )

    def forward(self, path1, target_hw, fused_tail: bool = False):
        """`fused_tail`: the serving forward may run K10 (the JAX
        `masks_nhwc` and `not training` conditions, `dpt.py:368-374`)."""
        feat = _conv(self.output_conv1, path1)
        up = self.upsample_2x
        feat = _conv(up[0], feat)
        heads = self.mask_heads
        dt = feat.dtype
        # The branches' 3x3 convs run as ONE conv over the shared features
        # and their 1x1 convs as one block-diagonal product.
        k_fused = torch.cat([h[0].weight for h in heads])
        b_fused = torch.cat([h[0].bias for h in heads])
        hh, ww = feat.shape[-2:]
        if (fused_tail and MASK_TAIL_FUSED and dt == torch.bfloat16
                and (hh, ww) == tuple(target_hw) and hh % 8 == 0
                and ww % 8 == 0):
            inter, n = heads[0][0].weight.shape[0], len(heads)
            k1 = torch.zeros(inter * n, n, dtype=dt, device=feat.device)
            for i, h in enumerate(heads):
                k1[i * inter: (i + 1) * inter, i] = h[2].weight[0, :, 0, 0]
            m = mask_tail(
                feat.permute(0, 2, 3, 1), up[2].weight.permute(2, 3, 1, 0),
                up[2].bias, k_fused.permute(2, 3, 1, 0), b_fused, k1,
                torch.cat([h[2].bias for h in heads]))
            return m.permute(0, 3, 1, 2)
        feat = F.relu(_conv(up[2], F.relu(feat)))
        feat = resize_bilinear(feat, target_hw, antialias=True)  # no-op at 16p
        # The fused 3x3 without its bias; its bias, the ReLU and the 1x1s
        # follow as one pass each way on the bf16 route (`ops/mask_logits`).
        pre = conv_ops.conv2d(feat, k_fused, padding=1)
        w1 = torch.cat([h[2].weight for h in heads]).reshape(len(heads), -1)
        return mask_logits_autograd(pre, b_fused.to(dt), w1.to(dt),
                                    torch.cat([h[2].bias for h in heads]).to(dt))


class DPTHead(nn.Module):
    def __init__(self, cfg: SegmentationConfig):
        super().__init__()
        c, neck, f = cfg.encoder.hidden_size, tuple(cfg.neck_channels), cfg.features
        self.projects = nn.ModuleList(nn.Conv2d(c, oc, 1) for oc in neck)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(neck[0], neck[0], 4, stride=4),
            nn.ConvTranspose2d(neck[1], neck[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(neck[3], neck[3], 3, stride=2, padding=1),
        ])
        self.scratch = Scratch(neck, f, cfg.use_bn)
        # Indices 2 and 4 hold the weights (reference layout); the pooling
        # runs in forward() with an fp32 accumulator.
        self.classifier_head = nn.Sequential(
            nn.Identity(), nn.Identity(), nn.Linear(f, 64), nn.ReLU(),
            nn.Linear(64, cfg.num_outputs))
        self.mask_head = MaskHead(f, cfg.mask_inter_features, cfg.num_outputs)

    def forward(self, taps: List[torch.Tensor], patch_hw, patch_size: int,
                training: bool = False, serving: bool = False, bn_group=None):
        """`training` normalizes with batch statistics and updates the
        BatchNorms' running statistics (the global batch's over `bn_group`,
        `batch_norm`); `serving` marks the serving forward (the JAX
        `serving_fast_output`), the one that may run K10."""
        return self.decode(self.neck(taps, patch_hw), patch_hw, patch_size,
                           training, serving, bn_group)

    def neck(self, taps: List[torch.Tensor], patch_hw) -> List[torch.Tensor]:
        """Project and resize each tap to its pyramid level (strides 4, 8,
        16, 32), then the 3x3 scratch convs."""
        ph, pw = patch_hw
        feats = []
        for proj, resize, t in zip(self.projects, self.resize_layers, taps):
            b, _, c = t.shape
            x = t.transpose(1, 2).reshape(b, c, ph, pw)
            feats.append(_conv(resize, _conv(proj, x)))
        s = self.scratch
        return [_conv(getattr(s, f"layer{i + 1}_rn"), f)
                for i, f in enumerate(feats)]

    def decode(self, rn: List[torch.Tensor], patch_hw, patch_size: int,
               training: bool = False, serving: bool = False,
               bn_group=None):
        """Refinenets 4..1 over the pyramid, then the IoU and mask heads."""
        ph, pw = patch_hw
        s = self.scratch
        hw = lambda a: tuple(a.shape[-2:])
        path = s.refinenet4(rn[3], None, hw(rn[2]), training, bn_group)
        path = s.refinenet3(path, rn[2], hw(rn[1]), training, bn_group)
        path = s.refinenet2(path, rn[1], hw(rn[0]), training, bn_group)
        path1 = s.refinenet1(path, rn[0], (2 * rn[0].shape[-2],
                                           2 * rn[0].shape[-1]), training,
                             bn_group)

        pooled = path1.float().mean(dim=(2, 3)).to(path1.dtype)
        fc1, fc2 = self.classifier_head[2], self.classifier_head[4]
        iou = _linear(fc2, F.relu(_linear(fc1, pooled)))
        masks = self.mask_head(path1, (ph * patch_size, pw * patch_size),
                               serving and not training)
        return masks, iou


@torch.no_grad()
def fold_bn_(head: DPTHead) -> None:
    """Fold every eval-mode RCU BatchNorm into its preceding conv, in
    float64 (exact up to the final rounding); the BNs become Identity."""
    for i in range(1, 5):
        block = getattr(head.scratch, f"refinenet{i}")
        for rcu in (block.resConfUnit1, block.resConfUnit2):
            for conv_name, bn_name in (("conv1", "bn1"), ("conv2", "bn2")):
                conv, bn = getattr(rcu, conv_name), getattr(rcu, bn_name)
                if not isinstance(bn, nn.BatchNorm2d):
                    continue
                s = bn.weight.double() / torch.sqrt(bn.running_var.double() + bn.eps)
                w = conv.weight.double() * s[:, None, None, None]
                b = (conv.bias.double() - bn.running_mean.double()) * s + bn.bias.double()
                conv.weight.copy_(w.to(conv.weight.dtype))
                conv.bias.copy_(b.to(conv.bias.dtype))
                setattr(rcu, bn_name, nn.Identity())
