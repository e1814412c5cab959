"""On the card: data parallelism at world size 1, bf16, full width. The
ViT-B 1024^2 b4 train step plain, under DDP over a one-rank NCCL group
and under FSDP2 on a one-rank mesh, and plain again, against the first
plain run; the training CLI under `torch.distributed.run`; serving with
`data_parallel=`. (The MMDiT sharded in place is in
`test_torch_factory_cuda.py`, beside the model it shards.) The file
imports no JAX: run it on the card with

    python3 chip_smoke.py -k parallel
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _cuda import (REPO, cuda, fixture_batch, fixture_pair,  # noqa: F401
                   fixture_variants, k8_launches, launch_counts, only_run,
                   reset_counts, seeded_model, train_args, write_fixture_dataset)

pytestmark = pytest.mark.cuda

# ||P - P_plain|| / ||P_plain|| over every parameter as one vector after two
# SGD steps from the same weights and batch, and the loss's relative
# difference. The steps run with torch's deterministic algorithms: without
# them two plain runs differ by 1.0e-2 on a zero-init bias (its gradient's
# rounding; measured on one H100). With them a second plain run is
# bit-equal, and so must DDP over one rank be; FSDP2 rounds otherwise
# (1.05e-2 on a zero-init bias, as much as a planted x 1.01 on one
# parameter, so no per-parameter bound holds it): 1.5x measured, 8.534e-08
# and 2.262e-06 in two runs. SGD, not AdamW: AdamW's first steps move every
# weight by ~lr whatever its gradient.
PAR_TOL = {"ddp": {"params": 0.0, "loss": 0.0},
           "plain2": {"params": 0.0, "loss": 0.0},
           "fsdp": {"params": 1.28e-7, "loss": 3.39e-6}}
PAR_LR = 1e-2


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms (cuDNN's included) while the body
    runs."""
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev[:2]
        torch.use_deterministic_algorithms(prev[2], warn_only=prev[3])


class ParSGD:
    """p -= lr * g over `params` (DTensors too), the optimizer interface
    `train_step` calls."""

    def __init__(self, params, lr):
        self.params, self.lr = list(params), lr

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self, step):
        with torch.no_grad():
            for p in self.params:
                if p.grad is not None:
                    p -= self.lr * p.grad


def par_error(params, ref) -> float:
    """||params - ref|| / ||ref|| over all parameters as one vector (both
    {name: fp32 tensor})."""
    num = sum(float((params[n] - p).double().pow(2).sum()) for n, p in ref.items())
    den = sum(float(p.double().pow(2).sum()) for p in ref.values())
    return (num / den) ** 0.5


def par_step_run(kind, batch):
    """Two ViT-B 1024^2 b4 bf16 steps from seed-2 weights (deterministic
    algorithms): the plain step, DDP over a one-rank NCCL group, or FSDP2
    through `shard_module` on a one-rank ("data", "fsdp") mesh. Returns
    the losses, the launches and the parameters after the steps."""
    from s3od_torch.parallel import distributed as pd
    from s3od_torch.parallel.mesh import full_tensor, make_mesh, shard_module, unwrap
    from s3od_torch.training.loss import LOSS_PRESETS, LossModule
    from s3od_torch.training.train_step import train_step

    model = seeded_model(2)
    if kind != "plain":
        pd.ensure_group("cuda")
        model = shard_module(model, make_mesh(fsdp=1, device_type="cuda"), wrap=kind)
    opt = ParSGD(unwrap(model).parameters(), PAR_LR)
    loss_module = LossModule(LOSS_PRESETS["focal_iou"])
    reset_counts()
    with deterministic():
        losses = [float(train_step(model, opt, loss_module, batch, 0, i,
                                   generator=torch.Generator().manual_seed(i),
                                   compute_dtype=torch.bfloat16)["loss"])
                  for i in range(2)]
    counts = dict(launch_counts(), K8=k8_launches())
    params = {n: full_tensor(p).detach().float().clone()
              for n, p in unwrap(model).named_parameters()}
    del model, opt
    pd.destroy()
    torch.cuda.empty_cache()
    return losses, counts, params


def test_data_parallel_train_step_on_cuda(cuda):
    """The ViT-B 1024^2 b4 train step in turns: plain, DDP over a one-rank
    NCCL group, FSDP2 through `shard_module` on a one-rank mesh, plain
    again, two steps each from the same seeded weights and batch: K1-K5
    and K8 launches equal to the plain step's, the loss and every
    parameter against the first plain run within PAR_TOL, where a planted
    parameter x 1.01 fails."""
    batch = fixture_batch(4, 1024)
    runs = {kind: par_step_run("plain" if kind == "plain2" else kind, batch)
            for kind in ("plain", "ddp", "fsdp", "plain2")}
    ref_losses, ref_counts, ref_params = runs.pop("plain")
    for kind, (losses, counts, params) in runs.items():
        tol = PAR_TOL[kind]
        assert counts == ref_counts, kind
        assert par_error(params, ref_params) <= tol["params"], kind
        assert max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)) <= tol["loss"]
        key = "encoder.layer.0.attention.qkv.weight"
        params[key] = params[key] * 1.01
        assert par_error(params, ref_params) > tol["params"], kind


def test_torchrun_cli_on_cuda(cuda, tmp_path):
    """The training CLI under `torch.distributed.run --standalone
    --nproc_per_node=1` on the fixture dataset (ViT-B 1024^2 b4, one
    epoch) joins the process group from the launcher's environment and
    writes the checkpoint and export keys of the same run in-process."""
    from s3od_torch.training.train import train

    write_fixture_dataset(tmp_path, n=10)
    extra = ("backend.max_epochs=1", "dataset.val_batch_size=2")
    train(train_args(tmp_path, "plain", *extra))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=1", "-m", "s3od_torch.training.train",
         *train_args(tmp_path, "torchrun", *extra)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=600)
    text = proc.stdout + proc.stderr
    assert proc.returncode == 0, text[-4000:]
    assert ("joined the process group from the launcher's environment: rank 0 "
            "of 1 (nccl)") in text
    a, b = (torch.load(only_run(tmp_path / run) / "last" / "state.pt",
                       map_location="cpu", weights_only=False)
            for run in ("plain", "torchrun"))
    assert list(a["model"]) == list(b["model"])
    assert list(a["optimizer"]["state"]) == list(b["optimizer"]["state"])
    assert all(sorted(a["optimizer"]["state"][i]) == sorted(b["optimizer"]["state"][i])
               for i in a["optimizer"]["state"])
    with np.load(only_run(tmp_path / "plain") / "s3od_final.npz") as za, \
            np.load(only_run(tmp_path / "torchrun") / "s3od_final.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)


def test_data_parallel_serving_on_cuda(cuda):
    """`BackgroundRemoval(data_parallel=True)` at 1024^2 b16 answers as
    `data_parallel=False`; two replicas on the one card
    (`data_parallel=["cuda:0", "cuda:0"]`) split the chunk of 16 into 8 +
    8 and answer as one replica at chunk 8."""
    from s3od_torch import BackgroundRemoval

    imgs = fixture_variants(fixture_pair()[0])
    outs, parts = {}, {}
    for name, dp, chunk in (("plain", False, None), ("true", True, None),
                            ("plain8", False, 8), ("two", ["cuda:0", "cuda:0"], None)):
        pred = BackgroundRemoval.from_model(seeded_model(6), image_size=1024,
                                            device="cuda", data_parallel=dp)
        seen = []
        for i, (model, _, _) in enumerate(pred._replicas):
            model.register_forward_pre_hook(
                lambda m, a, i=i: seen.append((i, int(a[0].shape[0]))))
        outs[name] = pred.remove_background_batch(imgs, chunk=chunk, payload="best")
        parts[name] = seen
        del pred

    def same(a, b):
        return len(outs[a]) == len(outs[b]) == 16 and all(
            np.array_equal(x.predicted_mask, y.predicted_mask)
            and np.array_equal(x.all_ious, y.all_ious)
            for x, y in zip(outs[a], outs[b]))

    assert same("plain", "true")
    assert parts["two"] == [(0, 8), (1, 8)] and same("plain8", "two")
