"""Training entry point on PyTorch (counterpart of
`s3od_tpu/training/train.py:155-611`).

    python -m s3od_torch.training.train model=dinob dataset=synth \\
        backend=1chip data_dir=/data
    python -m s3od_torch.training.train ... backend=8gpu   # 8 local cards
    torchrun --nproc_per_node=8 -m s3od_torch.training.train ... backend=8gpu
    python -m s3od_torch.training.train config_name=train_teacher \
        flux_features_dir=/data/flux_features data_dir=/data

The same config groups and overrides as the JAX package
(`training/config/`). The loop: per epoch, the training steps
(`train_step`, uploads overlapped by `device_prefetch`, results summed on
the device and read once), the validation pass, the scalars (TensorBoard
when it is installed), top-k and `last` checkpoints by val dice, early
stopping on val_iou_loss_full; after the fit, the optional evaluation of
the test datasets and the export of `s3od_final.npz`.

With `dataset.transform_mode` regular or synthetic the loader draws
RandomResizedCrop (p 0.5) and the rotation / distortions on the host and
the device applies them, then the batched photometric pipeline runs
(`s3od_torch/ops/augment.py`), all inside the upload worker, so it
overlaps the previous step (JAX's `train_pre` + prefetch worker,
`s3od_tpu/training/train.py:316-326, 441-460`).

Data parallelism: one process per device (`s3od_torch.parallel`). Under
a launcher (`torchrun`, SLURM) each process joins the group; without one,
`backend.devices = N > 1` spawns N local workers, which then join the same
way. The global batch is `train_batch_size x world x accumulation` (JAX
`train.py:238`); rank r loads rows r::world of each global batch
(`PrefetchLoader(process_shard=)`), and its augmentation draws are the
global batch's rows (`augment_batch(shard=)`), so a run does not depend on
the world size but for the order of reductions. `backend.fsdp = 1` wraps
the model in DDP, above 1 in FSDP2 over a ("dcn", "data", "fsdp") mesh
(`make_hybrid_mesh`: replicated over the hosts and "data"); the
BatchNorms take the global micro-batch's statistics (`models/dpt.py`).
Rank 0 alone logs, writes the checkpoints (the whole, unprefixed state
dict) and the export; the epoch's sums are reduced over the ranks first.

Teacher training (`config_name=train_teacher`, any model whose
`use_flux_features` is set; JAX `train.py:217-347`): the FluxDPT teacher
(`build_teacher_model`) on `FluxFeatureDataset`, the images at their FLUX
bucket with the features `datagen/feature_extraction.py` wrote
(`flux_features_dir`, required). Global batch 1 and no accumulation (the
buckets differ in shape), normalization only (no augmentation), validation
at batch 1, no image logging and no evaluation hook; `backend.devices > 1`
warns and trains on one device, as the JAX trainer does.

The run is on the CUDA card unless `backend.accelerator` is `cpu`; it
never falls back: `backend.devices` above the visible cards, an `fsdp`
that does not divide the world size, or a failed NCCL init raise.
"""

from __future__ import annotations

import logging
import sys
import time
import types
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger("s3od_torch.train")


def micro_dice_iou(sums: Dict[str, float]) -> Dict[str, float]:
    tp, fp, fn = sums.get("tp", 0.0), sums.get("fp", 0.0), sums.get("fn", 0.0)
    iou = tp / max(tp + fp + fn, 1.0)
    dice = 2 * tp / max(2 * tp + fp + fn, 1.0)
    return {"iou": iou, "dice": dice}


def get_experiment_name(cfg) -> str:
    """Reference naming: model_dataset_loss_timestamp (`train.py:58-69`)."""
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    return (
        f"{cfg.experiment_name}_{cfg.model.get('_name', 'model')}"
        f"_{cfg.dataset.get('_name', 'data')}_{cfg.loss.get('_name', 'loss')}"
        f"_{stamp}"
    )


def on_cpu(cfg) -> bool:
    return str(cfg.backend.get("accelerator", "cuda")).lower() == "cpu"


def check_parallel(cfg, world: int) -> None:
    """The refusals: more devices than the visible cards, an fsdp that
    does not divide the world size."""
    devices, fsdp = int(cfg.backend.devices), int(cfg.backend.fsdp)
    if devices > 1 and not on_cpu(cfg) and devices > torch.cuda.device_count():
        raise RuntimeError(
            f"backend.devices={devices} but {torch.cuda.device_count()} CUDA "
            "device(s) are visible")
    if fsdp < 1 or world % fsdp:
        raise ValueError(
            f"backend.fsdp={fsdp} does not divide the world size {world}")


def device_of(cfg) -> torch.device:
    """`backend.accelerator: cpu` -> the CPU; anything else -> the CUDA
    card (this rank's), which must be present."""
    if on_cpu(cfg):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "training runs on the CUDA card unless backend.accelerator=cpu, "
            "and no CUDA device is present")
    return torch.device("cuda", torch.cuda.current_device())


def build_model(cfg, device: torch.device, seed: int):
    from s3od_torch.configs import segmentation_config
    from s3od_torch.convert import load_checkpoint, load_hf_encoder_
    from s3od_torch.models.segmentation import S3ODSegmentation, init_weights_

    mcfg = segmentation_config(
        cfg.model.encoder_name,
        num_outputs=cfg.model.num_outputs,
        features=cfg.model.features,
        use_bn=cfg.model.use_bn,
        use_clstoken=cfg.model.use_clstoken,
    )
    model = S3ODSegmentation(mcfg)
    if cfg.get("init_checkpoint"):
        sd, _ = load_checkpoint(str(cfg.init_checkpoint))
        model.load_state_dict(sd, strict=True)
        logger.info("initialized weights from %s", cfg.init_checkpoint)
    else:
        init_weights_(model, torch.Generator().manual_seed(seed))
        if cfg.get("pretrained_encoder"):
            # Pretrained DINOv3 encoder + fresh head: the reference's
            # default training init (`model_training/model.py:14,25`).
            load_hf_encoder_(model.encoder, str(cfg.pretrained_encoder))
            logger.info("encoder initialized from %s", cfg.pretrained_encoder)
        else:
            logger.warning(
                "no init_checkpoint/pretrained_encoder: fully random init "
                "(the reference pulls pretrained DINOv3 encoder weights)")
    return model.to(device)


def build_teacher_model(cfg, device: torch.device, seed: int):
    """The FluxDPT teacher (`config/train_teacher.yaml`; JAX
    `build_teacher_model`, `train.py:125-153`): seeded weights
    (`init_flux_teacher`), the encoder from `pretrained_encoder` when one
    is given."""
    from s3od_torch.configs import segmentation_config
    from s3od_torch.convert import load_hf_encoder_
    from s3od_torch.models.flux_teacher import (
        FluxTeacherConfig,
        init_flux_teacher,
    )

    base = segmentation_config(
        cfg.model.encoder_name,
        num_outputs=cfg.model.num_outputs,
        features=cfg.model.features,
        use_bn=cfg.model.use_bn,
        use_clstoken=cfg.model.use_clstoken,
    )
    tcfg = FluxTeacherConfig(
        base=base,
        flux_dim=int(cfg.model.get("flux_dim", 768)),
        use_concept_maps=bool(cfg.model.get("use_concept_maps", True)),
        use_flux_features=True,
    )
    model = init_flux_teacher(tcfg, torch.Generator().manual_seed(seed))
    if cfg.get("pretrained_encoder"):
        load_hf_encoder_(model.encoder, str(cfg.pretrained_encoder))
        logger.info("teacher encoder initialized from %s",
                    cfg.pretrained_encoder)
    return model.to(device)


def step_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The RoPE-scale stream of one step, a function of (seed, epoch,
    step): a resumed run draws what a continuous run would."""
    return torch.Generator().manual_seed(
        ((seed + 1) * 1_000_003 + epoch) * 1_000_003 + step)


def augment_generator(seed: int, epoch: int, step: int) -> torch.Generator:
    """The augmentation stream of one step, a function of (seed, epoch,
    step) apart from `step_generator`'s (JAX folds the epoch key with 1
    for it and 0 for the step keys, `train.py:431-437`), so a resumed
    run augments as a continuous run would."""
    return torch.Generator().manual_seed(
        ((seed + 2) * 1_000_003 + epoch) * 1_000_003 + step)


def upload(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """A loader batch onto the device: uint8 images, masks as uint8
    0..255 (4x fewer bytes than float; cached datasets already are),
    through pinned memory without waiting for the running step; a teacher
    batch's `transformer_features` and `concept_maps` as float32."""
    from s3od_torch.ops.warp import host_to

    masks = batch["masks"]
    if masks.dtype != np.uint8:
        masks = np.round(masks * 255.0).astype(np.uint8)
    put = lambda a: host_to(torch.from_numpy(np.ascontiguousarray(a)), device)
    out = {"images": put(batch["images"]), "masks": put(masks)}
    if "transformer_features" in batch:
        out["transformer_features"] = [
            put(f) for f in batch["transformer_features"]]
        out["concept_maps"] = {k: put(v)
                               for k, v in batch["concept_maps"].items()}
    return out


def train_pre(batch, geometry, mode: str, generator: torch.Generator,
              shard=None):
    """The training input pipeline on the batch's device (JAX `train_pre`
    with the loader's host warps, `train.py:316-326`): the geometry the
    loader drew, then the flips and the photometric stages
    (`augment_batch(..., device_geometric=False)`), then the ImageNet
    normalization. `shard` = (rank, world): the batch is those rows of
    the global one, and draws as it would."""
    from s3od_torch.ops.augment import augment_batch, normalize_imagenet
    from s3od_torch.ops.warp import apply_host_geometry

    images, masks = batch["images"], batch["masks"]
    if geometry is not None:
        images, masks = apply_host_geometry(images, masks, geometry)
    x, m = augment_batch(images, masks.float() / 255.0, mode, generator,
                         device_geometric=False, shard=shard)
    return {"images": normalize_imagenet(x), "masks": m}


@torch.no_grad()
def log_val_images(writer, model, batch, compute_dtype, device, epoch: int,
                   max_images: int) -> None:
    """Side-by-side panels of the first val batch (JAX `_log_val_images`,
    `train.py:614-650`; reference `lightning_module.py:269-283`). Every
    rank runs the forward (a sharded model gathers its weights); only a
    rank with a writer draws."""
    from s3od_torch.ops.augment import normalize_imagenet
    from s3od_torch.training.image_logger import ImageLogger

    images = torch.from_numpy(batch["images"][:max_images]).to(device)
    x = normalize_imagenet(images.float() / 255.0)
    out = model(x.to(compute_dtype), training=False)
    gt = np.asarray(batch["masks"][:max_images])
    if gt.dtype == np.uint8:  # cached loader ships masks uint8 0..255
        gt = gt.astype(np.float32) / 255.0
    if writer is None:
        return
    panels = ImageLogger(max_images)
    panels.maybe_add(x.cpu().numpy(),
                     torch.sigmoid(out["pred_masks"].float()).cpu().numpy(),
                     out["pred_iou"].float().cpu().numpy(), gt)
    panels.flush(writer, "val", epoch)


def train(argv: Optional[list] = None) -> Dict[str, float]:
    from s3od_torch.evaluation.compute_metrics import evaluate_datasets
    from s3od_torch.ops.precision import set_exact_float32
    from s3od_torch.parallel import distributed as pd
    from s3od_torch.parallel.mesh import (
        all_reduce_sums,
        batch_sharding,
        full_state_dict,
        full_tree,
        shard_module,
        unwrap,
    )
    from s3od_torch.training.checkpoint import (
        CheckpointManager,
        EarlyStopping,
        export_inference,
        key_bias_max,
        restore_external,
    )
    from s3od_torch.training.config import load_config
    from s3od_torch.training.data import (
        PrefetchLoader,
        build_dataset,
        device_prefetch,
    )
    from s3od_torch.training.loss import LossModule, compose_loss_config
    from s3od_torch.training.optim import Optimizer
    from s3od_torch.training.train_step import (
        eval_step,
        segmentation_forward,
        teacher_forward,
        train_step,
    )

    argv = list(argv if argv is not None else sys.argv[1:])
    args = list(argv)
    config_name = "train"
    for a in list(args):
        if a.startswith("config_name="):
            config_name = a.split("=", 1)[1]
            args.remove(a)
    cfg = load_config(args, config_name=config_name)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    is_teacher = bool(cfg.model.get("use_flux_features"))
    if is_teacher:
        # Bucket-shaped batch-1 samples shard over neither data nor
        # parameters (JAX `train.py:218-234`).
        if int(cfg.backend.devices) > 1:
            logger.warning(
                "teacher training runs data batch 1; extra devices idle")
        cfg["backend"]["devices"] = cfg["backend"]["fsdp"] = 1

    # --- process group ---------------------------------------------------
    device_type = "cpu" if on_cpu(cfg) else "cuda"
    devices = int(cfg.backend.devices)
    had_group = torch.distributed.is_initialized()
    if pd.launcher_env() is None and not had_group:
        check_parallel(cfg, devices)
        if devices > 1:
            # No launcher: N local workers, each joining as torchrun's would.
            threads = (max(1, torch.get_num_threads() // devices)
                       if device_type == "cpu" else None)
            return pd.spawn_local(devices, train, argv,
                                  device_type=device_type,
                                  threads=threads)[0]
    joined = pd.init_distributed(device_type)
    world, rank = pd.world_size(), pd.rank()
    check_parallel(cfg, world)
    if joined and devices not in (1, world):
        raise ValueError(f"backend.devices={devices} under a launcher of "
                         f"{world} processes")
    if is_teacher and world > 1:
        raise ValueError(f"teacher training runs on one process; the "
                         f"launcher started {world}")
    if rank:
        logger.setLevel(logging.WARNING)
    device = device_of(cfg)
    mesh, shard, bn_group = None, None, None
    if joined:
        # Replicated over the hosts ("dcn") and "data", sharded over
        # "fsdp"; the batch over every axis, so this rank's rows are
        # `batch_sharding`'s and the BatchNorms' group is the world.
        mesh = pd.make_hybrid_mesh(fsdp=int(cfg.backend.fsdp),
                                   device_type=device_type)
        shard = batch_sharding(mesh)
        if world > 1:
            bn_group = torch.distributed.group.WORLD

    seed = int(cfg.backend.seed)
    np.random.seed(seed)
    exp_name = get_experiment_name(cfg)
    if world > 1:  # one run directory: rank 0's name
        names = [exp_name]
        torch.distributed.broadcast_object_list(names, src=0)
        exp_name = names[0]
    save_dir = Path(cfg.base_dir) / "checkpoints" / exp_name
    log_dir = Path(cfg.base_dir) / "logs" / exp_name

    # --- data -----------------------------------------------------------
    data_dir = Path(cfg.data_dir)
    paths = [str(data_dir / p) for p in cfg.dataset.paths]
    image_size = int(cfg.dataset.image_size)
    accum = int(cfg.backend.accumulate_grad_batches)
    per_rank = int(cfg.dataset.train_batch_size) * accum
    flux_dir = (str(cfg.flux_features_dir) if cfg.get("flux_features_dir")
                else None)
    if is_teacher:
        # Bucket-shaped samples and their features: batch 1, no
        # accumulation (`model_training/dataset.py:352-360`).
        accum = per_rank = 1
        if not flux_dir:
            raise ValueError("teacher training requires flux_features_dir")
    global_batch = per_rank * world
    # dataset.cache=true: pre-decoded uint8 letterbox memmap cache (decode
    # once per dataset, not per epoch); not on the feature path.
    use_cache = bool(cfg.dataset.get("cache")) and not flux_dir
    train_ds = build_dataset(paths, image_size, "train",
                             float(cfg.dataset.val_split), seed,
                             cfg.get("debug_subset_fraction"),
                             flux_features_dir=flux_dir, cache=use_cache)
    val_ds = build_dataset(paths, image_size, "val",
                           float(cfg.dataset.val_split), seed,
                           flux_features_dir=flux_dir, cache=use_cache)
    threads = int(cfg.backend.num_threads)
    mode = cfg.dataset.transform_mode
    # Teacher data gets normalization only (`dataset.py:176-178`).
    augmenting = mode != "test" and not is_teacher
    train_loader = PrefetchLoader(
        train_ds, per_rank, shuffle=True, drop_last=True, seed=seed,
        num_threads=threads, random_resized_crop_p=0.5 if augmenting else 0.0,
        geometric_mode=mode if augmenting else None, process_shard=shard)
    val_batch = 1 if is_teacher else int(cfg.dataset.val_batch_size)
    val_loader = PrefetchLoader(val_ds, val_batch,
                                shuffle=False, drop_last=True, seed=seed,
                                num_threads=threads, process_shard=shard)
    steps_per_epoch = max(1, len(train_loader))
    logger.info("device=%s world=%d global_batch=%d steps/epoch=%d train=%d "
                "val=%d", device, world, global_batch, steps_per_epoch,
                len(train_ds), len(val_ds))

    # --- model / optimizer ---------------------------------------------
    compute_dtype = (torch.bfloat16 if cfg.backend.precision == "bf16"
                     else torch.float32)
    if compute_dtype == torch.float32:
        set_exact_float32()
    if is_teacher:
        model = build_teacher_model(cfg, device, seed)
        forward = teacher_forward
    else:
        model = build_model(cfg, device, seed)
        forward = segmentation_forward
    start_epoch, step, tree = 0, 0, None
    if cfg.get("checkpoint_path"):
        tree, start_epoch = restore_external(str(cfg.checkpoint_path),
                                             steps_per_epoch=steps_per_epoch)
        model.load_state_dict(tree["model"], strict=True)
    if joined:
        model = shard_module(model, mesh)
    core = unwrap(model)
    grad_clip = cfg.optimizer.get("grad_clip")
    optimizer = Optimizer(
        core, float(cfg.optimizer.lr),
        head_lr_mult=float(cfg.optimizer.head_lr_mult),
        weight_decay=float(cfg.optimizer.weight_decay),
        steps_per_epoch=steps_per_epoch,
        max_epochs=int(cfg.backend.max_epochs),
        hold_epochs=int(cfg.scheduler.hold_epochs),
        eta_min=float(cfg.scheduler.eta_min),
        grad_clip=float(grad_clip) if grad_clip is not None else None,
        warmup_epochs=float(cfg.scheduler.get("warmup_epochs", 0.0)),
    )
    if tree is not None:
        if cfg.get("weights_only"):
            # Weights only (reference `train.py:127-133`): fresh optimizer,
            # schedules and epoch counter.
            start_epoch = 0
        else:
            optimizer.load_state_dict(tree["optimizer"])
            step = int(tree["step"])
            if start_epoch:
                logger.info("resuming at epoch %d (step %d)", start_epoch, step)
        del tree
    loss_module = LossModule(compose_loss_config(cfg.loss))
    remat_policy = cfg.backend.get("remat_policy")

    # --- bookkeeping (rank 0 writes) -------------------------------------
    ckpt = None
    if rank == 0:
        ckpt = CheckpointManager(
            str(save_dir), top_k=int(cfg.train_stage.checkpoint_top_k),
            monitor=cfg.train_stage.checkpoint_monitor,
            mode=cfg.train_stage.checkpoint_mode)
    es_cfg = cfg.train_stage.early_stopping
    early = EarlyStopping(es_cfg.monitor, int(es_cfg.patience), es_cfg.mode,
                          float(es_cfg.min_delta))
    writer = None
    if rank == 0:
        try:
            # TensorBoard loads TensorFlow when it is installed (and
            # TensorFlow may load jax); its `notf` marker module selects the
            # TF-free stub, which is all the scalar writer needs.
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(str(log_dir))
        except Exception:  # pragma: no cover
            logger.warning(
                "tensorboard unavailable; scalar logging to stdout only")

    # backend.split_augment: the JAX package runs the augmentation as its
    # own jitted program, per accumulation micro-slice, instead of inside
    # the train step (`train.py:359-380`); only its draw stream differs.
    # Here augmentation always runs as its own calls before the step, in
    # the upload worker; the flag keeps JAX's per-micro-slice calls, which
    # bound the pipeline's temporaries by the micro-batch.
    split_aug = bool(cfg.backend.get("split_augment"))
    image_logging = (bool(cfg.train_stage.get("enable_image_logging"))
                     and not is_teacher)

    def put_fn(i, batch, epoch):
        dev_batch = upload(batch, device)
        if not augmenting:
            return dev_batch  # train_step decodes
        gen = augment_generator(seed, epoch, i)
        geometry = batch.get("geometry")
        n = dev_batch["images"].shape[0]
        micro = max(1, n // accum) if split_aug else n
        parts = [train_pre({k: v[j: j + micro] for k, v in dev_batch.items()},
                           geometry and geometry[j: j + micro], mode, gen,
                           shard)
                 for j in range(0, n, micro)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    max_epochs = int(cfg.backend.max_epochs)
    final_metrics: Dict[str, float] = {}
    prefetch_depth = max(1, int(cfg.backend.get("device_prefetch", 2)))
    confusion = ("tp", "fp", "fn")
    for epoch in range(start_epoch, max_epochs):
        t0 = time.time()
        acc: Dict[str, torch.Tensor] = {}
        n_steps = 0
        for i, batch in device_prefetch(
                train_loader.epoch(epoch),
                lambda i, b, epoch=epoch: put_fn(i, b, epoch),
                depth=prefetch_depth):
            out = train_step(model, optimizer, loss_module, batch, epoch,
                             step, generator=step_generator(seed, epoch, i),
                             accum_steps=accum, compute_dtype=compute_dtype,
                             remat_policy=remat_policy,
                             preprocessed=augmenting, bn_group=bn_group,
                             forward=forward)
            for k, v in out.items():
                acc[k] = acc[k] + v if k in acc else v
            step += 1
            n_steps += 1
        if n_steps == 0:
            raise RuntimeError(
                f"train loader yielded ZERO batches in epoch {epoch}: "
                f"{len(train_ds)} train samples < global batch "
                f"{global_batch} with drop_last — shrink "
                "dataset.train_batch_size / accumulation or add data")
        sums = all_reduce_sums(acc, [k for k in acc if k not in confusion],
                               device)
        metrics = {f"train_{k}": v / n_steps for k, v in sums.items()
                   if k not in confusion}
        metrics.update({f"train_{k}": v for k, v in micro_dice_iou(sums).items()})

        vsums: Dict[str, float] = {}
        n_val = 0
        for batch in val_loader.epoch(0):
            out = eval_step(model, loss_module, upload(batch, device), epoch,
                            compute_dtype=compute_dtype, forward=forward)
            for k, v in out.items():
                vsums[k] = vsums.get(k, 0.0) + float(v)
            if n_val == 0 and image_logging:
                log_val_images(writer, model, batch, compute_dtype, device,
                               epoch, int(cfg.train_stage.get("max_images", 8)))
            n_val += 1
        if n_val == 0 and epoch == start_epoch:
            logger.warning(
                "val loader yielded ZERO batches (%d val samples < "
                "val_batch_size %d with drop_last) — val metrics read 0/nan "
                "and checkpoint selection by val_dice is meaningless",
                len(val_ds), val_batch)
        vsums = all_reduce_sums(vsums, [k for k in vsums if k not in confusion],
                                device)
        metrics.update({f"val_{k}": v / max(n_val, 1) for k, v in vsums.items()
                        if k not in confusion})
        metrics.update({f"val_{k}": v for k, v in micro_dice_iou(vsums).items()})
        final_metrics = metrics

        if writer:
            for k, v in metrics.items():
                writer.add_scalar(k, v, epoch)
            lr_enc, lr_head = optimizer.lrs(step)
            writer.add_scalar("lr/encoder", lr_enc, epoch)
            writer.add_scalar("lr/head", lr_head, epoch)
        logger.info(
            "epoch %d (%.1fs): loss=%.4f val_loss=%.4f val_iou=%.4f "
            "val_dice=%.4f", epoch, time.time() - t0,
            metrics.get("train_loss", float("nan")),
            metrics.get("val_loss", float("nan")),
            metrics.get("val_iou", float("nan")),
            metrics.get("val_dice", float("nan")))

        save_every = max(1, int(cfg.backend.get("save_every", 1)))
        # What world size 1 saves: gathered whole under FSDP2 (a
        # collective on every rank), unprefixed under DDP.
        model_sd = full_state_dict(model) if joined else model.state_dict()
        optim_sd = (full_tree(optimizer.state_dict()) if joined
                    else optimizer.state_dict())
        if ckpt is not None:
            ckpt.save({"model": model_sd, "optimizer": optim_sd,
                       "step": step, "epoch": epoch},
                      epoch=epoch, metrics=metrics,
                      save_last=((epoch + 1) % save_every == 0
                                 or epoch + 1 == max_epochs))
        del model_sd, optim_sd
        if early.update(metrics):
            logger.info("early stopping at epoch %d", epoch)
            break

    model_sd = full_state_dict(model) if joined else model.state_dict()
    key_bias = key_bias_max(core)
    if (rank == 0 and not is_teacher
            and cfg.get("evaluation", {}).get("enabled")):
        from s3od_torch.convert import convert_state_dict

        results = evaluate_datasets(
            model_params=convert_state_dict(model_sd, core.cfg),
            input_dir=str(cfg.evaluation.input_dir),
            datasets=list(cfg.dataset.test_datasets),
            image_size=int(cfg.evaluation.get("image_size")
                           or cfg.dataset.get("eval_image_size", 1024)),
            device=device.type)
        for ds_name, ms in results.items():
            for k, v in ms.items():
                if writer:
                    writer.add_scalar(f"evaluation/{ds_name}/{k}", v)

    if writer:
        writer.close()
    if rank == 0:
        export_inference(core, str(save_dir / "s3od_final.npz"), model_sd,
                         key_bias)
    if joined and not had_group:
        pd.destroy()
    return final_metrics


if __name__ == "__main__":
    train()
