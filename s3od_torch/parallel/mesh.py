"""Device mesh and the sharding of a module (counterpart of
`s3od_tpu/parallel/mesh.py`).

The JAX package shards under `jit`: the batch over every mesh axis, each
kernel of 2 or more dimensions along its largest divisible axis over
"fsdp", replicated over "data" (`mesh.py:43-82`). The port is one process
per device and shards a module with PyTorch's wrappers:

- `shard_module(model, mesh)` applies FSDP2's `fully_shard` to each
  encoder block, each MMDiT dual and single block, and then the root.
  Parameters are sharded along dim 0 over "fsdp" and replicated over the
  other axes (FSDP2's HSDP on a 2-D mesh). With an "fsdp" axis of size 1
  it wraps the module in DDP instead (`wrap="auto"`), leaving out the
  parameters the forward never reads (the model's
  `unused_parameter_names`), which DDP would otherwise wait for.
- The kernels read a block's weights by address (K1-K5) inside that
  block's forward, where FSDP2 has gathered them; a pre-forward hook
  asserts that each gathered weight is 16-byte aligned, as the kernels'
  loads and TMA descriptors need.
- The batch: rank r of W takes rows r::W of every global batch
  (`batch_sharding` names them, `shard_batch` takes them: the loader's
  `process_shard` and the augmentation's draws slice through it). The
  micro-batch j of every rank is then a slice of the global micro-batch
  j, and BatchNorm takes its statistics over the global micro-batch when
  the trainer gives it the group (`models/dpt.batch_norm`).
"""

from __future__ import annotations

import contextlib
from typing import Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from s3od_torch.parallel.distributed import (
    _mesh,
    data_axes,
    ensure_group,
    world_size,
)

ALIGN = 16


def make_mesh(dp: Optional[int] = None, fsdp: int = 1,
              device_type: Optional[str] = None):
    """("data", "fsdp") `DeviceMesh` over the world; `dp` defaults to
    world // fsdp, and dp * fsdp must be the world size."""
    ensure_group(device_type)
    n = world_size()
    if dp is None:
        assert n % fsdp == 0, f"{n} devices not divisible by fsdp={fsdp}"
        dp = n // fsdp
    assert dp * fsdp == n, f"dp*fsdp={dp * fsdp} != {n} devices"
    return _mesh(device_type, (dp, fsdp), ("data", "fsdp"))


def fsdp_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index("fsdp")) if "fsdp" in names else 1


def _fsdp_mesh(mesh):
    """The 2-D (replicate, shard) mesh FSDP2 takes: the axes before
    "fsdp" flattened (the same ranks in the same row-major order)."""
    if mesh.ndim == 2:
        return mesh
    n = fsdp_size(mesh)
    return _mesh(mesh.device_type, (mesh.size() // n, n),
                 ("replicate", "fsdp"))


def shard_units(model: nn.Module) -> List[nn.Module]:
    """The blocks that become FSDP2 units of their own: the encoder's
    blocks and the MMDiT's dual and single blocks."""
    units: List[nn.Module] = []
    encoder = getattr(model, "encoder", None)
    if encoder is not None and hasattr(encoder, "layer"):
        units += list(encoder.layer)
    for name in ("dual_blocks", "single_blocks"):
        units += list(getattr(model, name, ()))
    return units


def _check_alignment(module, args, kwargs=None):
    for p in module.parameters(recurse=True):
        if p.data_ptr() % ALIGN:
            raise RuntimeError(
                f"a gathered weight of {type(module).__name__} is at "
                f"{p.data_ptr():#x}, not {ALIGN}-byte aligned")


def shard_module(model: nn.Module, mesh, *, wrap: str = "auto") -> nn.Module:
    """Shard `model` over `mesh` in place and return the module to call:
    FSDP2 units on `shard_units` and the root (`wrap="fsdp"`, or "auto"
    with an "fsdp" axis above 1), else DDP (`wrap="ddp"`, or "auto" with
    "fsdp" of size 1). The model must be on this rank's device. Each
    unit frees its gathered weights after its forward and gathers them
    again for the backward (and a remat recompute)."""
    from torch.distributed.device_mesh import DeviceMesh

    if wrap not in ("auto", "fsdp", "ddp"):
        raise ValueError(f"wrap must be auto, fsdp or ddp, got {wrap!r}")
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh, got {type(mesh).__name__}")
    if wrap == "ddp" or (wrap == "auto" and fsdp_size(mesh) == 1):
        from torch.nn.parallel import DistributedDataParallel as DDP

        DDP._set_params_and_buffers_to_ignore_for_model(
            model, getattr(model, "unused_parameter_names", list)())
        # No device_ids: the inputs are on the device already, and a CPU
        # tensor among them (the RoPE scale of a CPU generator) stays put.
        return DDP(model, broadcast_buffers=False)
    from torch.distributed.fsdp import fully_shard

    fmesh = _fsdp_mesh(mesh)
    for unit in shard_units(model):
        fully_shard(unit, mesh=fmesh)
        unit.register_forward_pre_hook(_check_alignment)
    fully_shard(model, mesh=fmesh)
    return model


def unwrap(model: nn.Module) -> nn.Module:
    """The module under a DDP wrapper (FSDP2 shards in place)."""
    return getattr(model, "module", model)


@contextlib.contextmanager
def grad_sync(model: nn.Module, enabled: bool):
    """Reduce gradients in this backward (`enabled`) or keep them local
    to accumulate: DDP's `no_sync()`, FSDP2's
    `set_requires_gradient_sync`; nothing for an unwrapped module."""
    if enabled:
        yield
    elif hasattr(model, "no_sync"):
        with model.no_sync():
            yield
    elif hasattr(model, "set_requires_gradient_sync"):
        model.set_requires_gradient_sync(False)
        try:
            yield
        finally:
            model.set_requires_gradient_sync(True)
    else:
        yield


def batch_sharding(mesh) -> Tuple[int, int]:
    """(this rank's index, count) along the flattened data axes (all of
    them): the `shard` that `shard_batch` takes."""
    index, count = 0, 1
    names = mesh.mesh_dim_names
    for name, c in zip(names, mesh.get_coordinate()):
        if name in data_axes(mesh):
            size = mesh.size(names.index(name))
            index, count = index * size + c, count * size
    return index, count


def shard_batch(batch, shard: Optional[Tuple[int, int]]):
    """Rows index::count of a global batch, for `shard` = (index, count)
    (`batch_sharding`'s; None: the batch whole). `batch` is a dict of
    arrays or tensors, or one array, tensor or list. The one rule of
    which rows a rank takes: the loader's `process_shard`, the host
    geometry and the augmentation's draws all slice through it. The JAX
    mesh places contiguous blocks on its devices; the interleave keeps
    each rank's micro-batch j inside the global micro-batch j."""
    if shard is None:
        return batch
    r, w = shard
    if isinstance(batch, dict):
        return {k: v[r::w] for k, v in batch.items()}
    return batch[r::w]


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_rows(t):
    """(local tensor, row offset in the full tensor) of a parameter or
    gradient: the whole tensor and 0 unless it is a DTensor sharded along
    dim 0 (torch.chunk's split, as FSDP2 shards)."""
    if not is_dtensor(t):
        return t, 0
    from torch.distributed.tensor import Shard

    local = t.to_local()
    offset = 0
    for dim, placement in enumerate(t.placements):
        if isinstance(placement, Shard):
            assert placement.dim == 0, placement
            n = t.device_mesh.size(dim)
            chunk = -(-t.shape[0] // n)
            offset += chunk * t.device_mesh.get_local_rank(dim)
    return local, offset


def shard_groups(t) -> List:
    """The process groups of the mesh dims a DTensor is sharded over."""
    if not is_dtensor(t):
        return []
    from torch.distributed.tensor import Shard

    return [t.device_mesh.get_group(dim)
            for dim, p in enumerate(t.placements) if isinstance(p, Shard)]


def full_tensor(t):
    """A DTensor gathered whole (a collective: every rank calls it in the
    same order); any other tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def full_state_dict(model: nn.Module):
    """The unprefixed state dict with every sharded entry gathered whole:
    what world size 1 would save. Collective under FSDP2."""
    return {k: full_tensor(v) for k, v in unwrap(model).state_dict().items()}


def full_tree(tree):
    """`full_tensor` over a nested dict / list (an optimizer state)."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tree(v) for v in tree)
    return full_tensor(tree)


def distribute_like(full: torch.Tensor, like):
    """`full` sharded as the DTensor `like` is, from this rank's own copy
    (no communication); `full` itself unless `like` is a DTensor."""
    if not is_dtensor(like):
        return full
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(full.to(like.device_mesh.device_type),
                             like.device_mesh, like.placements,
                             src_data_rank=None)


def all_reduce_sums(values: dict, mean_keys: Iterable[str] = (),
                    device=None) -> dict:
    """{name: 0-dim tensor or float} -> {name: float} summed over the
    world in one float64 collective (on `device`, the group's); the
    `mean_keys` divided by the world size. At world size 1 the values as
    they are, read as floats."""
    if world_size() == 1 or not values:
        return {k: float(v) for k, v in values.items()}
    keys = list(values)
    stacked = torch.stack([torch.as_tensor(values[k], dtype=torch.float64,
                                           device=device) for k in keys])
    dist.all_reduce(stacked)
    w = world_size()
    means = set(mean_keys)
    return {k: float(stacked[i]) / (w if k in means else 1)
            for i, k in enumerate(keys)}
