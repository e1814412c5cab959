"""Process groups and the hybrid mesh (counterpart of
`s3od_tpu/parallel/distributed.py`).

The JAX package runs one process per host, each driving its chips under
`jit`. The port runs one process per device, in PyTorch's idiom:

- `init_distributed()` joins a `torch.distributed` group from the
  launcher's environment: `torchrun`'s (RANK, WORLD_SIZE, LOCAL_RANK,
  MASTER_ADDR, MASTER_PORT) first, then SLURM's (SLURM_PROCID,
  SLURM_NTASKS, SLURM_LOCALID, with MASTER_ADDR / MASTER_PORT set by the
  job script), as `s3od_tpu/parallel/distributed.py:42-89` reads JAX_* then
  SLURM_*. NCCL on the card, gloo on the CPU. Without a launcher it is a
  no-op that returns False. A failed init raises: nothing falls back to
  one process or to the CPU.
- `make_hybrid_mesh(dcn, dp, fsdp)` is a `DeviceMesh` with axes
  ("dcn", "data", "fsdp"); `dcn` defaults to the number of hosts.
- The batch is sharded over every axis (`data_axes`), so the data-parallel
  group of the BatchNorm statistics is the whole world (the trainer
  passes it to the forward).
- `spawn_local(n, fn, *args)` starts n local workers in one group (a
  file rendezvous), so that `backend.devices=N` runs without a launcher.
"""

from __future__ import annotations

import logging
import os
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

AXES = ("dcn", "data", "fsdp")
logger = logging.getLogger("s3od_torch.parallel")


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        raw = os.environ.get(name)
        if raw not in (None, ""):
            return int(raw)
    return None


def launcher_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world size, local rank) from torchrun's environment, else
    SLURM's; None without a launcher."""
    if os.environ.get("RANK") is not None and os.environ.get("WORLD_SIZE"):
        return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                _env_int("LOCAL_RANK") or 0)
    if os.environ.get("SLURM_NTASKS") and os.environ.get("SLURM_PROCID"):
        return (int(os.environ["SLURM_PROCID"]),
                int(os.environ["SLURM_NTASKS"]),
                _env_int("SLURM_LOCALID") or 0)
    return None


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _device_type(device_type: Optional[str]) -> str:
    return device_type or ("cuda" if torch.cuda.is_available() else "cpu")


def _init(device_type: str, rank: int, world: int, local_rank: int,
          init_method: str) -> None:
    if device_type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"local rank {local_rank} has no CUDA device: "
                f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local_rank)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world,
                                device_id=torch.device("cuda", local_rank))
    else:
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)


def init_distributed(device_type: Optional[str] = None) -> bool:
    """Join the launcher's process group (NCCL for `device_type` "cuda",
    gloo for "cpu"; by default the card when one is present). Returns True
    when this process is in a group (already, or joined now), False
    without a launcher. Safe to call twice."""
    if dist.is_initialized():
        return True
    env = launcher_env()
    if env is None:
        return False
    rank, world, local_rank = env
    addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
    if not (addr and port):
        raise RuntimeError(
            "a launcher set the rank and world size but not MASTER_ADDR / "
            "MASTER_PORT")
    _init(_device_type(device_type), rank, world, local_rank,
          f"tcp://{addr}:{port}")
    logger.info("joined the process group from the launcher's environment: "
                "rank %d of %d (%s)", rank, world, dist.get_backend())
    return True


def ensure_group(device_type: Optional[str] = None) -> None:
    """The launcher's group, else a one-process group of this process (a
    mesh needs a group even at world size 1)."""
    if not init_distributed(device_type):
        local = torch.cuda.current_device() if (
            _device_type(device_type) == "cuda") else 0
        _init(_device_type(device_type), 0, 1, local,
              f"tcp://127.0.0.1:{free_port()}")


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def broadcast_object(obj):
    """Rank 0's value of a picklable object on every rank (the value
    itself at world size 1): decisions that must agree across ranks, such
    as which outputs already exist."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def expected_world_size() -> int:
    """The world size of the group this process is in, or would join
    (the launcher's; 1 without one)."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = launcher_env()
    return env[1] if env is not None else 1


def _mesh(device_type: Optional[str], shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    ensure_group(device_type)
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_hybrid_mesh(dcn: Optional[int] = None, dp: Optional[int] = None,
                     fsdp: int = 1, device_type: Optional[str] = None):
    """("dcn", "data", "fsdp") `DeviceMesh` over the world. `dcn` defaults
    to the number of hosts (world / LOCAL_WORLD_SIZE), `dp` to what is
    left; the JAX asserts hold."""
    ensure_group(device_type)
    n = world_size()
    if dcn is None:
        local = _env_int("LOCAL_WORLD_SIZE") or n
        dcn = max(1, n // local)
    assert n % dcn == 0, f"{n} devices not divisible by dcn={dcn}"
    per = n // dcn
    if dp is None:
        assert per % fsdp == 0, f"{per} per-dcn devices not divisible by fsdp={fsdp}"
        dp = per // fsdp
    assert dcn * dp * fsdp == n, f"dcn*dp*fsdp={dcn * dp * fsdp} != {n}"
    return _mesh(device_type, (dcn, dp, fsdp), AXES)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch dim is sharded over (all of them)."""
    return tuple(a for a in mesh.mesh_dim_names if a in AXES)


def _spawned(fn, rank: int, world: int, store: str, device_type: str, args,
             queue, threads: Optional[int]) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    try:
        _init(device_type, rank, world, rank, f"file://{store}")
        out = fn(*args)
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        destroy()
    queue.put((rank, True, out))


def spawn_local(n: int, fn: Callable, *args,
                device_type: Optional[str] = None,
                threads: Optional[int] = None,
                timeout: float = 3600.0) -> Dict[int, Any]:
    """Run fn(*args) in n spawned local workers, rank r of n each, in a
    group joined through a file in a fresh temporary directory (no port
    to collide on), with the launcher's RANK / WORLD_SIZE / LOCAL_RANK set;
    return {rank: fn's result}. `threads`: torch's threads a worker. A
    failing worker stops all of them and raises with its traceback."""
    import multiprocessing as mp

    device_type = _device_type(device_type)
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    tmp = tempfile.mkdtemp(prefix="s3od-group-")
    procs = [ctx.Process(target=_spawned,
                         args=(fn, r, n, os.path.join(tmp, "store"),
                               device_type, args, queue, threads))
             for r in range(n)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    error = None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < n and error is None:
            if not queue.empty():
                r, ok, out = queue.get()
                if ok:
                    results[r] = out
                else:
                    error = f"worker {r} of {n} failed:\n{out}"
            elif any(p.exitcode not in (None, 0) for p in procs):
                time.sleep(0.5)  # a failing worker's report may follow
                if queue.empty():
                    error = (f"a worker of {n} died without a report (exit "
                             f"codes {[p.exitcode for p in procs]})")
            elif time.monotonic() > deadline:
                error = f"{n} workers still running after {timeout} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if error is not None:
                p.terminate()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(error)
    return results


__all__ = [
    "init_distributed", "ensure_group", "destroy", "make_hybrid_mesh",
    "data_axes",
    "spawn_local", "launcher_env", "rank", "world_size", "free_port",
    "broadcast_object", "expected_world_size",
]
