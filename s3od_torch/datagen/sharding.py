"""Batch-job sharding + filesystem resume for the data factory.

The reference shards all three factory pipelines with SLURM array jobs
(static index ranges from SLURM_ARRAY_TASK_ID; `generate_train_images.py:
67-82`, `feature_extraction.py:186-208`, `run_filtering.py:20-41`) and uses
"skip existing output files" as the resume/dedup mechanism.

TPU-native equivalent: the same embarrassing parallelism, parameterized by
(task_id, num_tasks) from flags or any of the common env schemes (SLURM
arrays, JAX multi-process, plain env vars) — no inter-task communication,
restartable at file granularity.

The port's own copy of `s3od_tpu/datagen/sharding.py` (which imports no
jax): the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, TypeVar

T = TypeVar("T")


def detect_task(
    task_id: Optional[int] = None, num_tasks: Optional[int] = None
) -> Tuple[int, int]:
    """Resolve (task_id, num_tasks) from args or environment."""
    if task_id is not None and num_tasks is not None:
        return task_id, num_tasks
    for id_var, n_var in (
        ("S3OD_TASK_ID", "S3OD_NUM_TASKS"),
        ("SLURM_ARRAY_TASK_ID", "SLURM_ARRAY_TASK_COUNT"),
        ("JAX_PROCESS_INDEX", "JAX_PROCESS_COUNT"),
    ):
        if id_var in os.environ:
            return int(os.environ[id_var]), int(os.environ.get(n_var, 1))
    return 0, 1


def task_slice(items: Sequence[T], task_id: int, num_tasks: int) -> Sequence[T]:
    """Contiguous static split (reference semantics): task i gets
    items[i*chunk : (i+1)*chunk] with the last task absorbing the remainder."""
    if num_tasks <= 1:
        return items
    chunk = len(items) // num_tasks
    start = task_id * chunk
    end = len(items) if task_id == num_tasks - 1 else start + chunk
    return items[start:end]


def filter_unprocessed(items: Sequence[T], done_fn) -> Sequence[T]:
    """Resume mechanism: drop items whose outputs already exist."""
    return [x for x in items if not done_fn(x)]
