"""What the two serving drivers share: the predictor built from the seed,
the seeded sample of the window's answers, the comparison of that sample
with the plain reference, and the device block of the result line."""

from __future__ import annotations

import gc
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import checks, inputs, program
from perfbench.reference import model as ref_model
from perfbench.reference import serve as ref_serve


def build(spec: dict, seed: int, device):
    """(predictor, image pool) of a serving cell."""
    cfg, tr = spec["config"], spec["workload"]["traffic"]
    sd = inputs.state_dict(cfg, seed, device)
    model = program.build_model(cfg, sd, device)
    del sd
    pred = program.predictor(model, tr["canvas"], cfg["dtype"])
    return pred, inputs.image_pool(tr, seed, device)


class Sample:
    """A seeded uniform sample of k answers from a stream of unknown
    length (reservoir sampling), plus the first answer to the pool's
    largest image."""

    def __init__(self, k: int, seed: int, largest: int):
        self.k, self.largest = k, largest
        self.rng = np.random.default_rng(inputs.mix(seed, 8))
        self.items: List[Tuple[int, object]] = []
        self.big = None
        self.seen = 0

    def offer(self, pool_idx: int, result) -> None:
        if pool_idx == self.largest and self.big is None:
            self.big = (pool_idx, result)
            return
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((pool_idx, result))
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = (pool_idx, result)

    def all(self) -> List[Tuple[int, object]]:
        return self.items + ([self.big] if self.big is not None else [])


def device_block(device) -> Dict:
    """The result line's `device`: one card, its peak allocation so far."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def release() -> None:
    """Return the memory of the program's dropped state to the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def compare(spec: dict, seed: int, device, pool, sample: Sample,
            nm: ref_model.Numerics = ref_model.PLAIN) -> Tuple[Dict[str, float], int]:
    """The sample's numbers against the reference (weights made again
    from the seed), and how many answers were compared."""
    cfg, w = spec["config"], spec["workload"]
    tr = w["traffic"]
    sd = inputs.state_dict(cfg, seed, device)
    rows = []
    with ref_model.exact_float32():
        for idx, result in sample.all():
            ref = ref_serve.request(pool[idx], sd, cfg, tr["canvas"], device, nm,
                                    w["check"].get("chunk_elems", 1 << 28))
            rows.append(checks.serving_numbers(result, pool[idx], ref,
                                               tr["payload"]))
            del ref
    del sd
    return checks.serving_summary(rows), len(rows)
