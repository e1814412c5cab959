"""The benchmark's inputs repeat by seed, and every seed gives the same
work: the same image sizes and buckets, in another order."""

from __future__ import annotations

import numpy as np
import torch

from conftest import TINY, TINY_TEACHER
from perfbench import inputs

TRAFFIC = {"pool": 6, "longest_side": [100, 300],
           "aspects": ["1:1", "4:3", "3:4", "3:2", "2:3", "16:9"]}


def test_image_pool_repeats_by_seed():
    a = inputs.image_pool(TRAFFIC, 2**33 + 5, "cpu")
    b = inputs.image_pool(TRAFFIC, 2**33 + 5, "cpu")
    c = inputs.image_pool(TRAFFIC, 7, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(x.shape for x in a) == sorted(x.shape for x in c)
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, c))
    assert all(x.dtype == np.uint8 and x.shape[2] == 3 for x in a)


def test_image_sizes_cover_the_range():
    sizes = inputs.image_sizes({**TRAFFIC, "pool": 64, "longest_side": [800, 2048]})
    longest = [max(s) for s in sizes]
    assert 800 <= min(longest) and max(longest) <= 2048
    assert len(set(sizes)) == 64


def test_requests_are_seeded_passes_over_the_pool():
    import itertools
    o = list(itertools.islice(inputs.passes(5, 11), 12))
    assert sorted(o[:5]) == list(range(5)) and sorted(o[5:10]) == list(range(5))
    assert o == list(itertools.islice(inputs.passes(5, 11), 12))


def test_weights_repeat_by_seed():
    a = inputs.state_dict(TINY, 3, "cpu")
    b = inputs.state_dict(TINY, 3, "cpu")
    c = inputs.state_dict(TINY, 4, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.layer.0.mlp.up_proj.weight"],
                           c["encoder.layer.0.mlp.up_proj.weight"])


def test_training_inputs_repeat_by_seed():
    tr = {"pool": 2, "batch": 2, "size": 64}
    a, b = inputs.train_batches(tr, 9, "cpu"), inputs.train_batches(tr, 9, "cpu")
    assert all(torch.equal(x["images"], y["images"]) for x, y in zip(a, b))
    rows = torch.cat([x["images"] for x in a]).flatten(1)
    assert len({tuple(r[:16].tolist()) for r in rows}) == 4  # every row differs
    t = {"buckets": [[64, 64], [48, 80]]}
    s1 = inputs.teacher_samples(t, TINY_TEACHER, 9, "cpu")
    s2 = inputs.teacher_samples(t, TINY_TEACHER, 9, "cpu")
    s3 = inputs.teacher_samples(t, TINY_TEACHER, 10, "cpu")
    assert all(torch.equal(x["transformer_features"][0], y["transformer_features"][0])
               for x, y in zip(s1, s2))
    assert sorted(x["images"].shape[1:3] for x in s1) == sorted(x["images"].shape[1:3] for x in s3)
    assert s1[0]["transformer_features"][0].shape[1] == (s1[0]["images"].shape[1] // 16) * (s1[0]["images"].shape[2] // 16)
