"""The port's ``runtime/dataloader.py`` against the JAX package's: the same
dataset and seed give bit-equal batches in the same order, with shuffle on
and off, with and without ``drop_last``, over three epochs through
``RepeatingLoader``; ``resume_loader_iterator`` positions the stream exactly
at mid-epoch and past an epoch end; an empty loader raises."""

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu_torch.runtime import dataloader as pdl

torch.set_num_threads(1)   # the test runner's workers share the host's cores: one thread each

N, BS = 10, 4          # 3 batches an epoch (2 with drop_last)


def _dataset(kind):
    rng = np.random.default_rng(3)
    if kind == "dict":
        return [{"input_ids": rng.integers(0, 100, (6,)).astype(np.int32),
                 "labels": rng.integers(0, 100, (6,)).astype(np.int64)} for _ in range(N)]
    if kind == "tuple":
        return [(rng.standard_normal(3).astype(np.float32), np.int64(i)) for i in range(N)]
    return [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(N)]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _loaders(kind, **kw):
    data = _dataset(kind)
    return jdl.DeepSpeedDataLoader(data, BS, **kw), pdl.DeepSpeedDataLoader(data, BS, **kw)


@pytest.mark.parametrize("kind", ["dict", "tuple", "array"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_three_epochs_match_the_jax_loader(kind, shuffle, drop_last):
    jl, pl = _loaders(kind, shuffle=shuffle, drop_last=drop_last, seed=5)
    assert len(pl) == len(jl) == (2 if drop_last else 3)
    jr, pr = jdl.RepeatingLoader(jl), pdl.RepeatingLoader(pl)
    for _ in range(3 * len(jl)):
        _assert_same(next(pr), next(jr))
    assert pl.epoch == jl.epoch == 3


def test_shuffle_draws_a_new_order_each_epoch():
    pl = pdl.DeepSpeedDataLoader(list(range(N)), BS, shuffle=True, seed=5,
                                 collate_fn=lambda s: tuple(s))
    epochs = [sum(list(iter(pl)), ()) for _ in range(3)]
    assert all(sorted(e) == list(range(N)) for e in epochs)
    assert epochs[0] != epochs[1] != epochs[2]
    want = np.random.default_rng(5 + 1).permutation(N).tolist()
    assert list(epochs[1]) == want


@pytest.mark.parametrize("consumed", [1, 2, 4, 7])      # mid-epoch, an epoch end, past it
@pytest.mark.parametrize("shuffle", [False, True])
def test_resume_positions_the_stream_as_the_jax_package(consumed, shuffle):
    data = _dataset("dict")
    ref = pdl.RepeatingLoader(pdl.DeepSpeedDataLoader(data, BS, shuffle=shuffle, seed=9))
    stream = [next(ref) for _ in range(consumed + 5)]
    pit = pdl.resume_loader_iterator(pdl.DeepSpeedDataLoader(data, BS, shuffle=shuffle, seed=9),
                                     consumed)
    jit = jdl.resume_loader_iterator(jdl.DeepSpeedDataLoader(data, BS, shuffle=shuffle, seed=9),
                                     consumed)
    for want in stream[consumed:]:
        got = next(pit)
        _assert_same(got, want)
        _assert_same(got, next(jit))


def test_resume_of_a_plain_iterable_skips_by_iteration():
    data = [np.array([i]) for i in range(5)]
    it = pdl.resume_loader_iterator(data, 7)        # no epoch counter: skipped by iteration
    got = [int(next(it)[0]) for _ in range(4)]
    jt = jdl.resume_loader_iterator(data, 7)
    assert got == [int(next(jt)[0]) for _ in range(4)]


def test_an_empty_loader_raises():
    for mod in (pdl, jdl):
        it = mod.resume_loader_iterator(mod.DeepSpeedDataLoader([], BS), 2)
        with pytest.raises(RuntimeError, match="no batches"):
            next(it)
    with pytest.raises(RuntimeError, match="no batches"):
        next(pdl.resume_loader_iterator(iter([]), 0))


def test_data_sampler_order_is_taken_as_given():
    data = _dataset("array")
    order = [9, 0, 8, 1, 7, 2, 6, 3, 5, 4]
    jl = jdl.DeepSpeedDataLoader(data, BS, data_sampler=order)
    pl = pdl.DeepSpeedDataLoader(data, BS, data_sampler=order)
    for a, b in zip(pl, jl):
        _assert_same(a, b)
