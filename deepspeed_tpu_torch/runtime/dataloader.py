"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``):
``DeepSpeedDataLoader`` batches a dataset, ``RepeatingLoader`` restarts an
exhausted loader, and ``resume_loader_iterator`` positions a standing stream
after a number of consumed batches.

The loader yields the JAX package's host numpy batches in the same order for
the same dataset, seed, ``shuffle`` and ``drop_last``: each epoch shuffles
with ``np.random.default_rng(seed + epoch)``. A ``data_sampler`` gives the
order instead: an iterable of indices, or of index batches such as
``runtime/data_pipeline``'s ``DeepSpeedDataSampler`` yields. The engine
moves each batch to its device.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np


class RepeatingLoader:
    """Wrap an iterable to restart from the beginning when exhausted."""

    def __init__(self, loader: Iterable):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            batch = next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            batch = next(self.data_iter)
        return batch


def resume_loader_iterator(loader, consumed_batches: int):
    """A standing iterator over ``loader`` positioned ``consumed_batches``
    batches in, continuing across epoch boundaries forever (so a resumed run
    sees exactly the batches an uninterrupted run would have seen next). For
    :class:`DeepSpeedDataLoader` the consumed epochs are replayed by
    counter, not by iteration: ``loader.epoch`` is set so the shuffle seed of
    the current epoch matches, then only the in-epoch remainder is skipped."""
    per_epoch = None
    try:
        per_epoch = len(loader)
    except TypeError:
        pass
    skip = consumed_batches
    if per_epoch and hasattr(loader, "epoch"):
        loader.epoch = consumed_batches // per_epoch
        skip = consumed_batches % per_epoch

    def _stream():
        skipped = 0
        while True:
            empty = True
            for item in iter(loader):
                empty = False
                if skipped < skip:
                    skipped += 1
                    continue
                yield item
            if empty:
                # an empty pass would otherwise spin forever (empty dataset,
                # or a one-shot generator that iter() cannot restart)
                raise RuntimeError(
                    f"resume_loader_iterator: loader yielded no batches; "
                    f"cannot position the stream {skip} batch(es) in")

    return _stream()


def _default_collate(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([s[i] for s in samples]) for i in range(len(first)))
    return np.stack(samples)


class DeepSpeedDataLoader:
    """Batches a dataset (any sequence of samples) into host numpy batches of
    ``batch_size``; the process feeds its one device."""

    def __init__(self,
                 dataset,
                 batch_size: int,
                 collate_fn: Optional[Callable] = None,
                 drop_last: bool = False,
                 shuffle: bool = False,
                 seed: int = 0,
                 num_local_io_workers: int = 0,
                 data_sampler=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.data_sampler = data_sampler
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        if self.data_sampler is not None:
            # indices, or batches of indices taken in turn (a
            # DeepSpeedDataSampler yields micro-batches: at its micro-batch
            # size each batch here is one of them)
            order = []
            for item in self.data_sampler:
                if isinstance(item, (list, tuple, np.ndarray)):
                    order.extend(item)
                else:
                    order.append(item)
        elif self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(n).tolist()
        else:
            order = list(range(n))
        self.epoch += 1
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                break
            yield self.collate_fn([self.dataset[i] for i in idx])
