"""Minibatch loader over in-memory numpy arrays (a copy of
``regneuralde_tpu/data/loader.py``, which cannot be imported without JAX).

The analogue of ``Flux.Data.DataLoader`` as the reference uses it
(src/dataset.jl:19-29): shuffle-per-epoch train iteration, optional
partial final batch, multiple parallel tensors. Deterministic given the
seed; batches come out as numpy (the caller moves them to the device).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class DataLoader:
    def __init__(
        self,
        arrays: Sequence[np.ndarray],
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        source: str = "memory",
    ):
        arrays = tuple(np.asarray(a) for a in arrays)
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("all arrays must share the leading axis")
        self.arrays = arrays
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.source = source
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(idx)
        nb = len(self)
        for i in range(nb):
            sel = idx[i * self.batch_size : (i + 1) * self.batch_size]
            batch = tuple(a[sel] for a in self.arrays)
            yield batch if len(batch) > 1 else batch[0]
