"""The port's copy of the JAX package's ``ArrayDataset``
(metisfl_tpu/models/dataset.py): an in-memory (x, y) dataset of numpy
arrays whose batch order is a pure function of ``(seed, epoch)``, so both
engines draw the same batches in the same order."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class ArrayDataset:
    """In-memory supervised dataset of (x, y) numpy arrays."""

    def __init__(self, x: np.ndarray, y: np.ndarray, seed: int = 0):
        if len(x) != len(y):
            raise ValueError(f"x/y length mismatch: {len(x)} vs {len(y)}")
        self.x = np.asarray(x)
        self.y = np.asarray(y)
        self.seed = seed

    def __len__(self) -> int:
        return len(self.x)

    @property
    def size(self) -> int:
        return len(self.x)

    def batches(self, batch_size: int, shuffle: bool = True,
                epoch: int = 0, drop_remainder: bool = False
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch of batches; deterministic given (seed, epoch)."""
        n = len(self.x)
        idx = np.arange(n)
        if shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            rng.shuffle(idx)
        stop = n - (n % batch_size) if drop_remainder else n
        for start in range(0, stop, batch_size):
            sel = idx[start : start + batch_size]
            yield self.x[sel], self.y[sel]

    def infinite_batches(self, batch_size: int, shuffle: bool = True,
                         drop_remainder: bool = True):
        """Endless batch stream cycling epochs (for exactly-N-steps
        training)."""
        epoch = 0
        while True:
            yielded = False
            for batch in self.batches(batch_size, shuffle, epoch,
                                      drop_remainder):
                yielded = True
                yield batch
            if not yielded:  # dataset smaller than one batch
                for batch in self.batches(batch_size, shuffle, epoch, False):
                    yield batch
            epoch += 1
