"""Single-process batch loader (counterpart of pvcnn_tpu/data/loader.py's
serial path): a map-style dataset -> (features, labels) numpy batches. An
item's features or labels may be a dict of arrays (the Frustum items); the
batch then holds a dict of stacked arrays.

The order is shuffled per epoch from np.random.RandomState(seed + epoch + 1)
(the JAX loader's first epoch draws from seed + 1); the trainer sets `epoch`
before iterating, so a resumed run sees the order it would have seen.
Nothing is dropped: the last batch may be smaller.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["DataLoader"]


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.epoch = 0

    def __len__(self):
        return math.ceil(len(self.dataset) / self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch + 1).shuffle(order)
        for start in range(0, len(order), self.batch_size):
            items = [self.dataset[int(i)]
                     for i in order[start:start + self.batch_size]]
            yield (_stack([f for f, _ in items]),
                   _stack([y for _, y in items]))


def _stack(parts):
    if isinstance(parts[0], dict):
        return {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    return np.stack(parts)
