"""Stateful, resumable samplers (the port's copy of
mono_vifi_tpu/data/samplers.py; reference datasets/__init__.py:10-85).

Each epoch's order is `torch.randperm` from a CPU `torch.Generator` seeded
with seed + epoch, the stream the JAX package and the reference draw from.
`start_iter` skips the samples already consumed before a mid-epoch
checkpoint.
"""

from __future__ import annotations

import torch


def _randperm(n: int, seed: int) -> list[int]:
    g = torch.Generator()
    g.manual_seed(seed)
    return torch.randperm(n, generator=g).tolist()


class StatefulSampler:
    """Single-process sampler: seed+epoch permutation, start_iter skip."""

    def __init__(self, num_samples: int, seed: int = 0):
        self.num_samples = num_samples
        self.seed = seed
        self.epoch = 0
        self.start_iter = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_start_iter(self, start_iter: int):
        self.start_iter = start_iter

    def __len__(self):
        return self.num_samples

    def __iter__(self):
        indices = _randperm(self.num_samples, self.seed + self.epoch)
        return iter(indices[self.start_iter:])


class StatefulDistributedSampler(StatefulSampler):
    """Strided rank sharding indices[rank::num_replicas] over the common
    truncation (reference datasets/__init__.py:64-77)."""

    def __init__(self, num_samples: int, seed: int = 0, rank: int = 0, num_replicas: int = 1):
        super().__init__(num_samples, seed)
        self.rank = rank
        self.num_replicas = num_replicas
        self.total_size = num_samples - (num_samples % num_replicas)

    def __len__(self):
        return self.total_size // self.num_replicas

    def __iter__(self):
        indices = _randperm(self.num_samples, self.seed + self.epoch)
        indices = indices[self.rank:self.total_size:self.num_replicas]
        return iter(indices[self.start_iter:])
