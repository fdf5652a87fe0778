"""Threaded prefetching batch loader (the port's copy of
mono_vifi_tpu/data/loader.py without the samplers): a thread pool decodes
samples ahead of the consumer (PIL and numpy release the GIL for the hot
parts), and batches are collated into fixed-shape numpy dicts."""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([np.asarray(s[k]) for s in samples], axis=0) for k in samples[0]}


class DataLoader:
    """Map-style dataset -> iterator of batched numpy dicts, in index order."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 4,
                 drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        indices = list(range(len(self.dataset)))
        batches = [indices[i:i + self.batch_size]
                   for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_workers <= 1:
            for b in batches:
                yield collate([self.dataset[i] for i in b])
            return

        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = collections.deque()

            def submit(batch_idx):
                pending.append([pool.submit(self.dataset.__getitem__, i)
                                for i in batches[batch_idx]])

            next_submit = 0
            for _ in range(min(self.prefetch, len(batches))):
                submit(next_submit)
                next_submit += 1
            while pending:
                samples = [f.result() for f in pending.popleft()]
                if next_submit < len(batches):
                    submit(next_submit)
                    next_submit += 1
                yield collate(samples)
