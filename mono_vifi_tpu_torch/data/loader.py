"""Threaded prefetching batch loader (the port's copy of
mono_vifi_tpu/data/loader.py): a thread pool decodes samples ahead of the
consumer (PIL and numpy release the GIL for the hot parts), batches are
collated into fixed-shape numpy dicts in the sampler's order, and
`device_prefetch` copies each batch to the card while the step before it
runs. The stateful samplers' epoch / start_iter protocol resumes an epoch."""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch


def collate(samples: list[dict]) -> dict:
    return {k: np.stack([np.asarray(s[k]) for s in samples], axis=0) for k in samples[0]}


class DataLoader:
    """Map-style dataset (+ sampler) -> iterator of batched numpy dicts."""

    def __init__(self, dataset, batch_size: int, sampler=None, num_workers: int = 4,
                 drop_last: bool = True, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self):
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        indices = list(self.sampler if self.sampler is not None else range(len(self.dataset)))
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


def device_prefetch(iterator, device, size: int = 2):
    """Batches of numpy arrays -> the same batches as tensors on `device`,
    `size` batches ahead of the consumer (the counterpart of the JAX
    package's double-buffered device_put).

    On a card each batch is staged in pinned host memory and copied with
    `non_blocking=True` on a side stream, so the copy of the next batch runs
    while the current step's kernels do; the consumer's stream waits for the
    copy before the batch is handed over. dtypes are kept: uint8 planes
    travel as uint8 and `training.monovifi.prepare_batch` dequantizes them on
    the device. A pinned host batch is held until the consumer asks for the
    next batch, that is, until the step that reads its device copy has been
    enqueued."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if on_card else None
    q = collections.deque()

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if not on_card:
            return host, {k: v.to(device) for k, v in host.items()}, None
        host = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(copy_stream):
            dev = {k: v.to(device, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return host, dev, done

    it = iter(iterator)
    for batch in it:
        q.append(put(batch))
        if len(q) >= size:
            break
    while q:
        host, dev, done = q.popleft()
        for batch in it:
            q.append(put(batch))
            break
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            for v in dev.values():
                v.record_stream(stream)
        yield dev
        del host
