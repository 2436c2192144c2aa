"""Host data loader: batching, shuffling, per-replica sharding, optional
workers (the port's own copy of go_with_the_flows_tpu/data/loader.py,
numpy only).

Replaces the reference's torch DataLoader + DistributedSampler stack:
each replica iterates its own shard of the dataset (DistributedSampler
semantics: a permutation seeded by (seed, epoch), padded to a multiple
of the number of replicas by wrapping, split round-robin), collates
numpy batches and hands (B, 3, N) clouds to the step, which moves them
to the device.

A dataset is anything with `__len__` and `__getitem__` that returns a
dict of arrays; its `set_epoch(epoch)` is called when it has one. A
dataset with `get_batch(indices)` (the ShapeNet datasets, whose
`get_batch` draws a whole batch's clouds in one multithreaded native
call) gives each batch's samples in one call, and the workers are not
used. Otherwise, `num_workers > 0` with the default
`worker_type="thread"` maps the samples over a thread pool;
`worker_type="process"` over a spawn-based process pool, each worker
holding its own unpickled copy of the dataset. `prefetch > 0` assembles
up to that many batches ahead on a background thread, so host-side work
overlaps the step in flight.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Iterator

import numpy as np

_END = object()  # sentinel: producer finished

_WORKER_DATASET = None  # set once per spawned worker process


def _process_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_worker_get(args):
    # the parent's set_epoch does not reach a spawned worker's copy of
    # the dataset, so the epoch travels with each task; a dataset without
    # set_epoch has no epoch to sync
    epoch, i = args
    dataset = _WORKER_DATASET
    if (hasattr(dataset, "set_epoch")
            and getattr(dataset, "epoch", None) != epoch):
        dataset.set_epoch(epoch)
    return dataset[int(i)]


def _collate(samples):
    return {key: np.stack([np.asarray(s[key]) for s in samples])
            for key in samples[0]}


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = True,
        num_workers: int = 0,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 0,
        prefetch: int = 2,
        worker_type: str = "thread",
    ):
        if worker_type not in ("thread", "process"):
            raise ValueError(f"worker_type must be 'thread' or 'process', "
                             f"got {worker_type!r}")
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside 0..{num_replicas - 1}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.worker_type = worker_type
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self._pool = None

    def set_epoch(self, epoch: int):
        """Reshuffle seed per epoch (DistributedSampler.set_epoch)."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self.num_replicas > 1:
            total = int(math.ceil(n / self.num_replicas) * self.num_replicas)
            if total > n:  # pad by wrapping (DistributedSampler semantics)
                idx = np.concatenate([idx, idx[: total - n]])
            idx = idx[self.rank::self.num_replicas]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return int(math.ceil(n / self.batch_size))

    def _get_pool(self):
        if self._pool is None and self.num_workers > 0:
            if self.worker_type == "process":
                import multiprocessing as mp

                ctx = mp.get_context("spawn")
                self._pool = ctx.Pool(
                    self.num_workers,
                    initializer=_process_worker_init,
                    initargs=(self.dataset,),
                )
            else:
                from multiprocessing.pool import ThreadPool

                self._pool = ThreadPool(self.num_workers)
        return self._pool

    def _assemble(self, chunk) -> dict:
        if hasattr(self.dataset, "get_batch"):
            return _collate(self.dataset.get_batch(chunk))
        pool = self._get_pool()
        if pool is None:
            samples = [self.dataset[int(i)] for i in chunk]
        elif self.worker_type == "process":
            samples = pool.map(_process_worker_get,
                               [(self.epoch, int(i)) for i in chunk])
        else:
            samples = pool.map(lambda i: self.dataset[int(i)], list(chunk))
        return _collate(samples)

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        chunks = [
            idx[b * self.batch_size:(b + 1) * self.batch_size]
            for b in range(len(self))
        ]
        if self.prefetch <= 0:
            for chunk in chunks:
                yield self._assemble(chunk)
            return

        # background assembly: the bounded queue holds up to `prefetch`
        # ready batches; the producer blocks when it is that far ahead
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for chunk in chunks:
                    if stop.is_set():
                        return
                    q.put(self._assemble(chunk))
                q.put(_END)
            except BaseException as e:  # noqa: BLE001 — raised below
                q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():  # unblock a producer stuck on put()
                q.get_nowait()
            t.join(timeout=5.0)

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool = None
