"""Prefetching data loader: thread- or process-based workers.

The port's own copy of proxytransformation_tpu/data/loader.py: a
shuffling sampler (one order per `seed + epoch`), per-host shards, the
preprocessor's collate and a prefetch pipeline, in place of the
reference's torch DataLoader (configs/...clip.py:145-164).

num_workers=0 runs one background prefetch thread; num_workers>0 fans
batches out to a process pool in the spawn context, with `prefetch`
batches in flight, consumed in order. Spawn, not fork: the parent holds
a CUDA context, which a forked child cannot use.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


_WORKER_STATE: dict = {}


def _init_worker(dataset, collate_fn):
    """Pool initializer: ship dataset + collate ONCE per worker (they
    are pickled once here instead of per submitted batch)."""
    _WORKER_STATE['dataset'] = dataset
    _WORKER_STATE['collate_fn'] = collate_fn


def _prep_batch(indices):
    """Worker-side batch prep (module-level for spawn pickling)."""
    ds = _WORKER_STATE['dataset']
    return _WORKER_STATE['collate_fn']([ds[int(i)] for i in indices])


class DataLoader:

    def __init__(self, dataset, batch_size: int, collate_fn: Callable,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 prefetch: int = 2, num_shards: int = 1, shard_id: int = 0,
                 num_workers: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = max(prefetch, num_workers)
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        # per-host shard (DistSamplerSeed equivalent)
        idx = idx[self.shard_id::self.num_shards]
        if self.drop_last:
            n_batches = len(idx) // self.batch_size
            idx = idx[:n_batches * self.batch_size]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator:
        idx = self._indices()
        batches = [
            idx[i:i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        if self.num_workers > 0:
            yield from self._iter_procs(batches)
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        cancel = threading.Event()

        def _put(item) -> bool:
            """put that aborts when the consumer went away."""
            while not cancel.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in batches:
                    if cancel.is_set():
                        return
                    samples = [self.dataset[int(i)] for i in b]
                    if not _put(self.collate_fn(samples)):
                        return
            except Exception as e:  # surface pipeline errors to the consumer
                _put(e)
            _put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            # Generator cleanup: a consumer that stops early (partial
            # epoch, exception, test loop) must not leak a live worker
            # parked on q.put.
            cancel.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=5.0)

    def _iter_procs(self, batches) -> Iterator:
        """Process-pool path: `num_workers` spawn-context workers, up to
        `prefetch` batches in flight, yielded in order (the reference's
        num_workers, configs/...clip.py:149)."""
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        ctx = mp.get_context('spawn')
        with ProcessPoolExecutor(max_workers=self.num_workers,
                                 mp_context=ctx,
                                 initializer=_init_worker,
                                 initargs=(self.dataset,
                                           self.collate_fn)) as pool:
            pending = []
            it = iter(batches)
            for b in it:
                pending.append(pool.submit(_prep_batch, b))
                if len(pending) >= self.prefetch:
                    break
            while pending:
                out = pending.pop(0).result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(_prep_batch, nxt))
                yield out
