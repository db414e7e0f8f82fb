"""Batch loader (counterpart of pvcnn_tpu/data/loader.py): a map-style
dataset -> numpy batches, shuffled per epoch, with background prefetch, an
item-fetch pool of threads or a persistent pool of worker processes,
drop_last and sharding over processes.

An item is (features, labels); either may be a dict of arrays (the
Frustum items), and the batch then holds a dict of arrays stacked per key.
The trainer sets `epoch` (0-based) before iterating, and the shuffle draws
from np.random.RandomState(seed + epoch + 1) (the JAX loader's first epoch
draws from seed + 1), so a resumed run sees the order it would have seen.
The last batch may be smaller unless drop_last.

Determinism:
- num_workers=0, with or without prefetch: the batches and every draw the
  dataset makes are the serial loader's, bit for bit, over a whole epoch:
  one thread assembles the batches in order. When the consumer stops early
  (a `break`, max_steps), closing the generator stops the prefetch thread
  and joins it before it returns; the thread has then assembled at most
  prefetch + 1 batches beyond the consumer's, and no thread is still
  inside dataset[i] when the next loader (the test split's, say) draws
  from a generator the splits share (the S3DIS and KITTI readers').
- workers_mode "process": a persistent pool of forked workers builds whole
  batches; the parent reorders them. Each batch task first reseeds its
  worker's generator from (seed * 1000003 + E * 9176 + j) % 2**32, where
  E = epoch + 1 is the JAX loader's epoch and j the batch index: the
  dataset's `rng` where it has one (every reader of the port draws from
  its own), else numpy's global state. A batch then depends on (seed,
  epoch, j) alone, not on the number of workers, and equals the JAX
  loader's process-mode batch over the JAX dataset, as long as no worker
  draws a cache eviction (an S3DIS split of at most 20 files, any ShapeNet
  split). Workers touch numpy only, never torch or CUDA state (the parent
  may have initialized CUDA before the fork); a dataset with an
  `after_fork()` method has it called in each worker first (the S3DIS
  reader drops the parent's open files there).
- workers_mode "thread": item fetch on a thread pool, in order per batch
  (the JAX loader's semantics); the items are the serial loader's only for
  a dataset that draws nothing, since the pool's draws interleave. The
  S3DIS reader holds a lock around each item's reads and draws. h5py runs
  every call behind one global lock, so threads cannot read h5 files in
  parallel.

num_workers is clamped to the host's cores (0 on one core).
shard_by_process gives each process a disjoint rank-strided slice of every
epoch's order, len(dataset) // world samples each; the rank and world come
from process_index / process_count, else from torch.distributed where it
is initialized, else (0, 1).
"""

from __future__ import annotations

import concurrent.futures as cf
import itertools
import multiprocessing as mp
import os
import pickle
import queue
import threading
import time
from typing import Any, Iterator

import numpy as np

__all__ = ["DataLoader", "data_parallel_args"]


def _distributed() -> tuple[int, int]:
    """(rank, world size) of torch.distributed, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def data_parallel_args(global_batch_size: int, split: str,
                       process_count: int | None = None) -> dict:
    """DataLoader kwargs for a split under data parallelism over processes:
    the train split loads a disjoint shard per process at the local batch
    size global / world; other splits load the whole set at the global
    batch size on every process. One process: a pass-through.
    `process_count` defaults to torch.distributed's world size."""
    if process_count is None:
        process_count = _distributed()[1]
    if process_count <= 1 or split != "train":
        return {"batch_size": int(global_batch_size),
                "shard_by_process": False}
    if global_batch_size % process_count:
        raise ValueError(f"global batch {global_batch_size} must divide "
                         f"evenly over {process_count} processes")
    return {"batch_size": int(global_batch_size) // process_count,
            "shard_by_process": True}


def _collate(items):
    """Stack samples: tuples and dicts of arrays are stacked per entry."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _collate([it[k] for it in items]) for k in first}
    if isinstance(first, tuple):
        return tuple(_collate([it[i] for it in items])
                     for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


def _reseed(dataset, seed: int) -> None:
    rng = getattr(dataset, "rng", None)
    if isinstance(rng, np.random.RandomState):
        rng.seed(seed)
    else:
        np.random.seed(seed)


def _proc_worker(dataset, task_q, out_q):
    """A worker process: build whole batches until told to stop (None)."""
    import torch

    torch.set_num_threads(1)
    after_fork = getattr(dataset, "after_fork", None)
    if after_fork is not None:
        after_fork()
    while True:
        task = task_q.get()
        if task is None:
            return
        tag, j, idx, seed = task
        try:
            _reseed(dataset, seed)
            out_q.put((tag, j, _collate([dataset[i] for i in idx]), None))
        except Exception as e:          # raised in the parent
            try:
                pickle.dumps(e)
            except Exception:
                e = RuntimeError(repr(e))
            out_q.put((tag, j, None, e))


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


class DataLoader:
    # seconds between checks for a dead worker process while waiting
    POLL_SECONDS = 1.0

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, prefetch: int = 2,
                 num_workers: int = 0, workers_mode: str = "thread",
                 shard_by_process: bool = False,
                 process_index: int | None = None,
                 process_count: int | None = None):
        if workers_mode not in ("thread", "process"):
            raise ValueError(f"unknown workers_mode {workers_mode!r}")
        if process_index is not None and process_count is None:
            raise ValueError("process_index needs process_count")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = int(seed)
        self.prefetch = int(prefetch)
        cores = _cores()
        self.num_workers = 0 if cores <= 1 else min(int(num_workers), cores)
        self.workers_mode = workers_mode
        self.shard_by_process = shard_by_process
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self._pool = None
        self._passes = itertools.count()

    def _shard(self) -> tuple[int, int]:
        if not self.shard_by_process:
            return 0, 1
        if self.process_index is None:
            return _distributed()
        rank, world = int(self.process_index), int(self.process_count)
        if not 0 <= rank < world:
            raise ValueError(f"process_index {rank} of {world}")
        return rank, world

    def __len__(self) -> int:
        n = len(self.dataset) // self._shard()[1]
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch + 1).shuffle(order)
        rank, world = self._shard()
        if world > 1:
            order = order[rank::world][:n // world]
        return order

    def _batches(self) -> Iterator[Any]:
        order = self._order()
        n = len(order)
        stop = n - n % self.batch_size if self.drop_last else n
        starts = range(0, stop, self.batch_size)
        if self.num_workers > 0 and self.workers_mode == "process":
            yield from self._batches_processes(order, starts)
        elif self.num_workers > 0:
            yield from self._batches_pooled(order, starts)
        else:
            for start in starts:
                yield _collate([self.dataset[int(i)]
                                for i in order[start:start + self.batch_size]])

    def _ensure_pool(self):
        if self._pool is None:
            ctx = mp.get_context("fork")
            task_q, out_q = ctx.Queue(), ctx.Queue()
            procs = [ctx.Process(target=_proc_worker,
                                 args=(self.dataset, task_q, out_q),
                                 daemon=True)
                     for _ in range(self.num_workers)]
            for p in procs:
                p.start()
            self._pool = (task_q, out_q, procs)
        return self._pool

    def close(self) -> None:
        """Stop the worker processes (they are daemons and die with the
        parent anyway). The next process-mode epoch forks a new pool."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        task_q, out_q, procs = pool
        for _ in procs:
            task_q.put(None)
        # drain results so that no worker blocks on a full pipe
        deadline = time.monotonic() + 5.0
        while any(p.is_alive() for p in procs) \
                and time.monotonic() < deadline:
            try:
                out_q.get(timeout=0.05)
            except queue.Empty:
                pass
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        for q in (task_q, out_q):
            q.cancel_join_thread()
            q.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _batches_processes(self, order, starts) -> Iterator[Any]:
        """Batch tasks on the persistent pool, results reordered by batch
        index. Results are tagged with this pass, so that those of an
        abandoned pass are dropped, not delivered."""
        if not starts:
            return
        task_q, out_q, procs = self._ensure_pool()
        tag = next(self._passes)
        epoch = self.epoch + 1

        def submit(j):
            idx = [int(i) for i in order[starts[j]:starts[j]
                                         + self.batch_size]]
            seed = (self.seed * 1000003 + epoch * 9176 + j) % (2 ** 32)
            task_q.put((tag, j, idx, seed))

        ahead = min(self.num_workers + max(self.prefetch, 1), len(starts))
        for j in range(ahead):
            submit(j)
        held = {}
        for want in range(len(starts)):
            while want not in held:
                dead = [p.pid for p in procs if not p.is_alive()]
                if dead:
                    self.close()
                    raise RuntimeError(f"DataLoader worker process(es) "
                                       f"{dead} died unexpectedly")
                try:
                    got, j, batch, err = out_q.get(timeout=self.POLL_SECONDS)
                except queue.Empty:
                    continue
                if got != tag:
                    continue
                if err is not None:
                    raise err
                held[j] = batch
                if ahead < len(starts):
                    submit(ahead)
                    ahead += 1
            yield held.pop(want)

    def _batches_pooled(self, order, starts) -> Iterator[Any]:
        """Items on a thread pool, awaited in order: prefetch + 1 batches'
        items in flight ahead of the one being collated."""
        depth = max(self.prefetch, 1) + 1
        pending = []

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(start):
                pending.append([pool.submit(self.dataset.__getitem__, int(i))
                                for i in order[start:start + self.batch_size]])

            ahead = min(depth, len(starts))
            for start in starts[:ahead]:
                submit(start)
            for _ in starts:
                futures = pending.pop(0)
                if ahead < len(starts):
                    submit(starts[ahead])
                    ahead += 1
                yield _collate([f.result() for f in futures])

    def __iter__(self):
        if self.prefetch <= 0:
            yield from self._batches()
            return
        ready: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()
        errors = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    ready.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def fill():
            batches = self._batches()
            try:
                for batch in batches:
                    if not put(batch):
                        return
            except BaseException as e:  # re-raised in the consumer's thread
                errors.append(e)
            finally:
                batches.close()
                put(done)

        thread = threading.Thread(target=fill, daemon=True,
                                  name="DataLoader prefetch")
        thread.start()
        try:
            while True:
                batch = ready.get()
                if batch is done:
                    break
                yield batch
        finally:
            stop.set()
            thread.join()
        if errors:
            raise errors[0]
