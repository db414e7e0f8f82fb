"""The port's DataLoader (pvcnn_tpu_torch/data/loader.py): every case of
tests/test_optim_loader.py::TestDataLoader against it, its determinism
contract (serial and prefetch give the serial loader's items and draws for
ShapeNet and for S3DIS over a WindowStore; process mode gives the JAX
loader's batches over the JAX ShapeNet dataset, whatever the number of
workers), an early stop that joins the prefetch thread before the next
loader draws, and a killed worker that raises."""

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from pvcnn_tpu.data.loader import DataLoader as JDataLoader
from pvcnn_tpu.data.shapenet import ShapeNet
from pvcnn_tpu_torch.data import loader as tloader
from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.data.loader import DataLoader, data_parallel_args
from pvcnn_tpu_torch.data.s3dis import S3DIS, WindowStore
from pvcnn_tpu_torch.train.s3dis import TimedLoader
from pvcnn_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def _force_workers(monkeypatch):
    # the loader clamps num_workers to the host's cores (0 on one core);
    # the pool paths must run here all the same
    monkeypatch.setattr(tloader, "_cores", lambda: 64)


def _dataset(n=10):
    return [(np.full((4, 2), i, np.float32), np.int64(i)) for i in range(n)]


def _closed(*loaders):
    for loader in loaders:
        loader.close()


def _prefetching() -> bool:
    return any(t.name == "DataLoader prefetch" for t in threading.enumerate())


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, dict):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


class Bad:
    """Raises at item 5."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == 5:
            raise RuntimeError("boom")
        return np.zeros(2, np.float32), np.int64(i)


class Aug:
    """Items that draw from numpy's global state."""

    def __len__(self):
        return 16

    def __getitem__(self, i):
        return (np.float32(i) + np.random.randn(3).astype(np.float32),
                np.int64(i))


# ---- TestDataLoader's cases (tests/test_optim_loader.py) -----------------

def test_batching_and_collation():
    batches = list(DataLoader(_dataset(), batch_size=4, prefetch=0))
    assert len(batches) == 3
    x, y = batches[0]
    assert x.shape == (4, 4, 2) and y.shape == (4,)
    assert batches[-1][0].shape == (2, 4, 2)          # partial tail kept


def test_drop_last():
    loader = DataLoader(_dataset(), batch_size=4, drop_last=True, prefetch=0)
    assert len(loader) == 2 and len(list(loader)) == 2


def test_shuffle_differs_per_epoch_but_seeded():
    """The trainer sets `epoch`: each epoch draws its own order from
    RandomState(seed + epoch + 1), the same on every loader."""
    a = DataLoader(_dataset(), batch_size=10, shuffle=True, seed=7)
    e0 = next(iter(a))[1].tolist()
    assert next(iter(a))[1].tolist() == e0            # same epoch
    a.epoch = 1
    e1 = next(iter(a))[1].tolist()
    assert e1 != e0
    order = np.arange(10)
    np.random.RandomState(7 + 1 + 1).shuffle(order)
    assert e1 == order.tolist()
    b = DataLoader(_dataset(), batch_size=10, shuffle=True, seed=7)
    assert next(iter(b))[1].tolist() == e0


def test_dict_collation():
    data = [({"a": np.ones(3, np.float32) * i, "b": np.int64(i)},
             {"y": np.int64(i)}) for i in range(4)]
    inputs, targets = next(iter(DataLoader(data, batch_size=2, prefetch=0)))
    assert inputs["a"].shape == (2, 3) and inputs["b"].tolist() == [0, 1]
    assert targets["y"].shape == (2,)


def test_prefetch_thread_raises_errors():
    with pytest.raises(RuntimeError, match="boom"):
        list(DataLoader(Bad(8), batch_size=2, prefetch=2))
    assert not _prefetching()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_worker_pool_matches_serial(prefetch):
    """Thread mode on a dataset that draws nothing: the serial batches."""
    ds = _dataset(23)
    serial = list(DataLoader(ds, batch_size=4, shuffle=True, seed=3,
                             prefetch=prefetch))
    pooled = list(DataLoader(ds, batch_size=4, shuffle=True, seed=3,
                             num_workers=4, prefetch=prefetch))
    _assert_batches_equal(pooled, serial)


def test_worker_pool_raises_errors():
    with pytest.raises(RuntimeError, match="boom"):
        list(DataLoader(Bad(8), batch_size=2, prefetch=2, num_workers=3))


def test_process_pool_matches_serial():
    ds = _dataset(23)
    loader = DataLoader(ds, batch_size=4, shuffle=True, seed=3,
                        num_workers=3, workers_mode="process")
    try:
        serial = list(DataLoader(ds, batch_size=4, shuffle=True, seed=3))
        _assert_batches_equal(list(loader), serial)
        loader.epoch = 1                  # the pool persists across epochs
        pool = loader._pool
        _assert_batches_equal(list(loader), _epoch(
            DataLoader(ds, batch_size=4, shuffle=True, seed=3), 1))
        assert loader._pool is pool
    finally:
        loader.close()
    assert loader._pool is None


def _epoch(loader, epoch):
    loader.epoch = epoch
    return list(loader)


def test_process_pool_augmentation_deterministic():
    """Per-batch reseeding: the draws do not depend on the worker count
    (numpy's global state for a dataset without `rng`)."""
    loaders = [DataLoader(Aug(), batch_size=4, seed=11, num_workers=w,
                          workers_mode="process") for w in (2, 5)]
    try:
        runs = [[x for x, _ in loader] for loader in loaders]
    finally:
        _closed(*loaders)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_process_pool_raises_errors():
    loader = DataLoader(Bad(8), batch_size=2, num_workers=2,
                        workers_mode="process")
    try:
        with pytest.raises(RuntimeError, match="boom"):
            list(loader)
    finally:
        loader.close()


def test_process_sharding_partitions_epoch():
    """4 ranks: disjoint rank-strided slices of one shuffle, equal lengths,
    together len // world * world samples."""
    ds, world, seen = _dataset(23), 4, []
    for rank in range(world):
        loader = DataLoader(ds, batch_size=2, shuffle=True, seed=9,
                            shard_by_process=True, process_index=rank,
                            process_count=world)
        assert len(loader) == 3          # 23 // 4 = 5 samples -> 3 batches
        ys = np.concatenate([y for _, y in loader])
        assert len(ys) == 5
        seen.append(ys)
    assert len(np.unique(np.concatenate(seen))) == 20


def test_process_sharding_off_by_default():
    loader = DataLoader(_dataset(6), batch_size=3, process_index=2,
                        process_count=4)
    assert len(loader) == 2 and len(list(loader)) == 2
    with pytest.raises(ValueError, match="process_count"):
        DataLoader(_dataset(6), batch_size=3, process_index=2)


def test_data_parallel_args_wiring():
    assert data_parallel_args(32, "train", process_count=1) == {
        "batch_size": 32, "shard_by_process": False}
    assert data_parallel_args(32, "train", process_count=4) == {
        "batch_size": 8, "shard_by_process": True}
    assert data_parallel_args(32, "test", process_count=4) == {
        "batch_size": 32, "shard_by_process": False}
    with pytest.raises(ValueError, match="divide evenly"):
        data_parallel_args(30, "train", process_count=4)
    # torch.distributed is not initialized here: one process
    assert data_parallel_args(16, "train") == {
        "batch_size": 16, "shard_by_process": False}


def test_multi_host_epoch_consumes_disjoint_shards():
    ds, world, global_bs = _dataset(64), 4, 8
    args = data_parallel_args(global_bs, "train", process_count=world)
    per_rank = []
    for rank in range(world):
        loader = DataLoader(ds, shuffle=True, seed=3, process_index=rank,
                            process_count=world, **args)
        ys = [y for _, y in loader]
        assert all(len(y) == global_bs // world for y in ys)
        per_rank.append(np.concatenate(ys))
    assert {len(y) for y in per_rank} == {64 // world}
    assert len(np.unique(np.concatenate(per_rank))) == 64


def test_unknown_workers_mode_raises():
    with pytest.raises(ValueError, match="workers_mode"):
        DataLoader(_dataset(), 2, workers_mode="fiber")


def test_workers_clamp_to_the_cores(monkeypatch):
    monkeypatch.setattr(tloader, "_cores", lambda: 1)
    assert DataLoader(_dataset(), 2, num_workers=16).num_workers == 0
    monkeypatch.setattr(tloader, "_cores", lambda: 8)
    assert DataLoader(_dataset(), 2, num_workers=16).num_workers == 8
    assert DataLoader(_dataset(), 2, num_workers=3).num_workers == 3


# ---- the determinism contract ---------------------------------------------

def _old_serial(dataset, batch_size, shuffle, seed, epoch):
    """The port's serial loader before prefetch and pools."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed + epoch + 1).shuffle(order)
    out = []
    for start in range(0, len(order), batch_size):
        items = [dataset[int(i)] for i in order[start:start + batch_size]]
        out.append((np.stack([f for f, _ in items]),
                    np.stack([y for _, y in items])))
    return out


@pytest.fixture(scope="module")
def shapenet_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet"))
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70),
                                 (9, 88), (4, 60), (12, 75)])
    return root


def _rng_state(rng):
    return [np.asarray(s).tolist() if isinstance(s, np.ndarray) else s
            for s in rng.get_state()]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_serial_and_prefetch_give_todays_shapenet_items(shapenet_tree,
                                                        prefetch):
    """Two epochs of the train split: the batches and the reader's draws
    (its generator's state after each epoch) are the old serial loader's."""
    mine = tdata.ShapeNetDataset(shapenet_tree, 64, "train", seed=5)
    ref = tdata.ShapeNetDataset(shapenet_tree, 64, "train", seed=5)
    loader = DataLoader(mine, 3, shuffle=True, seed=2, prefetch=prefetch)
    for epoch in range(2):
        _assert_batches_equal(_epoch(loader, epoch),
                              _old_serial(ref, 3, True, 2, epoch))
        assert _rng_state(mine.rng) == _rng_state(ref.rng)


def _s3dis_store(root, rooms, points=24, seed=0):
    """A prepared tree of `rooms` ({area: room count}) as a WindowStore:
    the room folders on disk, each room's zero and half files in memory."""
    rng = np.random.RandomState(seed)
    store = WindowStore()
    for area, count in rooms.items():
        for r in range(count):
            scene = os.path.join(root, area, f"room_{r}")
            os.makedirs(scene)
            for offset in ("zero", "half"):
                w = rng.randint(2, 5)
                store[os.path.join(scene, f"{offset}_0.h5")] = {
                    "data": rng.rand(w, points, 9).astype(np.float32),
                    "label_seg": rng.randint(0, 13, (w, points)),
                    "data_num": rng.randint(points // 3, points + 1, w),
                    "indices_split_to_full": np.tile(np.arange(points),
                                                     (w, 1))}
    return store


@pytest.fixture(scope="module")
def s3dis_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("s3dis"))
    return root, _s3dis_store(root, {"Area_1": 3, "Area_2": 2, "Area_5": 2})


def _s3dis(tree, seed=0):
    root, store = tree
    return S3DIS(root, 16, rng=np.random.RandomState(seed), opener=store)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_serial_and_prefetch_give_todays_s3dis_items(s3dis_tree, prefetch):
    """An epoch of the train split, then the test split, as train.s3dis
    runs them: the batches and the shared generator's draws are the old
    serial loader's."""
    mine, ref = _s3dis(s3dis_tree), _s3dis(s3dis_tree)
    train = DataLoader(mine["train"], 4, shuffle=True, seed=1,
                       prefetch=prefetch)
    test = DataLoader(mine["test"], 4, prefetch=prefetch)
    for epoch in range(2):
        _assert_batches_equal(_epoch(train, epoch),
                              _old_serial(ref["train"], 4, True, 1, epoch))
        _assert_batches_equal(list(test),
                              _old_serial(ref["test"], 4, False, 0, 0))
        assert _rng_state(mine["train"].rng) == _rng_state(ref["train"].rng)


class Counting:
    """Counts its items; each takes a little time, so that a prefetch
    thread runs ahead of a consumer that stops."""

    def __init__(self, n, rng):
        self.n, self.rng, self.calls = n, rng, 0

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(0.002)
        self.calls += 1
        return self.rng.rand(2).astype(np.float32), np.int64(i)


@pytest.mark.parametrize("prefetch", [1, 2, 4])
def test_early_stop_joins_the_prefetch_thread(prefetch):
    """A consumer that stops after one batch: closing the generator joins
    the thread, which drew at most prefetch + 1 batches beyond it; the
    shared generator does not move after that."""
    rng = np.random.RandomState(0)
    ds = Counting(200, rng)
    batches = iter(DataLoader(ds, 2, prefetch=prefetch))
    next(batches)
    time.sleep(0.05)                      # let the thread fill its queue
    batches.close()
    assert not _prefetching()
    assert ds.calls <= 2 * (1 + prefetch + 1)
    state = _rng_state(rng)
    time.sleep(0.05)
    assert _rng_state(rng) == state


def test_max_steps_joins_before_the_test_split_draws(s3dis_tree):
    """Trainer.train_epoch with max_steps over a prefetching S3DIS train
    loader (through train.s3dis's TimedLoader): when it returns no thread
    is left, and the test split then gives the old serial loader's batches
    from the shared generator's state it left."""
    data = _s3dis(s3dis_tree)
    timings = {}
    train = TimedLoader(DataLoader(data["train"], 2, shuffle=True, seed=0),
                        timings, "train_data")
    trainer = Trainer(torch.nn.Linear(1, 1), None, None, "cpu")
    trainer.train_step = lambda x, y: torch.zeros(())
    trainer.train_epoch(train, 0, max_steps=1)
    assert not _prefetching() and timings["train_data"] > 0
    state = _rng_state(data["test"].rng)
    time.sleep(0.05)
    assert _rng_state(data["test"].rng) == state
    ref = _s3dis(s3dis_tree)
    ref["test"].rng.set_state(data["test"].rng.get_state())
    _assert_batches_equal(list(DataLoader(data["test"], 4)),
                          _old_serial(ref["test"], 4, False, 0, 0))
    train.close()


def test_process_mode_matches_the_jax_loader(shapenet_tree):
    """Process mode over the port's ShapeNet reader: two epochs equal the
    JAX loader's process mode over the JAX dataset bit for bit (the JAX
    loader's epoch E is the port's epoch + 1), with 1 and with 3
    workers."""
    theirs = JDataLoader(ShapeNet(shapenet_tree, 64, split="train")["train"],
                         3, shuffle=True, seed=4, num_workers=2,
                         workers_mode="process")
    mine = [DataLoader(tdata.ShapeNetDataset(shapenet_tree, 64, "train",
                                             seed=99),
                       3, shuffle=True, seed=4, num_workers=w,
                       workers_mode="process") for w in (1, 3)]
    try:
        for epoch in range(2):
            want = list(theirs)
            for loader in mine:
                got = _epoch(loader, epoch)
                _assert_batches_equal(got, want)
    finally:
        _closed(theirs, *mine)


def test_process_mode_over_s3dis_is_independent_of_workers(s3dis_tree):
    """Process mode over the S3DIS reader (its files cached in the parent
    before the fork; the workers drop them, after_fork): the batches are
    the same with 2 and 4 workers, and each is the serial loader's batch
    from the generator reseeded for it."""
    data = _s3dis(s3dis_tree)
    list(DataLoader(data["train"], 4))              # fill the parent's cache
    held = dict(data["train"].cache)
    runs = []
    for w in (2, 4):
        loader = DataLoader(data["train"], 4, shuffle=True, seed=6,
                            num_workers=w, workers_mode="process")
        try:
            runs.append(_epoch(loader, 1))
        finally:
            loader.close()
    _assert_batches_equal(runs[0], runs[1])
    assert data["train"].cache == held
    order = np.arange(len(data["train"]))
    np.random.RandomState(6 + 1 + 1).shuffle(order)
    ref = _s3dis(s3dis_tree)["train"]
    for j, batch in enumerate(runs[0]):
        ref.rng.seed((6 * 1000003 + 2 * 9176 + j) % 2 ** 32)
        items = [ref[int(i)] for i in order[4 * j:4 * j + 4]]
        np.testing.assert_array_equal(batch[0],
                                      np.stack([f for f, _ in items]))


class Slow:
    def __len__(self):
        return 60

    def __getitem__(self, i):
        time.sleep(0.05)
        return np.zeros(2, np.float32), np.int64(i)


def test_killed_worker_raises():
    """A worker killed mid-epoch: the loader sees it dead and raises, in
    seconds, and its pool is closed."""
    loader = DataLoader(Slow(), 2, num_workers=2, workers_mode="process")
    try:
        batches = iter(loader)
        next(batches)
        os.kill(loader._pool[2][0].pid, signal.SIGKILL)
        start = time.monotonic()
        with pytest.raises(RuntimeError, match="died unexpectedly"):
            list(batches)
        assert time.monotonic() - start < 10
        assert loader._pool is None
    finally:
        loader.close()
