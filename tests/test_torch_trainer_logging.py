"""The port's scalar writer, points/s meter and trace
(pvcnn_tpu_torch/utils/{logging,profiler}.py) and the trainer's use of
them: the JSON-lines writer, which needs no tensorboard,
ThroughputMeter against JAX's on the same tick times, Trainer.train_epoch
writing each step's loss as JAX's train_epoch does (scalar and named
losses), a tiny train.s3dis run writing JAX train.py's tags at its steps,
--profile writing a trace on the CPU, the entry points' loader flags, and
fit closing a process pool behind train.s3dis's TimedLoader."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu.utils import profiler as jprofiler
from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.data.loader import DataLoader
from pvcnn_tpu_torch.data.s3dis import WindowStore
from pvcnn_tpu_torch.train import dml as tdml
from pvcnn_tpu_torch.train import kitti as tkitti
from pvcnn_tpu_torch.train import s3dis as ts3dis
from pvcnn_tpu_torch.train import shapenet as tshapenet
from pvcnn_tpu_torch.train.trainer import Trainer
from pvcnn_tpu_torch.utils import logging as tlogging
from pvcnn_tpu_torch.utils import profiler


@pytest.fixture
def no_tensorboard(monkeypatch):
    """torch.utils.tensorboard made to fail on import."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _scalars(save):
    with open(os.path.join(save, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_jsonl_writer_without_tensorboard(no_tensorboard, tmp_path):
    writer = tlogging.ScalarWriter(str(tmp_path / "run"))
    writer.add_scalar("loss/train", np.float32(0.5), 3)
    writer.add_scalar("acc/iou_test", 0.25, 0)
    writer.close()
    rows = _scalars(str(tmp_path / "run"))
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == \
        [("loss/train", 0.5, 3), ("acc/iou_test", 0.25, 0)]
    assert all(r["wall_time"] > 0 for r in rows)


def test_throughput_meter_matches_jax(monkeypatch):
    """Over the same tick times (perf_counter patched), 60 ticks through
    a window of 50: the same points/s after every tick."""
    clock = iter(np.cumsum(np.random.RandomState(0).uniform(0.01, 0.2, 120)))
    now = [0.0]
    monkeypatch.setattr("time.perf_counter", lambda: now[0])
    mine, theirs = profiler.ThroughputMeter(), jprofiler.ThroughputMeter()
    assert mine.points_per_sec() == theirs.points_per_sec() == 0.0
    for k in range(60):
        now[0] = float(next(clock))
        mine.tick(points=1000 + k)
        theirs.tick(points=1000 + k)
        assert mine.points_per_sec() == theirs.points_per_sec()
    assert mine.points_per_sec() > 0


class Recorder:
    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), int(step)))


class _Batches(list):
    epoch = 0


@pytest.mark.parametrize("named", [False, True])
def test_train_epoch_writes_what_jax_writes(named):
    """Two epochs of three stubbed steps: the port's train_epoch writes
    the (tag, value, step) rows JAX's Trainer.train_epoch writes, for a
    scalar loss (under log_tag) and for named losses (DML), and ticks the
    meter with batch x points of the first array."""
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import SGD
    from pvcnn_tpu.train.trainer import Trainer as JTrainer
    from pvcnn_tpu.train.trainer import TrainState

    values = np.random.RandomState(1).rand(6, 2).astype(np.float32)
    batches = _Batches((np.zeros((8, 5, 3), np.float32),
                        np.zeros((8, 5), np.int32)) for _ in range(3))

    def loss_of(k, array):
        if named:
            return {"loss/train_student": array(values[k, 1]),
                    "loss/train": array(values[k, 0])}
        return array(values[k, 0])

    tx, _ = SGD(1e-3)
    jt = JTrainer(None, None, tx, mesh=pmesh.make_mesh())
    jsteps = iter(range(6))
    jt._train_step = lambda state, batch, rng: (
        state, loss_of(next(jsteps), jnp.asarray))
    params = {"w": jnp.zeros(3)}
    state = TrainState(params=params, batch_stats={},
                       opt_state=tx.init(params))
    want, jmeter = Recorder(), jprofiler.ThroughputMeter()
    for _ in range(2):
        state, jmean = jt.train_epoch(state, batches, writer=want,
                                      throughput_meter=jmeter)

    trainer = Trainer(torch.nn.Linear(1, 1), None, None, "cpu")
    steps = iter(range(6))
    trainer.train_step = lambda x, y: loss_of(next(steps), torch.tensor)
    got, meter = Recorder(), profiler.ThroughputMeter()
    for epoch in range(2):
        mean = trainer.train_epoch(batches, epoch, writer=got,
                                   throughput_meter=meter)
    assert got.rows == want.rows
    assert len(got.rows) == 6 * (2 if named else 1)
    assert [p for _, p in meter._events] == [p for _, p in jmeter._events] \
        == [8 * 5] * 6
    if named:
        assert mean == pytest.approx(jmean, rel=1e-6)
    else:
        assert mean == pytest.approx(float(jmean), rel=1e-6)


def _s3dis_store(root, rooms, points=32, seed=0):
    """Room folders on disk and their window files in a WindowStore."""
    rng = np.random.RandomState(seed)
    store = WindowStore()
    for area, count in rooms.items():
        for r in range(count):
            scene = os.path.join(root, area, f"room_{r}")
            os.makedirs(scene)
            for offset in ("zero", "half"):
                w = 4
                store[os.path.join(scene, f"{offset}_0.h5")] = {
                    "data": rng.rand(w, points, 9).astype(np.float32),
                    "label_seg": rng.randint(0, 13, (w, points)),
                    "data_num": np.full(w, points),
                    "indices_split_to_full": np.tile(np.arange(points),
                                                     (w, 1))}
    return store


def test_s3dis_run_writes_jax_tags_at_jax_steps(tmp_path, monkeypatch,
                                                capsys):
    """Two epochs of 2 steps of train.s3dis (PointNet, width 0.125): the
    JSON-lines writer in the save path holds, as JAX train.py writes them,
    loss/train at steps 0-3 (the values fit's steps returned), and at each
    epoch perf/points_per_sec and every meter with the metric's _best;
    [points/sec] prints after each epoch. A process pool behind the
    TimedLoaders is closed when fit ends."""
    from pvcnn_tpu_torch.data import loader as tloader

    # the loader clamps num_workers to the host's cores; the pool runs here
    # on any host
    monkeypatch.setattr(tloader, "_cores", lambda: 8)
    root = str(tmp_path / "tree")
    store = _s3dis_store(root, {"Area_1": 2, "Area_5": 1})
    save = str(tmp_path / "run")
    made = []

    class Tracked(DataLoader):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(ts3dis, "DataLoader", Tracked)
    timings = {}
    meters = ts3dis.train(root, model="pointnet", width_multiplier=0.125,
                          batch_size=4, epochs=2, max_steps=2,
                          save_path=save, device="cpu", num_points=32,
                          opener=store, timings=timings, num_workers=2,
                          workers_mode="process")
    out = capsys.readouterr().out
    assert out.count("[points/sec] = ") == 2
    rows = _scalars(save)
    steps = [(r["tag"], r["step"]) for r in rows]
    per_epoch = ["perf/points_per_sec", "acc/iou_test", "acc/acc_test",
                 "acc/iou_test_best"]
    want = [("loss/train", s) for s in (0, 1)] + \
        [(t, 0) for t in per_epoch] + \
        [("loss/train", s) for s in (2, 3)] + [(t, 1) for t in per_epoch]
    assert steps == want
    last = {r["tag"]: r["value"] for r in rows if r["step"] == 1}
    for k, v in meters.items():
        assert last[k] == pytest.approx(v, abs=1e-12)
    assert len(made) == 2 and all(m._pool is None for m in made)
    assert all(m.workers_mode == "process" for m in made)
    assert timings["train_data"] > 0


def test_profile_writes_a_trace_on_the_cpu(tmp_path):
    """train.shapenet --profile (PointNet): a Chrome trace of steps 1-2 of
    the first epoch under <save-path>/profile, with the steps' host ops
    in it."""
    root = str(tmp_path / "tree")
    os.makedirs(root)
    tdata.write_synthetic(root, [(0, 80), (3, 70), (9, 60), (4, 90)])
    save = str(tmp_path / "run")
    tshapenet.main(["--root", root, "--model", "pointnet", "--width",
                    "0.125", "--batch-size", "2",
                    "--num-points", "64", "--max-steps", "3", "--epochs",
                    "1", "--device", "cpu", "--save-path", save,
                    "--num-workers", "0", "--profile"])
    traces = os.listdir(os.path.join(save, "profile"))
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(os.path.join(save, "profile", traces[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("addmm" in n or "conv" in n for n in names), sorted(names)


@pytest.mark.parametrize("module,mode", [(tshapenet, "process"),
                                         (tdml, "process"),
                                         (ts3dis, "thread"),
                                         (tkitti, "thread")])
def test_entry_points_take_the_loader_flags(monkeypatch, module, mode):
    """The CLI defaults are train()'s, the serial loader with prefetch 2
    and no trace (a pool, in process mode for ShapeNet and DML and thread
    mode else, only on --num-workers); the flags reach train()."""
    import inspect

    seen = []
    monkeypatch.setattr(module, "train", lambda *a, **k: seen.append(k))
    module.main(["--root", "r"])
    module.main(["--root", "r", "--num-workers", "3", "--workers-mode",
                 "thread", "--prefetch", "0", "--profile"])
    keys = ("num_workers", "workers_mode", "prefetch", "profile")
    assert [tuple(k[n] for n in keys) for k in seen] == \
        [(0, mode, 2, False), (3, "thread", 0, True)]
    monkeypatch.undo()
    defaults = inspect.signature(module.train).parameters
    assert tuple(defaults[n].default for n in keys) == \
        (0, "thread", 2, False)
