"""The port's training loop for deep mutual learning against the JAX
package: the per-step learning rate (scheduler_unit "iter") against JAX's
Trainer, named losses through train_epoch, and the entry point
`python -m pvcnn_tpu_torch.train.dml` with its checkpoints, on a tiny
synthetic ShapeNet tree on the CPU (tests/test_torch_dml.py holds
DMLTrainer's step to JAX's).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.models.shapenet import PVCNN
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.dml import main as dml_main
from pvcnn_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module (tests/test_torch_frustum.py: six
    workers' full thread pools oversubscribe the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class _Batches(list):
    """A list of batches with the `epoch` attribute train_epoch sets."""

    epoch = 0


def _recording_step(lrs, optimizer, loss):
    def step(inputs, targets):
        lrs.append(optimizer.param_groups[0]["lr"])
        return loss()
    return step


def test_iter_schedule_matches_jax_trainer():
    """Over two epochs of three steps, scheduler_unit "iter" sets the lr
    JAX's Trainer sets before every step (cosine over t_max = 6 steps),
    and "epoch" the lr of each epoch."""
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import SGD
    from pvcnn_tpu.train.optim import CosineAnnealingLR as JCosine
    from pvcnn_tpu.train.trainer import Trainer as JTrainer
    from pvcnn_tpu.train.trainer import TrainState

    batches = _Batches((np.zeros((8, 4), np.float32), np.zeros(8, np.int32))
                       for _ in range(3))
    for unit in ("iter", "epoch"):
        tx, _ = SGD(1e-3)
        jt = JTrainer(None, None, tx, mesh=pmesh.make_mesh())
        want = []

        def jstep(state, batch, rng):
            want.append(float(state.opt_state.hyperparams["learning_rate"]))
            return state, jnp.zeros(())

        jt._train_step = jstep
        params = {"w": jnp.zeros(3)}
        state = TrainState(params=params, batch_stats={},
                           opt_state=tx.init(params))
        jsched = JCosine(t_max=6 if unit == "iter" else 2).bind(1e-3)
        for _ in range(2):
            state, _ = jt.train_epoch(state, batches, scheduler=jsched,
                                      scheduler_unit=unit)

        w = torch.nn.Parameter(torch.zeros(3))
        opt = torch.optim.SGD([w], lr=1e-3)
        trainer = Trainer(torch.nn.Linear(1, 1), None, opt, "cpu")
        got = []
        trainer.train_step = _recording_step(got, opt, lambda: torch.zeros(()))
        sched = toptim.CosineAnnealingLR(
            t_max=6 if unit == "iter" else 2).bind(1e-3)
        for epoch in range(2):
            trainer.train_epoch(batches, epoch, sched, scheduler_unit=unit)
        np.testing.assert_allclose(got, want, rtol=1e-7, err_msg=unit)
        assert trainer.step_count == 6
        assert len(set(got)) == (6 if unit == "iter" else 2)


def test_train_epoch_returns_named_means():
    """A step's dict of losses comes back from train_epoch as the dict of
    their means over the epoch."""
    trainer = Trainer(torch.nn.Linear(1, 1), None,
                      torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))],
                                      lr=1.0), "cpu")
    values = iter([(1.0, 4.0), (2.0, 8.0), (6.0, 0.0)])

    def step(inputs, targets):
        a, b = next(values)
        return {"loss/train": torch.tensor(a),
                "loss/train_student": torch.tensor(b)}

    trainer.train_step = step
    batches = _Batches((np.zeros((1, 1), np.float32), np.zeros(1))
                       for _ in range(3))
    got = trainer.train_epoch(batches, 0)
    assert got == {"loss/train": 3.0, "loss/train_student": 4.0}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet_dml"))
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70),
                                 (9, 88)])
    return root


def test_dml_cli_writes_and_resumes_both_peers(tree, tmp_path, capsys):
    """Two epochs of at most 2 steps with an iter schedule write the
    teacher's and the student's checkpoints (latest, best, per epoch);
    the peers' weights differ (seeds 0 and 100); a third epoch resumes
    both at epoch 2; --no-dml trains one model with the plain Trainer."""
    save = str(tmp_path / "run")
    args = ["--root", tree, "--width", "0.125", "--batch-size", "2",
            "--num-points", "64", "--max-steps", "2", "--device", "cpu",
            "--save-path", save, "--scheduler-unit", "iter"]
    teacher, student = dml_main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    for text in ("training epoch 0/2", "training epoch 1/2", "[loss/train] =",
                 "[loss/train_student] =", "[acc/iou_test_student] ="):
        assert text in out, text
    for name in ("latest.pth.tar", "latest.pth.tar.student",
                 "latest/e0.pth.tar", "latest/e1.pth.tar", "best.pth.tar",
                 "best_student.pth.tar", "best/best.acc.iou_test.pth.tar"):
        assert os.path.exists(os.path.join(save, name)), name
    assert 0.0 <= teacher["acc/iou_test"] <= 1.0
    assert 0.0 <= student["acc/iou_test"] <= 1.0
    load = lambda name: torch.load(os.path.join(save, name),
                                   weights_only=True)
    t, s = load("latest.pth.tar"), load("latest.pth.tar.student")
    assert t["epoch"] == s["epoch"] == 1
    assert not all(torch.equal(t["model"][k], s["model"][k])
                   for k in t["model"])
    assert s["meters"]["acc/iou_test"] == student["acc/iou_test"]

    dml_main(args + ["--epochs", "3"])
    out = capsys.readouterr().out
    assert "loading checkpoint" in out and "training epoch 2/3" in out
    assert "training epoch 1/3" not in out
    t2, s2 = load("latest.pth.tar"), load("latest.pth.tar.student")
    assert t2["epoch"] == s2["epoch"] == 2
    assert not all(torch.equal(s["model"][k], s2["model"][k])
                   for k in s["model"])

    plain = str(tmp_path / "plain")
    teacher, student = dml_main(args[:-4] + ["--save-path", plain,
                                             "--epochs", "1", "--no-dml"])
    out = capsys.readouterr().out
    assert student == {} and "[loss/train_student]" not in out
    assert os.path.exists(os.path.join(plain, "latest.pth.tar"))
    assert not os.path.exists(os.path.join(plain, "latest.pth.tar.student"))


def test_finished_run_reports_both_saved_peers(tree, tmp_path):
    """A run whose checkpoints reach --epochs trains no more and scores
    both peers as saved: its meters equal those of the checkpoints'
    models, evaluated in the same order on the same test loader."""
    from pvcnn_tpu_torch.meters.shapenet import MeterShapeNet
    from pvcnn_tpu_torch.train.shapenet import make_loaders

    save = str(tmp_path / "run")
    args = ["--root", tree, "--width", "0.125", "--batch-size", "2",
            "--num-points", "64", "--max-steps", "1", "--device", "cpu",
            "--save-path", save, "--epochs", "1"]
    dml_main(args)
    teacher, student = dml_main(args)
    loader = make_loaders(tree, "pvcnn", 64, 2, 0)["test"]
    want = []
    for name in ("latest.pth.tar", "latest.pth.tar.student"):
        model = PVCNN(50, 16, 3, width_multiplier=0.125)
        model.load_state_dict(torch.load(os.path.join(save, name),
                                         weights_only=True)["model"])
        want.append(Trainer(model, None, None, "cpu").evaluate(
            loader, {"iou": MeterShapeNet()})["iou"])
    assert [teacher["acc/iou_test"], student["acc/iou_test"]] == want
