"""The port's S3DIS scene evaluator, vote reduction and training entry point
against the JAX package's: evaluate/votes.py against
pvcnn_tpu.native.vote_reduce_max on both its paths; evaluate/s3dis/eval.py
against JAX's evaluate(configs) on one prepared tree (S3DIS PVCNN at width
0.125 and voxel resolution multiplier 0.25, sub-clouds of 128 points,
windows of at most 512; the weights carried to JAX as a reference
.pth.tar): stats exactly equal, each point's confidence within 1e-5, the
printed table equal, the stats cache and the missing checkpoint; the
MODELS recipes against configs/s3dis; the lr over two epochs of
train.s3dis against JAX's schedules; and one tiny epoch of train.s3dis
(checkpoints, resume) scored by `python -m pvcnn_tpu_torch.evaluate.s3dis`.
"""

import os

import jax
import numpy as np
import pytest
import torch

from pvcnn_tpu import native
from pvcnn_tpu.data.s3dis import S3DIS as JS3DIS
from pvcnn_tpu.evaluate.s3dis import eval as jeval
from pvcnn_tpu.models.s3dis import PVCNN as JPVCNN
from pvcnn_tpu.utils.common import get_save_path
from pvcnn_tpu_torch.data import prepare_s3dis as tprep
from pvcnn_tpu_torch.evaluate.s3dis import eval as teval
from pvcnn_tpu_torch.evaluate.s3dis.__main__ import main as eval_main
from pvcnn_tpu_torch.evaluate.votes import vote_reduce_max
from pvcnn_tpu_torch.models import s3dis as tmodels
from pvcnn_tpu_torch.train import s3dis as ttrain
from pvcnn_tpu_torch.train.trainer import Trainer
from pvcnn_tpu_torch.utils.weights import init_random_
from test_torch_s3dis_data import few_threads, write_raw  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = dict(width_multiplier=0.125, voxel_resolution_multiplier=0.25)
POINTS, MAX_POINTS = 128, 512
TABLE = ("classes:", "positiv:", "truepos:", "clssiou:", "meanAcc:",
         "meanIoU:")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A prepared tree of one train room and two Area_5 rooms, windows of
    at most 512 points."""
    raw = str(tmp_path_factory.mktemp("s3dis_raw"))
    root = str(tmp_path_factory.mktemp("s3dis"))
    write_raw(raw, np.random.RandomState(7), {"Area_1": 1, "Area_5": 2})
    tprep.prepare_labels(raw, root)
    tprep.prepare_windows(root, max_num_points=MAX_POINTS, grid_size=0.1,
                          rng=np.random.RandomState(0))
    return root


def _votes(rng, points, votes, call):
    """Votes on `points` points with many exact ties: confidences in
    quarters, point indices repeated; a vote's prediction is a function of
    its point, confidence and `call`."""
    conf = rng.randint(0, 5, votes).astype(np.float32) / 4
    idx = rng.randint(0, points, votes).astype(np.int64)
    pred = (idx * 7 + (conf * 4).astype(np.int64) * 3 + call) % 13
    return conf, pred, idx


def _reduce(fn, calls, points):
    conf, pred = np.zeros(points, np.float32), np.full(points, -1, np.int64)
    for c, p, i in calls:
        fn(c, p, i, conf, pred)
    return conf, pred


@pytest.mark.parametrize("seed", range(3))
def test_vote_reduce_max_matches_native(seed):
    """Three calls into one scene, against the JAX package's C++ path (the
    reference's loop: the first of equal votes wins, within a call and
    across calls), with tied votes of one point that disagree."""
    assert native.available()
    rng = np.random.RandomState(seed)
    calls = []
    for call in range(3):
        conf, _, idx = _votes(rng, 60, 500, call)
        calls.append((conf, rng.randint(0, 13, 500).astype(np.int64), idx))
    got = _reduce(vote_reduce_max, calls, 60)
    want = _reduce(native.vote_reduce_max, calls, 60)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("seed", range(3))
def test_vote_reduce_max_matches_numpy_path(seed, monkeypatch):
    """The same against the JAX package's numpy path (pvcnn_tpu.native._lib
    patched to None). That path lets the last of a call's equal votes for
    a point win, where the reference and the C++ path keep the first, so
    a call's tied votes of one point agree here; ties across calls (a vote
    as confident as the kept one does not replace it) are in both."""
    monkeypatch.setattr(native, "_lib", lambda: None)
    rng = np.random.RandomState(seed)
    calls = [_votes(rng, 60, 500, call) for call in range(3)]
    got = _reduce(vote_reduce_max, calls, 60)
    want = _reduce(native.vote_reduce_max, calls, 60)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _table(text):
    return [line for line in text.splitlines() if line.startswith(TABLE)]


@pytest.fixture
def jax_init_from_shapes(monkeypatch):
    """JAX's Trainer.init_state with zeros of the variables' shapes
    (jax.eval_shape: the model's eager init takes 25 s here); the evaluator
    then sets every leaf from the checkpoint."""
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.trainer import Trainer as JTrainer
    from pvcnn_tpu.train.trainer import TrainState

    def init_state(self, example_inputs):
        shapes = jax.eval_shape(lambda x: self.model.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)}, x, train=False),
            example_inputs)
        variables = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
        state = TrainState(params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=self.tx.init(variables["params"]))
        return jax.device_put(state, pmesh.replicated(self.mesh))

    monkeypatch.setattr(JTrainer, "init_state", init_state)


@pytest.fixture(scope="module")
def port_model():
    return init_random_(tmodels.PVCNN(13, 6, **SIZE), 2)


def test_evaluator_matches_jax(tree, port_model, jax_init_from_shapes,
                               tmp_path, monkeypatch, capsys):
    """JAX's evaluate(configs) and the port's evaluate on the same tree and
    seed, the same weights (a .pth.tar JAX's load_eval_checkpoint reads):
    stats exactly equal, every point's confidence within 1e-5 and its
    prediction equal, the printed tables equal; a second call is answered
    by the stats cache."""
    from pvcnn_tpu.utils.config import Config

    ckpt = str(tmp_path / "best.pth.tar")
    torch.save({"model": port_model.state_dict()}, ckpt)
    jmodel = JPVCNN(num_classes=13, extra_feature_channels=6, **SIZE)
    configs = Config()
    configs.seed = 3
    configs.data = Config(num_classes=13)
    configs.dataset = Config(JS3DIS, root=tree, num_points=POINTS,
                             with_normalized_coords=True, holdout_area=5)
    configs.model = Config(lambda: jmodel)
    configs.evaluate = Config(num_votes=1, batch_size=10,
                              dataset=Config(split="test"),
                              best_checkpoint_path=ckpt,
                              stats_path=str(tmp_path / "jax.eval.npy"))
    theirs = []
    update = jeval.update_scene_predictions

    def recording(conf, pred, idx, scene_conf, scene_pred):
        if not theirs or theirs[-1][0] is not scene_conf:
            theirs.append((scene_conf, scene_pred))
        update(conf, pred, idx, scene_conf, scene_pred)

    monkeypatch.setattr(jeval, "update_scene_predictions", recording)
    want = jeval.evaluate(configs)
    want_table = _table(capsys.readouterr().out)

    mine = {}
    stats_path = str(tmp_path / "port.eval.npy")
    got = teval.evaluate(tree, port_model, num_points=POINTS, num_votes=1,
                         batch_size=10, stats_path=stats_path, device="cpu",
                         seed=3, scene_outputs=mine)
    assert _table(capsys.readouterr().out) == want_table
    assert got.shape == want.shape == (3, 13, 2)
    np.testing.assert_array_equal(got, want)
    assert got[1].sum() > 0
    assert len(mine) == len(theirs) == 2
    for (conf, pred), (jconf, jpred) in zip(mine.values(), theirs):
        np.testing.assert_array_equal(pred, jpred)
        np.testing.assert_allclose(conf, jconf, rtol=0, atol=1e-5)
    # the cache answers before any checkpoint is looked for
    again = teval.evaluate(tree, model_name="pvcnn",
                           checkpoint=str(tmp_path / "absent.pth.tar"),
                           stats_path=stats_path, device="cpu")
    np.testing.assert_array_equal(again, got)
    assert _table(capsys.readouterr().out) == want_table


def test_evaluator_missing_checkpoint(tree, tmp_path, capsys):
    """Without a checkpoint (or cached stats) the evaluator prints JAX's
    message and returns None."""
    path = str(tmp_path / "best.pth.tar")
    assert teval.evaluate(tree, model_name="pvcnn", checkpoint=path,
                          device="cpu") is None
    assert capsys.readouterr().out.strip() == f"==> no checkpoint at {path}"


CONFIGS = {"pvcnn": ("configs/s3dis/pvcnn/area5/c1.py",
                     "configs/s3dis/pvcnn/area5/c0p25.py",
                     "configs/s3dis/pvcnn/area5/c0p125.py"),
           "pvcnn2": ("configs/s3dis/pvcnn2/area5/c1.py",
                      "configs/s3dis/pvcnn2/area5/c0p5.py"),
           "pointnet": ("configs/s3dis/pointnet/area5.py",)}


def _read_config(path):
    """The JAX config at `path`: its values that the port's recipe holds."""
    from pvcnn_tpu.utils.config import configs

    saved = dict(configs)
    configs.clear()
    try:
        configs.update_from_file(path)
        meters = {name: (c.func.__name__, c.metric, c.num_classes)
                  for name, c in configs.train.meters.items()}
        lr = configs.train.optimizer.lr
        schedule = configs.train.scheduler().bind(lr)
        return dict(
            model=configs.model.func.__name__,
            width=configs.model.get("width_multiplier", 1.0),
            classes=(configs.data.num_classes, configs.model.num_classes),
            extra=configs.model.extra_feature_channels,
            points=configs.dataset.num_points,
            holdout=configs.dataset.holdout_area,
            normalized=configs.dataset.with_normalized_coords,
            epochs=configs.train.num_epochs,
            batch=configs.train.batch_size, lr=lr,
            weight_decay=configs.train.optimizer.get("weight_decay", 0.0),
            lrs=[schedule(e) for e in range(configs.train.num_epochs)],
            metric=configs.train.metric, meters=meters,
            votes=(configs.evaluate.num_votes, configs.evaluate.batch_size),
            save_path=get_save_path(path, prefix="runs"))
    finally:
        configs.clear()
        configs.update(saved)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_recipes_match_jax_configs(monkeypatch, name):
    """Each MODELS recipe restates its JAX configs: the model and its
    widths, classes, extra channels, points, holdout area, epochs, batch,
    lr, weight decay, the lr of every epoch, the meters and the metric,
    the evaluator's votes and batch, and each config's save path."""
    monkeypatch.chdir(ROOT)
    spec = tmodels.MODELS[name]
    readings = [_read_config(path) for path in CONFIGS[name]]
    first = readings[0]
    model = spec.build(0.25)
    assert type(model).__name__ == first["model"]
    assert model.in_channels == 3 + first["extra"]
    assert first["classes"] == (tmodels.NUM_CLASSES,) * 2
    assert first["extra"] == tmodels.EXTRA_FEATURE_CHANNELS
    assert first["points"] == spec.num_points
    assert first["holdout"] == tmodels.HOLDOUT_AREA
    assert first["normalized"] is True
    assert (first["epochs"], first["batch"], first["lr"]) == \
        (tmodels.EPOCHS, tmodels.BATCH_SIZE, tmodels.LR)
    assert first["weight_decay"] == spec.weight_decay
    mine = spec.scheduler().bind(tmodels.LR)
    assert [mine(e) for e in range(tmodels.EPOCHS)] == first["lrs"]
    assert first["metric"] == ttrain.METRIC
    assert first["meters"] == {
        k.replace("test", "{}"): (type(m).__name__, m.metric, m.num_classes)
        for k, m in ttrain.meters().items()}
    assert first["votes"] == (1, 10)
    widths = tuple(r["width"] for r in readings)
    assert spec.widths == (widths if name != "pointnet" else ())
    for reading in readings:
        assert tmodels.save_path(name, reading["width"]) == \
            reading["save_path"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lr_over_two_epochs_matches_jax(tree, tmp_path, monkeypatch, name):
    """train.s3dis sets each epoch's lr to the JAX config's schedule's
    (the steps and scoring stubbed: the schedule alone)."""
    monkeypatch.chdir(ROOT)
    want = _read_config(CONFIGS[name][0])["lrs"][:2]
    got = []
    monkeypatch.setattr(Trainer, "set_learning_rate",
                        lambda self, lr: got.append(lr))
    monkeypatch.setattr(Trainer, "train_step",
                        lambda self, x, y: torch.zeros(()))
    monkeypatch.setattr(Trainer, "evaluate", lambda self, loader, meters: {
        k: 0.5 for k in meters})
    ttrain.main(["--root", tree, "--model", name, "--width", "0.5",
                 "--num-points", str(POINTS), "--epochs", "2",
                 "--max-steps", "1", "--device", "cpu",
                 "--save-path", str(tmp_path / "run")])
    assert got == want


def test_train_cli_then_evaluator_cli(tree, tmp_path, capsys):
    """One tiny epoch of train.s3dis (PVCNN at width 0.125, 2 steps at
    batch 4): the checkpoint layout and meters in [0, 1]; a second call
    resumes and only scores; the evaluator's entry point scores its
    best.pth.tar and keeps the stats beside it."""
    save = str(tmp_path / "run")
    args = ["--root", tree, "--model", "pvcnn", "--width", "0.125",
            "--num-points", str(POINTS), "--epochs", "1", "--max-steps", "2",
            "--batch-size", "4", "--device", "cpu", "--save-path", save]
    meters = ttrain.main(args)
    for name in ("latest.pth.tar", "latest/e0.pth.tar", "best.pth.tar",
                 "best/best.acc.iou_test.pth.tar"):
        assert os.path.exists(os.path.join(save, name)), name
    assert 0.0 <= meters["acc/iou_test"] <= 1.0
    assert 0.0 <= meters["acc/acc_test"] <= 1.0
    capsys.readouterr()
    again = ttrain.main(args)
    out = capsys.readouterr().out
    assert "==> loading checkpoint" in out and "training epoch" not in out
    assert set(again) == {"acc/iou_test", "acc/acc_test"}
    stats = eval_main(["--root", tree, "--model", "pvcnn", "--width",
                       "0.125", "--checkpoint",
                       os.path.join(save, "best.pth.tar"), "--num-points",
                       str(POINTS), "--device", "cpu"])
    assert stats.shape == (3, 13, 2) and stats[1].sum() > 0
    assert stats[1].sum() <= stats[0].sum()
    np.testing.assert_array_equal(
        np.load(os.path.join(save, "best.eval.npy")), stats)
    assert "meanIoU" in capsys.readouterr().out
