"""The port's PointNet models against the JAX package, and the ShapeNet
entry points' model choice: ShapeNet PointNet with and without its T-Net
and S3DIS PointNet (state_dict layout, weights carried across by
state_dict_from_jax, eval forward, one-step gradients, a three-step
trajectory against the JAX Trainer); the dataset's input-column flags; the
recipes of `--model` against the JAX configs; and the trainer and evaluator
CLIs with each new model, writing and resuming on a tiny synthetic tree.

Model size: width 0.25 (the T-Net keeps its fixed widths), B = 16, N =
128. The T-Net's head normalizes over the B clouds, and over few clouds
JAX's own fp32 gradients stray from its fp64 ones (rel-L2 8.4e-2 at B = 4,
2.1e-2 at 8, 1.9e-2 at 16), where the port's fp32 gradients lie 1.1e-3
from JAX's fp64 ones at B = 4 and its fp64 ones 2.5e-8. The checks and
their tolerances are tests/test_torch_pointnet2.py's.
"""

import os

import jax
import numpy as np
import pytest
import torch

from pvcnn_tpu.data.shapenet import ShapeNet
from pvcnn_tpu.models.s3dis import PointNet as JS3DISPointNet
from pvcnn_tpu.models.shapenet import PointNet as JPointNet
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.evaluate.shapenet.__main__ import main as eval_main
from pvcnn_tpu_torch.models import s3dis as ts3dis
from pvcnn_tpu_torch.models import shapenet as tshapenet
from pvcnn_tpu_torch.train import shapenet as tshapenet_train
from test_torch_pointnet2 import (Case, _shapenet_inputs, check_forward,
                                  check_gradients, check_layout,
                                  check_round_trip, check_trajectory,
                                  jax_forward, make_models)
from test_torch_pvcnn2 import windows
from test_torch_train import no_dropout  # noqa: F401 (fixture)
from torch_twins import TwinPointNetS3DIS, TwinPointNetShapeNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, WIDTH = 16, 128, 0.25
XYZ_ONE_HOT = [0, 1, 2] + list(range(6, 22))


def _shapenet_case(tnet: bool) -> Case:
    kw = dict(with_transformer=tnet, extra_feature_channels=0,
              width_multiplier=WIDTH)
    inputs = _shapenet_inputs(XYZ_ONE_HOT)
    return Case(JPointNet(num_classes=50, num_shapes=16, **kw),
                lambda: tshapenet.PointNet(50, 16, **kw),
                lambda: TwinPointNetShapeNet(50, 16, **kw),
                lambda: ci.pointnet_shapenet_mapping(tnet),
                lambda seed: inputs(seed, B, N), 50)


def _s3dis_case() -> Case:
    kw = dict(extra_feature_channels=6, width_multiplier=WIDTH)
    return Case(JS3DISPointNet(num_classes=13, **kw),
                lambda: ts3dis.PointNet(13, **kw),
                lambda: TwinPointNetS3DIS(13, **kw),
                ci.pointnet_s3dis_mapping,
                lambda seed: windows(seed, B, N), 13)


CASES = {"shapenet": _shapenet_case(False),
         "shapenet_tnet": _shapenet_case(True), "s3dis": _s3dis_case()}
FULL = {"shapenet": (lambda: tshapenet.PointNet(50, 16),
                     lambda: TwinPointNetShapeNet(50, 16)),
        "shapenet_tnet": (lambda: tshapenet.PointNet(
            50, 16, with_transformer=True), lambda: TwinPointNetShapeNet(
                50, 16, with_transformer=True)),
        "s3dis": (lambda: ts3dis.PointNet(13), lambda: TwinPointNetS3DIS(13))}


@pytest.fixture(scope="module", params=sorted(CASES))
def pointnet(request):
    """(case, flax variables, port model, jitted JAX forward), once per
    model."""
    case = CASES[request.param]
    variables, port = make_models(case)
    return case, variables, port, jax_forward(case)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("small", [True, False])
def test_state_dict_is_the_reference_layout(name, small):
    """Keys and shapes equal the twin's (the reference's), the T-Net's
    `features.{0,1,2}` and `tranformer.{0,1,3,4,6}` included; at full
    size every key but BatchNorm's step counters is named by the
    checkpoint-import mapping."""
    if small:
        case = CASES[name]
        check_layout(case.port(), case.twin())
    else:
        port, twin = FULL[name]
        check_layout(port(), twin(), CASES[name].mapping())


def test_tnet_applies_its_matrix_plus_identity():
    """x (W + I)^T per cloud: with the last layer zeroed the T-Net is the
    identity, and otherwise it is torch.bmm with the predicted matrix."""
    from pvcnn_tpu_torch.models.shapenet.pointnet import Transformer

    tnet = Transformer(3).eval()
    x = torch.randn(2, 50, 3)
    with torch.no_grad():
        tnet.tranformer[6].weight.zero_()
        tnet.tranformer[6].bias.zero_()
        assert torch.equal(tnet(x), x)
        tnet.tranformer[6].bias.copy_(torch.arange(9.0))
        w = torch.arange(9.0).view(3, 3) + torch.eye(3)
        torch.testing.assert_close(tnet(x), x @ w.t())


def test_weights_from_jax_round_trip(pointnet):
    case, variables, port, _ = pointnet
    check_round_trip(case, variables, port)


@pytest.mark.parametrize("seed", [2, 3])
def test_eval_forward_matches_jax(pointnet, seed):
    case, variables, port, forward = pointnet
    check_forward(case, variables, port, forward, seed)


def test_one_step_gradients_match_jax(pointnet, no_dropout):
    """check_gradients' criteria. Measured (fp32 loss rel, fp32 rel-L2,
    fp64 flipped, fp64 rel-L2, port fp64 rel-L2): ShapeNet 1.2e-7, 3.0e-3,
    0, 1.8e-6, 2.6e-8; with the T-Net 2.2e-6, 1.9e-2, 0, 1.5e-3, 2.5e-8;
    S3DIS 0, 4.2e-3, 0, 1.4e-6, 3.0e-8."""
    from pvcnn_tpu_torch.utils.weights import init_random_

    case, variables, _, _ = pointnet
    check_gradients(case, variables, init_random_(case.port(), 1), 5)


def test_three_step_trajectory_matches_jax_trainer(pointnet, no_dropout):
    from pvcnn_tpu_torch.utils.weights import init_random_

    case, variables, _, _ = pointnet
    check_trajectory(case, variables, init_random_(case.port(), 1))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet"))
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70),
                                 (9, 88)])
    return root


@pytest.mark.parametrize("with_normal", [True, False])
@pytest.mark.parametrize("with_one_hot", [True, False])
@pytest.mark.parametrize("split", ["train", "test"])
def test_dataset_columns_match_jax(tree, with_normal, with_one_hot, split):
    """The input columns (xyz, normals, one-hot shape id) of each flag
    setting, and the resampling and jitter draws, equal the JAX dataset's
    from np.random.seed(seed)."""
    flags = dict(with_normal=with_normal,
                 with_one_hot_shape_id=with_one_hot)
    mine = tdata.ShapeNetDataset(tree, 64, split, seed=4, **flags)
    theirs = ShapeNet(tree, 64, split=split, **flags)[split]
    assert mine.in_channels == 3 + 3 * with_normal + 16 * with_one_hot
    np.random.seed(4)
    for i in (0, 3, 3, 2):
        f_t, y_t = theirs[i]
        f_m, y_m = mine[i]
        assert f_m.shape == (64, mine.in_channels)
        np.testing.assert_array_equal(y_m, y_t)
        np.testing.assert_allclose(f_m, f_t, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,path", [
    ("pvcnn", "configs/shapenet/pvcnn/c1.py"),
    ("pointnet", "configs/shapenet/pointnet.py"),
    ("pointnet2ssg", "configs/shapenet/pointnet2ssg.py"),
    ("pointnet2msg", "configs/shapenet/pointnet2msg.py")])
def test_recipes_match_jax_configs(monkeypatch, name, path):
    """Each `--model` choice restates its JAX config: the input columns,
    the model's class and extra feature channels, the epochs and the
    schedule of the learning rate (lr 1e-3) over them."""
    from pvcnn_tpu.utils.config import configs

    monkeypatch.chdir(ROOT)
    saved = dict(configs)
    configs.clear()
    try:
        configs.update_from_file(path)
        flags = (configs.dataset.with_normal,
                 configs.dataset.with_one_hot_shape_id)
        jname = configs.model.func.__name__
        extra = configs.model.extra_feature_channels
        epochs, lr = configs.train.num_epochs, configs.train.optimizer.lr
        jsched = configs.train.scheduler().bind(lr)
    finally:
        configs.clear()
        configs.update(saved)
    spec = tshapenet.MODELS[name]
    assert (spec.with_normal, spec.with_one_hot_shape_id) == flags
    model = spec.build(50, 16, 0.125)
    assert type(model).__name__.lower() == jname.replace("_", "").lower()
    assert model.in_channels == 3 + extra
    default_epochs, schedule, _ = tshapenet_train.RECIPES[name]
    assert default_epochs == epochs and tshapenet_train.LR == lr
    mine = schedule(epochs).bind(lr)
    assert [mine(e) for e in range(epochs)] == \
        [jsched(e) for e in range(epochs)]


@pytest.mark.parametrize("name", ["pointnet", "pointnet2ssg",
                                  "pointnet2msg"])
def test_trainer_and_evaluator_clis_take_the_model(tree, tmp_path, capsys,
                                                   name):
    """`--model` of the trainer: one epoch of at most 2 steps writes latest,
    e0 and best, a second epoch resumes at epoch 1, and the checkpoint's
    model maps into JAX variables that give the JAX model the port's eval
    forward on its config's columns; `--model` of the evaluator scores the
    test split with that checkpoint."""
    save = str(tmp_path / "run")
    args = ["--root", tree, "--model", name, "--width", "0.125",
            "--batch-size", "2", "--num-points", "64", "--max-steps", "2",
            "--device", "cpu", "--save-path", save]
    meters = tshapenet_train.main(args + ["--epochs", "1"])
    assert "training epoch 0/1" in capsys.readouterr().out
    for f in ("latest.pth.tar", "latest/e0.pth.tar", "best.pth.tar"):
        assert os.path.exists(os.path.join(save, f)), f
    assert 0.0 <= meters["acc/iou_test"] <= 1.0
    ckpt = torch.load(os.path.join(save, "latest.pth.tar"),
                      weights_only=True)
    tshapenet_train.main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "loading checkpoint" in out and "training epoch 1/2" in out
    assert "training epoch 0/2" not in out

    spec = tshapenet.MODELS[name]
    port = spec.build(50, 16, 0.125)
    port.load_state_dict(ckpt["model"])
    columns = [0, 1, 2] + [3, 4, 5] * spec.with_normal + \
        list(range(6, 22)) * spec.with_one_hot_shape_id
    x = np.ascontiguousarray(_shapenet_inputs(columns)(5, 2, 64)[0])
    if name == "pointnet":
        jmodel = JPointNet(num_classes=50, num_shapes=16,
                           extra_feature_channels=0, width_multiplier=0.125)
        mapping = ci.pointnet_shapenet_mapping()
    else:
        from pvcnn_tpu.models.shapenet import pointnet2_msg, pointnet2_ssg

        msg = name == "pointnet2msg"
        jmodel = (pointnet2_msg if msg else pointnet2_ssg)(
            50, 16, width_multiplier=0.125)
        mapping = ci.pointnet2_shapenet_mapping(msg)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    params, stats = ci.import_state_dict(
        {k: t.numpy() for k, t in ckpt["model"].items()}, zeros["params"],
        zeros["batch_stats"], mapping)
    with jax.default_matmul_precision("float32"):
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)

    stats_path = str(tmp_path / "stats.npy")
    eval_main(["--root", tree, "--model", name, "--width", "0.125",
               "--checkpoint", os.path.join(save, "best.pth.tar"),
               "--num-points", "64", "--num-votes", "2", "--batch-size", "4",
               "--device", "cpu", "--stats-path", stats_path])
    stats = np.load(stats_path)
    assert stats.shape == (16, 2) and stats[:, 1].sum() == 5
    assert "meanIoU" in capsys.readouterr().out
