"""The port's ShapeNet PVCNN slice against the JAX package: the eval forward,
the weight transfer, and the voting evaluator.

Model size: width 0.25 and voxel_resolution_multiplier 0.5 (PVConv grids at
R = 16 and 8), B = 2, N = 256. JAX runs its CPU formulations at fp32 matmul
precision, as its evaluator does. Tolerance 1e-4, as tests/test_model_parity.py.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pvcnn_tpu.data.shapenet import ShapeNet
from pvcnn_tpu.evaluate.shapenet import eval as jeval
from pvcnn_tpu.meters.shapenet import MeterShapeNet
from pvcnn_tpu.models.shapenet import PVCNN as JPVCNN
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.evaluate.shapenet import eval as teval
from pvcnn_tpu_torch.evaluate.shapenet.__main__ import main as eval_main
from pvcnn_tpu_torch.evaluate.votes import vote_reduce_max
from pvcnn_tpu_torch.models.shapenet import PVCNN
from pvcnn_tpu_torch.train.predict import predict
from pvcnn_tpu_torch.utils.weights import (init_random_,
                                           load_reference_checkpoint,
                                           state_dict_from_jax)

B, N = 2, 256
SIZE = dict(width_multiplier=0.25, voxel_resolution_multiplier=0.5)


def _inputs(seed, b=B, n=N):
    """[b, n, 22]: unit-normalized xyz, unit normals, one-hot shape id."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(b, n, 3) * [1.0, 0.6, 0.3]
    xyz -= xyz.mean(axis=1, keepdims=True)
    xyz /= np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]
    normals = rng.randn(b, n, 3)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    one_hot = np.zeros((b, n, 16))
    one_hot[np.arange(b), :, rng.randint(0, 16, b)] = 1.0
    return np.concatenate([xyz, normals, one_hot], -1).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """(flax model, randomized flax variables, port model holding them)."""
    jmodel = JPVCNN(num_classes=50, num_shapes=16, extra_feature_channels=3,
                    **SIZE)
    v = jmodel.init(jax.random.PRNGKey(0), _inputs(0), train=False)
    rng = np.random.RandomState(1)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return np.asarray(x, np.float32)

    variables = {k: jax.tree_util.tree_map_with_path(leaf, v[k])
                 for k in ("params", "batch_stats")}
    port = PVCNN(50, 16, 3, **SIZE)
    port.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"],
        ci.pvcnn_shapenet_mapping(), port.state_dict()))
    return jmodel, variables, port.eval()


def _jax_probs(jmodel, variables):
    @jax.jit
    def fn(x):
        with jax.default_matmul_precision("float32"):
            return jax.nn.softmax(jmodel.apply(variables, x, train=False), -1)
    return fn


@pytest.mark.parametrize("seed", [2, 3])
def test_slice_forward_matches_jax(models, seed):
    jmodel, variables, port = models
    x = _inputs(seed)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jmodel.apply(variables, x, train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (B, N, 50)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    probs = predict(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(probs, np.asarray(_jax_probs(jmodel,
                                                            variables)(x)),
                               rtol=1e-4, atol=1e-5)


def test_weights_round_trip(models):
    """JAX variables -> state_dict_from_jax -> port state_dict ->
    checkpoint_import.import_state_dict gives back exactly the originals."""
    _, variables, port = models
    mapping = ci.pvcnn_shapenet_mapping()
    state = {k: t.numpy() for k, t in port.state_dict().items()}
    params, stats = ci.import_state_dict(state, variables["params"],
                                         variables["batch_stats"], mapping)
    for got, want in ((params, variables["params"]),
                      (stats, variables["batch_stats"])):
        got_leaves = jax.tree_util.tree_leaves_with_path(got)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_state_dict_keys_are_the_mapping(models):
    """The port's module names are the reference's: every state_dict key
    (but BatchNorm's step counters) is named by pvcnn_shapenet_mapping."""
    port = models[2]
    named = set()
    sd = port.state_dict()
    for prefix, _, kind in ci.pvcnn_shapenet_mapping():
        leaves = {"dense": ("weight", "bias"), "conv3d": ("weight", "bias"),
                  "bn": ("weight", "bias", "running_mean", "running_var")}
        named |= {f"{prefix}.{leaf}" for leaf in leaves[kind]
                  if f"{prefix}.{leaf}" in sd}
    assert named == {k for k in sd if not k.endswith("num_batches_tracked")}


def test_reference_checkpoint_loads(models, tmp_path):
    """A reference .pth.tar (DataParallel `module.` keys under `model`)
    loads by name into a fresh port model."""
    port = models[2]
    path = str(tmp_path / "e.pth.tar")
    torch.save({"model": {f"module.{k}": v for k, v in
                          port.state_dict().items()}, "epoch": 1}, path)
    fresh = load_reference_checkpoint(PVCNN(50, 16, 3, **SIZE), path)
    want = port.state_dict()
    assert all(torch.equal(t, want[k]) for k, t in fresh.state_dict().items())


def test_init_random_is_seeded():
    a = init_random_(PVCNN(50, 16, 3, **SIZE), 7).state_dict()
    b = init_random_(PVCNN(50, 16, 3, **SIZE), 7).state_dict()
    c = init_random_(PVCNN(50, 16, 3, **SIZE), 8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    key = "point_features.0.voxel_layers.1.running_var"
    assert not torch.equal(a[key], c[key])
    assert not torch.equal(a[key], torch.ones_like(a[key]))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet"))
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70)])
    return root


def test_evaluator_matches_jax_votes(models, tree):
    """The port's evaluate == the same voting fed the JAX model's
    probabilities."""
    jmodel, variables, port = models
    kw = dict(num_points=64, num_votes=3, batch_size=4, seed=0)
    got = teval.evaluate(tree, model=port, device="cpu", **kw)
    jfn = _jax_probs(jmodel, variables)
    want = teval.evaluate_with(lambda x: np.asarray(jfn(x)), tree, **kw)
    assert got.shape == (16, 2) and got[:, 1].sum() == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_evaluator_cli(tree, tmp_path, capsys):
    stats_path = str(tmp_path / "stats.npy")
    eval_main(["--root", tree, "--width", "0.125", "--num-points", "32",
               "--num-votes", "2", "--batch-size", "4", "--device", "cpu",
               "--stats-path", stats_path])
    stats = np.load(stats_path)
    assert stats.shape == (16, 2) and stats[:, 1].sum() == 4
    assert "meanIoU" in capsys.readouterr().out


@pytest.mark.parametrize("seed", range(3))
def test_vote_reduction_matches_jax(seed):
    """First-vote-wins max reduction and the IoU update, against the JAX
    evaluator's (native) code, with many tied confidences."""
    rng = np.random.RandomState(seed)
    points, votes = 50, 400
    conf = rng.randint(0, 5, votes).astype(np.float32) / 4
    pred = rng.randint(0, 4, votes).astype(np.int64)
    idx = rng.randint(0, points, votes).astype(np.int64)
    start = (rng.rand(points) * 0.5).astype(np.float32)
    outs = []
    for fn in (vote_reduce_max,
               jeval.update_shape_predictions):
        c, p = start.copy(), np.full(points, -1, np.int64)
        fn(conf, pred, idx, c, p)
        outs.append((c, p))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    gt = rng.randint(0, 4, points)
    stats = [np.zeros((16, 2)), np.zeros((16, 2))]
    teval.update_stats(stats[0], gt, outs[0][1], 3, 0, 4)
    jeval.update_stats(stats[1], gt, outs[1][1], 3, 0, 4)
    np.testing.assert_array_equal(stats[0], stats[1])


def test_part_ranges_and_files_match_jax(tree):
    assert teval.part_class_ranges() == \
        MeterShapeNet().part_class_to_shape_part_classes
    for split in ("train", "test"):
        want = ShapeNet(tree, 64, split=split)[split].file_paths
        assert tdata.file_paths(tree, split) == want
    pts = np.random.RandomState(0).randn(20, 3).astype(np.float32)
    np.testing.assert_array_equal(
        tdata.normalize_point_cloud(pts),
        ShapeNet(tree, 64, split="test")["test"].normalize_point_cloud(pts))
