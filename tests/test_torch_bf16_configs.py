"""--configs.model.dtype=bfloat16 through the config-driven entry points
(train/cli.py's prepare and run, the evaluators) for the models whose bf16
activations are ported beside ShapeNet PVCNN (tests/test_torch_bf16_model.py):
S3DIS PVCNN2 and PVCNN over a WindowStore of synthetic rooms, ShapeNet
PointNet++ SSG and MSG over a synthetic tree. Each config builds its model
with bf16 activations, trains a few steps on the CPU at width 0.125
(PVCNN2 0.25) with finite meters, and its evaluator scores the run's best checkpoint with
finite stats.
"""

import os

import numpy as np
import pytest
import torch

from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.data.prepare_s3dis import room_windows, synthetic_room
from pvcnn_tpu_torch.data.s3dis import WindowStore
from pvcnn_tpu_torch.evaluate.__main__ import main as evaluate_main
from pvcnn_tpu_torch.train.cli import prepare, run

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pvcnn_tpu_torch", "configs")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads (tests/test_torch_cli.py: six workers' full thread
    pools oversubscribe the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    """A synthetic room in Area_1 (train) and one in Area_5 (test),
    prepared into windows of at most 256 points in a WindowStore."""
    root = str(tmp_path_factory.mktemp("s3dis"))
    rng = np.random.RandomState(4)
    store = WindowStore()
    for area in ("Area_1", "Area_5"):
        scene = os.path.join(root, area, "office_1")
        os.makedirs(scene)
        xyzrgb, labels = synthetic_room(rng, 1200)
        np.save(os.path.join(scene, "label.npy"), labels)
        for offset, k, arrays in room_windows(xyzrgb, labels, 0, rng,
                                              max_num_points=256,
                                              block_size=3.0):
            store[os.path.join(scene, f"{offset}_{k}.h5")] = arrays
    return root, store


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet"))
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70)])
    return root


# config -> (points a cloud, width): PVCNN2's first level samples 1,024
# centers (PointNet++'s 512), and its SE blocks need width 0.25 (at 0.125
# the first one's 4 channels reduce to 0)
S3DIS = {"s3dis/pvcnn2/area5/c1.py": (1024, 0.25),
         "s3dis/pvcnn/area5/c1.py": (256, 0.125)}
SHAPENET = ("shapenet/pointnet2ssg.py", "shapenet/pointnet2msg.py")


def _bf16_model(configs):
    assert configs.model.dtype == "bfloat16"
    model = configs.model()
    assert model.act_dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}


@pytest.mark.parametrize("name", sorted(S3DIS))
def test_s3dis_config_runs_bf16(rooms, tmp_path, name):
    root, store = rooms
    points, width = S3DIS[name]
    args = [os.path.join(CONFIGS, name), "--devices", "cpu",
            "--configs.model.dtype=bfloat16",
            f"--configs.model.width_multiplier={width}",
            f"--configs.dataset.root={root}",
            f"--configs.dataset.num_points={points}",
            "--configs.train.batch_size=2", "--configs.train.num_epochs=1",
            "--configs.train.max_steps=2", "--configs.evaluate.batch_size=4",
            f"--configs.train.save_path={tmp_path / 'run'}"]
    configs = prepare(args)
    _bf16_model(configs)
    configs.dataset.opener = store
    meters = run(configs)
    assert all(np.isfinite(v) for v in meters.values()), meters
    configs = prepare(args + ["--evaluate"])
    configs.dataset.opener = store
    stats = configs.evaluate.fn(configs)
    assert np.isfinite(stats).all() and stats[1].sum() > 0


@pytest.mark.parametrize("name", SHAPENET)
def test_shapenet_config_runs_bf16(tree, tmp_path, name):
    args = [os.path.join(CONFIGS, name), "--devices", "cpu",
            "--configs.model.dtype=bfloat16",
            "--configs.model.width_multiplier=0.125",
            f"--configs.dataset.root={tree}",
            "--configs.dataset.num_points=512",
            "--configs.train.batch_size=2", "--configs.train.num_epochs=1",
            f"--configs.train.save_path={tmp_path / 'run'}"]
    configs = prepare(args)
    _bf16_model(configs)
    meters = run(configs)
    assert all(np.isfinite(v) for v in meters.values()), meters
    stats = evaluate_main(args + ["--configs.evaluate.num_votes=1"])
    assert np.isfinite(stats).all() and stats[:, 1].sum() > 0
