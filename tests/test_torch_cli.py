"""The config-driven entry points on the CPU: `prepare` against the JAX
package's train.prepare on the same command lines; `python -m
pvcnn_tpu_torch.train` (and `run` over an in-memory S3DIS store set
between `prepare` and `run`), `train_dml` and `python -m
pvcnn_tpu_torch.evaluate` against the per-dataset entry points with the
same model, width, seed and loader settings: the same scalars (every
tag but the timing's) and bitwise-equal checkpoint tensors (model and
optimizer), and the same evaluation results, for a ShapeNet, an S3DIS
and a Frustum config; the parity tool's dry run; the device default.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.data.kitti.frustum import write_synthetic_root
from pvcnn_tpu_torch.data.prepare_s3dis import room_windows, synthetic_room
from pvcnn_tpu_torch.data.s3dis import WindowStore
from pvcnn_tpu_torch.evaluate.__main__ import main as evaluate_main
from pvcnn_tpu_torch.evaluate.kitti.frustum import eval as kitti_eval
from pvcnn_tpu_torch.evaluate.s3dis import eval as s3dis_eval
from pvcnn_tpu_torch.evaluate.shapenet.__main__ import \
    main as shapenet_eval_main
from pvcnn_tpu_torch.tools import parity
from pvcnn_tpu_torch.train import dml, kitti, s3dis, shapenet
from pvcnn_tpu_torch.train.__main__ import main as train_main
from pvcnn_tpu_torch.train.cli import prepare, run
from pvcnn_tpu_torch.train_dml import main as train_dml_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "pvcnn_tpu_torch", "configs")
SHAPENET = os.path.join(CONFIGS, "shapenet", "pvcnn", "c1.py")
S3DIS_C = os.path.join(CONFIGS, "s3dis", "pvcnn", "area5", "c0p125.py")
KITTI_C = os.path.join(CONFIGS, "kitti", "frustum", "pvcnne.py")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module (tests/test_torch_frustum.py: six
    workers' full thread pools oversubscribe the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A ShapeNet tree of 5 shapes: 10 training items, 5 test items."""
    root = str(tmp_path_factory.mktemp("shapenet"))
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70),
                                 (9, 88)])
    return root


@pytest.fixture(scope="module")
def rooms(tmp_path_factory):
    """One synthetic room in Area_1 (train) and one in Area_5 (test),
    prepared into windows of at most 256 points of 3 m blocks (19 a room)
    in a WindowStore."""
    root = str(tmp_path_factory.mktemp("s3dis"))
    rng = np.random.RandomState(3)
    store = WindowStore()
    for area in ("Area_1", "Area_5"):
        scene = os.path.join(root, area, "office_1")
        os.makedirs(scene)
        xyzrgb, labels = synthetic_room(rng, 1500)
        np.save(os.path.join(scene, "label.npy"), labels)
        for offset, k, arrays in room_windows(xyzrgb, labels, 0, rng,
                                              max_num_points=256,
                                              block_size=3.0):
            store[os.path.join(scene, f"{offset}_{k}.h5")] = arrays
    return root, store


@pytest.fixture(scope="module")
def frustums(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    write_synthetic_root(root, np.random.RandomState(0), 8)
    return root


def _scalars(save: str):
    """(tag, step, value) of every scalar but the points/s timings."""
    with open(os.path.join(save, "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["tag"], r["step"], r["value"]) for r in rows
            if not r["tag"].startswith("perf/")]


def _tensors(tree_):
    """Every tensor of a nested checkpoint, by its path."""
    if isinstance(tree_, torch.Tensor):
        return {"": tree_}
    if isinstance(tree_, dict):
        items = tree_.items()
    elif isinstance(tree_, (list, tuple)):
        items = enumerate(tree_)
    else:
        return {}
    return {f"{k}/{p}": t for k, v in items for p, t in _tensors(v).items()}


def _same_runs(got: str, want: str, names=("latest.pth.tar",)):
    """The two save paths hold the same scalars and, in each named
    checkpoint, the same epoch, meters and bitwise-equal tensors."""
    assert _scalars(got) == _scalars(want)
    assert any(tag.startswith("loss/") for tag, _, _ in _scalars(got))
    for name in names:
        a, b = (torch.load(os.path.join(d, name), weights_only=True)
                for d in (got, want))
        assert a["epoch"] == b["epoch"] and a["meters"] == b["meters"]
        ta, tb = _tensors({"model": a["model"], "opt": a["optimizer"]}), \
            _tensors({"model": b["model"], "opt": b["optimizer"]})
        assert sorted(ta) == sorted(tb) and len(ta) > 10
        for k in ta:
            assert torch.equal(ta[k], tb[k]), (name, k)


def _jax_prepare(monkeypatch, tmp_path, argv):
    """The JAX package's train.prepare() on `argv`, from a directory whose
    `configs` is the JAX tree (its checkpoint folders land there)."""
    from pvcnn_tpu.utils.config import configs

    os.symlink(os.path.join(ROOT, "configs"), tmp_path / "configs")
    monkeypatch.chdir(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "jax_train_entry", os.path.join(ROOT, "train.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    saved = dict(configs)
    configs.clear()
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    try:
        c = module.prepare()
        return {k: c[k] for k in ("train", "evaluate", "dataset")}
    finally:
        configs.clear()
        configs.update(saved)


@pytest.mark.parametrize("leaf,extra", [
    ("shapenet/pvcnn/c1.py", []),
    ("kitti/frustum/pvcnne.py", ["--configs.train.num_epochs=3"]),
    ("s3dis/pvcnn2/area5/c0p5.py", ["--evaluate"]),
    ("shapenet/pointnet.py",
     ["--evaluate", "--configs.evaluate.best_checkpoint_path=x/r.pth.tar"]),
    ("kitti/frustum/pointnet.py", ["--evaluate"])])
def test_prepare_paths_match_jax(monkeypatch, tmp_path, leaf, extra):
    """The save, checkpoint, metric and evaluation paths and the merged
    evaluation dataset of the JAX prepare(), with .pth.tar for .ckpt."""
    want = _jax_prepare(monkeypatch, tmp_path,
                        [f"configs/{leaf}", "--devices", "cpu", *extra])
    got = prepare([os.path.join(CONFIGS, leaf), "--devices", "cpu", *extra])
    assert got.device == torch.device("cpu")

    def ext(v):
        if isinstance(v, str):
            return v.replace(".ckpt", ".pth.tar")
        if isinstance(v, dict):
            return {k: ext(x) for k, x in v.items()}
        return v

    keys = (("save_path", "checkpoint_path", "checkpoints_path",
             "best_checkpoint_path", "best_checkpoint_paths", "metrics",
             "metric") if "--evaluate" not in extra else ("save_path",))
    for k in keys:
        assert got.train[k] == ext(want["train"][k]), k
    if "--evaluate" in extra:
        for k in ("best_checkpoint_path", "predictions_path", "stats_path"):
            assert got.evaluate[k] == ext(want["evaluate"][k]), k
        assert set(got.dataset) == set(want["dataset"])
        assert got.dataset.split == want["dataset"]["split"]
    else:
        assert got.evaluate is None and want["evaluate"] is None


def test_prepare_refuses(tmp_path):
    """A JAX .ckpt (no msgpack reader on the card's machine) or another
    extension; several devices."""
    for path, match in (("x/best.ckpt", "msgpack"), ("x/best.npz", "end in")):
        with pytest.raises(ValueError, match=match):
            prepare([SHAPENET, "--devices", "cpu", "--evaluate",
                     f"--configs.evaluate.best_checkpoint_path={path}"])
    with pytest.raises(ValueError, match="DDP"):
        prepare([SHAPENET, "--devices", "0,1"])


def test_entry_points_default_to_cuda(monkeypatch, capsys):
    """Without --devices every config-driven entry point asks for cuda:0,
    which a machine without CUDA refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (train_main, train_dml_main, evaluate_main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([SHAPENET])


def test_per_dataset_entry_points_default_to_cuda(tree, frustums, rooms,
                                                  tmp_path, monkeypatch):
    """The per-dataset trainers and evaluators ask for cuda by default and
    refuse it without CUDA (train/trainer.py:check_device), before they
    train or evaluate."""
    from pvcnn_tpu_torch.evaluate.kitti.frustum.__main__ import \
        main as kitti_eval_main
    from pvcnn_tpu_torch.evaluate.s3dis.__main__ import main as s3dis_eval_main
    from pvcnn_tpu_torch.models.s3dis import MODELS

    checkpoint = str(tmp_path / "s3dis.pth.tar")
    torch.save({"model": MODELS["pvcnn"].build(0.125).state_dict()},
               checkpoint)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [(shapenet.main, ["--root", tree]), (dml.main, ["--root", tree]),
             (s3dis.main, ["--root", rooms[0]]),
             (kitti.main, ["--root", frustums]),
             (shapenet_eval_main, ["--root", tree]),
             (s3dis_eval_main, ["--root", rooms[0], "--width", "0.125",
                                "--checkpoint", checkpoint]),
             (kitti_eval_main, ["--root", frustums])]
    for main, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv + ["--save-path", str(tmp_path / "run")]
                 if main in (shapenet.main, dml.main, s3dis.main,
                             kitti.main) else argv)


def _shapenet_overrides(tree_, save):
    return [f"--configs.dataset.root={tree_}",
            "--configs.dataset.num_points=64",
            "--configs.model.width_multiplier=0.125",
            "--configs.train.batch_size=2", "--configs.train.num_epochs=1",
            "--configs.seed=0", f"--configs.train.save_path={save}"]


def _shapenet_flags(tree_, save):
    return ["--root", tree_, "--width", "0.125", "--batch-size", "2",
            "--num-points", "64", "--epochs", "1", "--seed", "0",
            "--device", "cpu", "--save-path", save]


def test_train_and_evaluate_shapenet(tree, tmp_path):
    """`python -m pvcnn_tpu_torch.train` with the ShapeNet PVCNN config
    trains as train.shapenet does (one epoch, 5 steps); its --evaluate
    (`python -m pvcnn_tpu_torch.evaluate`) writes evaluate.shapenet's
    stats."""
    got, want = str(tmp_path / "cli"), str(tmp_path / "shapenet")
    # the test's two torch threads: the CPU's reductions sum in an order
    # that depends on the number of threads
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    out = subprocess.run(
        [sys.executable, "-m", "pvcnn_tpu_torch.train", SHAPENET,
         "--devices", "cpu", *_shapenet_overrides(tree, got)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "training epoch 0/1" in out.stdout
    shapenet.main(_shapenet_flags(tree, want))
    _same_runs(got, want, ("latest.pth.tar", "best.pth.tar"))

    ckpt = os.path.join(got, "best.pth.tar")
    stats = evaluate_main([SHAPENET, "--devices", "cpu",
                           *_shapenet_overrides(tree, got),
                           "--configs.evaluate.num_votes=2"])
    assert os.path.exists(os.path.join(got, "best.eval.npy"))
    reference = shapenet_eval_main(
        ["--root", tree, "--checkpoint", ckpt, "--width", "0.125",
         "--num-points", "64", "--num-votes", "2", "--batch-size", "32",
         "--device", "cpu", "--seed", "0", "--stats-path",
         str(tmp_path / "reference.npy")])
    np.testing.assert_array_equal(stats, np.load(tmp_path / "reference.npy"))
    assert stats[:, 1].sum() == 5


def test_train_dml_matches_train_dml_entry_point(tree, tmp_path):
    """train_dml with the ShapeNet PVCNN config and an iter schedule trains
    both peers as train.dml does: the same scalars (both peers' losses
    and meters) and bitwise-equal teacher and student checkpoints."""
    got, want = str(tmp_path / "cli"), str(tmp_path / "dml")
    teacher, student = train_dml_main(
        [SHAPENET, "--devices", "cpu", *_shapenet_overrides(tree, got),
         "--configs.train.scheduler_unit=iter"])
    reference = dml.main(_shapenet_flags(tree, want)
                         + ["--scheduler-unit", "iter"])
    assert (teacher, student) == reference
    _same_runs(got, want, ("latest.pth.tar", "latest.pth.tar.student",
                           "best_student.pth.tar"))


def test_s3dis_run_over_a_store(rooms, tmp_path, capsys):
    """prepare, the store set on configs.dataset, run: the S3DIS PVCNN
    c0p125 config trains as train.s3dis does over the same store; its
    evaluator (configs.evaluate.fn) gives evaluate.s3dis's stats."""
    root, store = rooms
    got, want = str(tmp_path / "cli"), str(tmp_path / "s3dis")
    configs = prepare([S3DIS_C, "--devices", "cpu",
                       f"--configs.dataset.root={root}",
                       "--configs.dataset.num_points=256",
                       "--configs.train.batch_size=8",
                       "--configs.train.num_epochs=1", "--configs.seed=0",
                       f"--configs.train.save_path={got}"])
    configs.dataset.opener = store
    assert "WindowStore(" in str(configs)
    meters = run(configs)
    reference = s3dis.train(root, model="pvcnn", width_multiplier=0.125,
                            batch_size=8, epochs=1, save_path=want,
                            device="cpu", seed=0, num_points=256,
                            opener=store)
    assert meters == reference and 0.0 <= meters["acc/iou_test"] <= 1.0
    _same_runs(got, want, ("latest.pth.tar", "best.pth.tar"))

    configs = prepare([S3DIS_C, "--devices", "cpu", "--evaluate",
                       f"--configs.dataset.root={root}",
                       "--configs.dataset.num_points=256",
                       "--configs.seed=0", f"--configs.train.save_path={got}"])
    configs.dataset.opener = store
    stats = configs.evaluate.fn(configs)
    assert os.path.exists(os.path.join(got, "best.eval.npy"))
    reference = s3dis_eval.evaluate(
        root, model_name="pvcnn", width_multiplier=0.125,
        checkpoint=os.path.join(got, "best.pth.tar"), num_points=256,
        device="cpu", seed=0, opener=store,
        stats_path=str(tmp_path / "reference.npy"))
    np.testing.assert_array_equal(stats, reference)
    assert stats.shape == (3, 13, 1) and stats[1].sum() > 0


def test_frustum_run_and_evaluate(frustums, tmp_path):
    """The FrustumPVCNNE config trains as train.kitti does (the sampler on
    the trainer's own generator; train.profile traces into the save path
    as --profile does), and its evaluator gives evaluate.kitti.frustum's
    APs and predictions."""
    got, want = str(tmp_path / "cli"), str(tmp_path / "kitti")
    overrides = [f"--configs.dataset.root={frustums}",
                 "--configs.dataset.num_points=128",
                 "--configs.model.width_multiplier=0.125",
                 "--configs.train.batch_size=4",
                 "--configs.train.num_epochs=1", "--configs.seed=0",
                 f"--configs.train.save_path={got}"]
    meters = train_main([KITTI_C, "--devices", "cpu", *overrides,
                         "--configs.train.profile=1"])
    reference = kitti.main(["--root", frustums, "--width", "0.125",
                            "--batch-size", "4", "--num-points", "128",
                            "--epochs", "1", "--seed", "0", "--device",
                            "cpu", "--save-path", want, "--profile"])
    for save in (got, want):
        assert os.listdir(os.path.join(save, "profile"))
    assert meters == reference and len(meters) == 6
    _same_runs(got, want, ("latest.pth.tar", "best.pth.tar"))

    results = evaluate_main(
        [KITTI_C, "--devices", "cpu", *overrides,
         "--configs.evaluate.num_tests=1",
         f"--configs.evaluate.ground_truth_path={frustums}/ground_truth",
         "--configs.evaluate.image_id_file_path="
         f"{frustums}/image_sets/val.txt"])
    output = str(tmp_path / "reference")
    expected = kitti_eval.evaluate(
        frustums, model_name="pvcnne", width_multiplier=0.125,
        checkpoint=os.path.join(got, "best.pth.tar"), num_points=128,
        num_tests=1, device="cpu", seed=0, output=output)
    assert set(results) == set(expected)
    for c in expected:
        for kind in expected[c]:
            np.testing.assert_array_equal(results[c][kind],
                                          expected[c][kind])
    np.testing.assert_array_equal(np.load(os.path.join(got, "best.eval.npy")),
                                  np.load(output + ".eval.npy"))


@pytest.mark.parametrize("workload", ["shapenet_pvcnn_c1",
                                      "s3dis_pvcnn_c0p125"])
def test_parity_dry_run(workload, capsys):
    """The parity tool's dry run on its own fixtures: the evaluate command
    runs in a process of its own and report() prints a metric in
    [0, 100]; without --dry-run it refuses, downloading nothing."""
    got = parity.main([workload, "--dry-run", "--devices", "cpu"])
    out = capsys.readouterr().out
    assert 0.0 <= got <= 100.0
    assert "pvcnn_tpu_torch.evaluate" in out and "DRY-RUN complete" in out
    with pytest.raises(SystemExit, match="not in the repository"):
        parity.main([workload])
    parity.main(["--list"])
    assert "kitti_frustum_pvcnne" in capsys.readouterr().out
