"""The port's KITTI Frustum data, meters and evaluation against the JAX
package, on a synthetic tree written by data/kitti/frustum.py:
write_synthetic_root (real boxes of synthetic_batch's generator in the
camera frame, 2-D boxes from a KITTI-like camera, label files): the
FrustumKitti reader (items equal for a shared seed), get_box_iou_3d,
MeterFrustumKitti, the rotated BEV and 3-D overlaps, the official AP
stack (its results and printed table), the label IO, the evaluator's
prediction files, the evaluator end to end (FrustumPointNet at test width
under tests/test_torch_frustum.py's deterministic sampler law), and the
training entry point `python -m pvcnn_tpu_torch.train.kitti`.
"""

import os
import pickle

import jax
import numpy as np
import pytest
import torch

from pvcnn_tpu.data.kitti.frustum import FrustumKitti as JFrustumKitti
from pvcnn_tpu.evaluate.kitti import common as jcommon
from pvcnn_tpu.evaluate.kitti import iou as jiou
from pvcnn_tpu.evaluate.kitti import official_eval as jofficial
from pvcnn_tpu.evaluate.kitti.frustum import eval as jeval
from pvcnn_tpu.meters.kitti import frustum as jmeter
from pvcnn_tpu.meters.kitti.utils import get_box_iou_3d as jbox_iou
from pvcnn_tpu_torch.data.kitti import attributes
from pvcnn_tpu_torch.data.kitti.frustum import (FrustumKitti, box_corners_np,
                                                synthetic_batch,
                                                write_synthetic_root)
from pvcnn_tpu_torch.evaluate.kitti import common, iou, official_eval
from pvcnn_tpu_torch.evaluate.kitti.frustum import eval as teval
from pvcnn_tpu_torch.meters.kitti.frustum import MeterFrustumKitti
from pvcnn_tpu_torch.meters.kitti.utils import get_box_iou_3d
from pvcnn_tpu_torch.train.kitti import main as kitti_main
from test_torch_frustum import (CASES, deterministic_sampler,  # noqa: F401
                                make_models)

CLASSES = ("Car", "Pedestrian", "Cyclist")
NH = 12
TEMPLATES = attributes.size_templates()
NUM_OBJECTS = 24              # frustums a split, two an image


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module (tests/test_torch_frustum.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("kitti_frustum"))
    write_synthetic_root(path, np.random.RandomState(0), NUM_OBJECTS)
    return path


def _assert_items_equal(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


@pytest.mark.parametrize("split,kwargs", [
    ("train", dict(random_flip=True, random_shift=True, frustum_rotate=True)),
    ("train", dict()),
    ("val", dict(random_flip=True, random_shift=True, frustum_rotate=True)),
    ("val", dict(frustum_rotate=True, from_rgb_detection=True)),
])
def test_reader_items_equal_jax(root, split, kwargs):
    """Items drawn from RandomState(s) equal the JAX reader's from
    np.random.seed(s), exactly, through the resampling, flip and shift
    (val never flips or shifts; the rgb-detection split gives the rotation
    angle and the 2-D detector's score)."""
    seed, order = 7, [0, 3, 3, 11, 5, 23, 1, 17, 9, 2]
    mine = FrustumKitti(root, 64, split=split, rng=np.random.RandomState(seed),
                        **kwargs)[split]
    theirs = JFrustumKitti(root, 64, split=split, **kwargs)[split]
    assert len(mine) == len(theirs) == NUM_OBJECTS
    np.random.seed(seed)
    want = [theirs[i] for i in order]
    got = [mine[i] for i in order]
    for g, w in zip(got, want):
        _assert_items_equal(g, w)


def _boxes(rng, b):
    """Random boxes (centers, headings, sizes), for box_corners_np."""
    centers = rng.uniform(-3, 3, (b, 3))
    headings = rng.uniform(-np.pi, np.pi, b)
    sizes = rng.uniform(0.5, 4.0, (b, 3))
    return centers, headings, sizes


def test_box_iou_3d_matches_jax():
    """Random rotated boxes against moved copies of themselves, disjoint
    boxes (IoU 0) and copies moved by 1e-9 (IoU 1), at rtol 1e-12. Boxes
    exactly equal make both packages raise alike: the clip meets
    collinear edges and divides by zero (the reference's protocol, kept
    for parity)."""
    rng = np.random.RandomState(0)
    c, h, s = _boxes(rng, 16)
    corners = box_corners_np(c, h, s)
    moved = box_corners_np(c + rng.uniform(-1, 1, c.shape),
                        h + rng.uniform(-0.5, 0.5, h.shape),
                        s * rng.uniform(0.7, 1.3, s.shape))
    far = box_corners_np(c + 50.0, h, s)
    near = box_corners_np(c + 1e-9, h + 1e-9, s)
    for other in (moved, far, near):
        got = get_box_iou_3d(corners, other)
        want = jbox_iou(corners, other)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    assert not get_box_iou_3d(corners, far)[0].any()
    np.testing.assert_allclose(get_box_iou_3d(corners, near)[0], 1.0,
                               rtol=1e-6)
    assert 0 < get_box_iou_3d(corners, moved)[0].max() < 1
    with np.errstate(all="ignore"):
        for fn in (get_box_iou_3d, jbox_iou):
            with pytest.raises(ValueError, match="NaN"):
                fn(corners[:1], corners[:1])


def _outputs(rng, targets, noise):
    """Model outputs whose decoded boxes lie near the targets'."""
    b = targets["center"].shape[0]
    rows = np.arange(b)
    heading_scores = rng.randn(b, NH)
    heading_scores[rows, targets["heading_bin_id"]] += 3.0 * noise
    size_scores = rng.randn(b, len(TEMPLATES))
    size_scores[rows, targets["size_template_id"]] += 3.0 * noise
    return {"mask_logits": rng.randn(b, targets["mask_logits"].shape[1], 2),
            "center": targets["center"] + rng.randn(b, 3) * 0.3,
            "heading_scores": heading_scores,
            "heading_residuals": rng.randn(b, NH) * 0.1 + (
                targets["heading_residual"][:, None]),
            "size_scores": size_scores,
            "size_residuals": rng.randn(b, len(TEMPLATES), 3) * 0.1
            + targets["size_residual"][:, None, :]}


@pytest.mark.parametrize("metric", ["iou_2d", "iou_3d", "accuracy",
                                    "iou_3d_accuracy",
                                    "iou_3d_class_accuracy"])
def test_meter_matches_jax(metric):
    """Each of the five metrics over four batches equals JAX's exactly."""
    rng = np.random.RandomState(1)
    classes = {c: i for i, c in enumerate(CLASSES)}
    args = (NH, len(TEMPLATES), TEMPLATES, classes)
    mine = MeterFrustumKitti(*args, metric=metric)
    theirs = jmeter.MeterFrustumKitti(*args, metric=metric)
    for k in range(4):
        _, targets = synthetic_batch(rng, 6, 32, NH)
        outputs = _outputs(rng, targets, noise=k % 2)
        mine.update(outputs, targets)
        theirs.update(outputs, targets)
    assert mine.compute() == theirs.compute()
    assert 0.0 <= mine.compute() <= 1.0


def test_rotated_overlaps_match_jax():
    """rotate_iou_eval under each criterion, image_box_overlap and
    d3_box_overlap at rtol 1e-12, on random boxes, some overlapping."""
    rng = np.random.RandomState(2)
    boxes = np.concatenate([rng.uniform(-5, 5, (9, 2)),
                            rng.uniform(0.5, 4, (9, 2)),
                            rng.uniform(-np.pi, np.pi, (9, 1))], 1)
    qboxes = boxes[rng.permutation(9)[:7]] + rng.uniform(-0.5, 0.5, (7, 5))
    for criterion in (-1, 0, 1, 2):
        np.testing.assert_allclose(
            iou.rotate_iou_eval(boxes, qboxes, criterion),
            jiou.rotate_iou_eval(boxes, qboxes, criterion), rtol=1e-12,
            atol=0)
    assert iou.rotate_iou_eval(boxes, qboxes).max() > 0
    full = np.concatenate([rng.uniform(-5, 5, (9, 3)),
                           rng.uniform(0.5, 4, (9, 3)),
                           rng.uniform(-np.pi, np.pi, (9, 1))], 1)
    qfull = full[::-1] + rng.uniform(-0.3, 0.3, full.shape)
    for criterion in (-1, 0, 1):
        np.testing.assert_allclose(
            official_eval.d3_box_overlap(full, qfull, criterion),
            jofficial.d3_box_overlap(full, qfull, criterion), rtol=1e-12,
            atol=0)
    b2 = np.sort(rng.uniform(0, 100, (6, 4)).reshape(6, 2, 2), 1).reshape(
        6, 4)[:, [0, 2, 1, 3]]
    for criterion in (-1, 0, 1):
        np.testing.assert_allclose(
            official_eval.image_box_overlap(b2, b2[::-1], criterion),
            jofficial.image_box_overlap(b2, b2[::-1], criterion),
            rtol=1e-12, atol=0)


def _detections(gt_annos, kind, rng):
    """Detections for each image: the ground truth itself ("perfect"),
    none ("none"), or the ground truth moved and rescaled with a false
    positive an image and observation angles ("noisy")."""
    out = []
    for gt in gt_annos:
        n = len(gt["name"])
        if kind == "none":
            out.append({"name": np.array([], dtype="<U10"),
                        "truncated": np.zeros(0), "occluded": np.zeros(0),
                        "alpha": np.zeros(0), "bbox": np.zeros((0, 4)),
                        "dimensions": np.zeros((0, 3)),
                        "location": np.zeros((0, 3)),
                        "rotation_y": np.zeros(0), "score": np.zeros(0)})
            continue
        dt = {k: np.array(v, copy=True) for k, v in gt.items()}
        dt["score"] = rng.uniform(0.1, 1.0, n)
        dt["alpha"] = np.full(n, -10.0)
        if kind == "noisy":
            dt["alpha"] = gt["alpha"] + rng.randn(n) * 0.2
            dt["location"] = gt["location"] + rng.randn(n, 3) * 0.3
            dt["dimensions"] = gt["dimensions"] * rng.uniform(0.8, 1.2,
                                                              (n, 3))
            dt["rotation_y"] = gt["rotation_y"] + rng.randn(n) * 0.3
            dt["bbox"] = gt["bbox"] + rng.randn(n, 4) * 8.0
            extra = {k: v[:1].copy() for k, v in dt.items()}
            extra["location"] = extra["location"] + [4.0, 0.0, 3.0]
            extra["bbox"] = extra["bbox"] + 150.0
            extra["score"] = np.array([0.95])
            dt = {k: np.concatenate([dt[k], extra[k]]) for k in dt}
        out.append(dt)
    return out


@pytest.mark.parametrize("kind", ["perfect", "none", "noisy"])
def test_official_eval_matches_jax(root, kind, capsys):
    """get_official_eval_result's metrics, results dict and printed table
    equal JAX's exactly, on the synthetic ground truth."""
    gt = common.get_label_annotations(os.path.join(root, "ground_truth"))
    dt = _detections(gt, kind, np.random.RandomState(3))
    m_mine, r_mine, s_mine = official_eval.get_official_eval_result(
        gt, dt, [0, 1, 2])
    m_j, r_j, s_j = jofficial.get_official_eval_result(gt, dt, [0, 1, 2])
    assert s_mine == s_j
    assert set(r_mine) == set(r_j) == set(CLASSES)
    for name in CLASSES:
        for key in ("bbox", "bev", "3d"):
            np.testing.assert_array_equal(r_mine[name][key], r_j[name][key])
    for key in ("bbox", "bev", "3d"):
        for part in ("precision", "orientation", "thresholds"):
            np.testing.assert_array_equal(m_mine[key][part], m_j[key][part])
    aps = np.concatenate([np.ravel(v) for r in r_mine.values()
                          for v in r.values()])
    assert np.isfinite(aps).all() and (aps >= 0).all() and (aps <= 100).all()
    if kind == "perfect":
        assert aps.max() > 0
    if kind == "none":
        assert not aps.any()
    assert ("aos  AP" in s_mine) == (kind == "noisy")


def test_label_files_round_trip(root, tmp_path):
    """A label file written as the evaluator writes predictions reads back
    to its values, and both packages read it (and a ground-truth file)
    alike."""
    rng = np.random.RandomState(4)
    pred = rng.uniform(0.5, 20, (3, 8))
    boxes = rng.uniform(0, 300, (3, 4))
    path = str(tmp_path / "pred")
    teval.write_predictions(path, [5, 5, 5], ["Car", "Cyclist", "Car"],
                            boxes, pred)
    anno = common.get_label_annotation(os.path.join(path, "000005.txt"))
    np.testing.assert_allclose(anno["bbox"], boxes, atol=1e-6)
    np.testing.assert_allclose(anno["dimensions"], pred[:, [2, 0, 1]],
                               atol=1e-6)
    np.testing.assert_allclose(anno["location"], pred[:, 3:6], atol=1e-6)
    np.testing.assert_allclose(anno["rotation_y"], pred[:, 6], atol=1e-6)
    np.testing.assert_allclose(anno["score"], pred[:, 7], atol=1e-6)
    assert list(anno["name"]) == ["Car", "Cyclist", "Car"]
    for f in (os.path.join(path, "000005.txt"),
              os.path.join(root, "ground_truth", "000000.txt")):
        mine, theirs = (common.get_label_annotation(f),
                        jcommon.get_label_annotation(f))
        assert set(mine) == set(theirs)
        for k in theirs:
            np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


def test_prediction_files_equal_jax(root, tmp_path):
    """update_predictions fills the same rows as JAX's, and
    write_predictions writes byte-equal files (the empty ones of image ids
    without a detection too)."""
    rng = np.random.RandomState(5)
    b = 10
    args = (rng.randn(b, 3) * 5, rng.uniform(-np.pi, np.pi, b),
            rng.uniform(0.5, 4, (b, 3)), rng.uniform(-0.6, 0.6, b),
            rng.uniform(0.5, 1, b))
    mine, theirs = np.zeros((b + 2, 8)), np.zeros((b + 2, 8))
    teval.update_predictions(mine, *args, 2)
    jeval.update_predictions(theirs, *args, 2)
    np.testing.assert_array_equal(mine, theirs)
    ids = [0, 0, 1, 3, 3, 3, 4, 6, 6, 7, 8, 8]
    names = [CLASSES[i % 3] for i in range(b + 2)]
    boxes = rng.uniform(0, 400, (b + 2, 4))
    image_ids = os.path.join(root, "image_sets", "val.txt")
    for with_ids in (False, True):
        a, c = str(tmp_path / f"mine{with_ids}"), str(tmp_path / f"j{with_ids}")
        extra = (image_ids,) if with_ids else ()
        got = teval.write_predictions(a, ids, names, boxes, mine, *extra)
        want = jeval.write_predictions(c, ids, names, boxes, theirs, *extra)
        assert got == want
        assert sorted(os.listdir(a)) == sorted(os.listdir(c))
        for name in os.listdir(c):
            with open(os.path.join(a, name), "rb") as f1, \
                    open(os.path.join(c, name), "rb") as f2:
                assert f1.read() == f2.read(), name


@pytest.fixture(scope="module")
def pointnet():
    """FrustumPointNet at test width: (case, flax variables, port model)."""
    case = CASES["pointnet"]
    variables, port = make_models(case)
    return case, variables, port


def test_evaluator_matches_jax(root, pointnet, deterministic_sampler,
                               tmp_path):
    """The evaluator on the rgb-detection split (num_tests 1, the same
    weights, the deterministic sampler law, the reader seeded alike): its
    predictions within rtol 1e-4 (atol 1e-4 of the largest) of JAX's
    evaluate, which loads the port's weights from a .pth.tar, and its AP
    dict equal to JAX's eval_from_files on the port's own prediction
    folder."""
    from pvcnn_tpu.evaluate.kitti.frustum.eval import evaluate as jevaluate
    from pvcnn_tpu.utils.config import Config

    case, _, port = pointnet
    ckpt = str(tmp_path / "best.pth.tar")
    torch.save({"model": port.state_dict()}, ckpt)
    gt = os.path.join(root, "ground_truth")
    image_ids = os.path.join(root, "image_sets", "val.txt")
    configs = Config()
    configs.seed = 3
    configs.dataset = Config(JFrustumKitti, root=root, num_points=128,
                             classes=CLASSES, num_heading_angle_bins=NH,
                             random_flip=True, random_shift=True,
                             frustum_rotate=True, from_rgb_detection=True,
                             split="val")
    configs.model = Config(lambda: case.jmodel)
    configs.data = Config(size_templates=TEMPLATES,
                          num_heading_angle_bins=NH)
    stem = str(tmp_path / "jax" / "best")
    os.makedirs(os.path.dirname(stem))
    configs.evaluate = Config(num_tests=1, batch_size=8,
                              dataset=Config(split="val"),
                              best_checkpoint_path=ckpt,
                              stats_path=stem + ".eval.npy",
                              predictions_path=stem + ".predictions",
                              ground_truth_path=gt,
                              image_id_file_path=image_ids)
    with jax.default_matmul_precision("float32"):
        want_aps = jevaluate(configs)
    want = np.load(stem + ".eval.npy")

    out = str(tmp_path / "port" / "best")
    got_aps = teval.evaluate(root, port, num_points=128, batch_size=8,
                             num_tests=1, output=out, device="cpu", seed=3)
    got = np.load(out + ".eval.npy")
    assert got.shape == want.shape == (NUM_OBJECTS, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    _, theirs = jcommon.eval_from_files(out + ".predictions", gt, image_ids)
    for name in CLASSES:
        for key in ("bbox", "bev", "3d"):
            np.testing.assert_array_equal(got_aps[name][key],
                                          theirs[name][key])
            np.testing.assert_allclose(got_aps[name][key],
                                       want_aps[name][key], atol=1e-9)


def test_evaluator_writes_every_test(root, pointnet, tmp_path, capsys):
    """num_tests = 2 writes both tests' prediction folders and stats, and
    prints the mean / std / max table; a second run reuses the stats."""
    _, _, port = pointnet
    out = str(tmp_path / "best")
    results = teval.evaluate(root, port, num_points=128, batch_size=8,
                             num_tests=2, output=out, device="cpu")
    for i in range(2):
        assert os.path.exists(os.path.join(out + ".eval.t",
                                           f"best.eval.t{i}.npy"))
        folder = os.path.join(out + ".predictions.t", f"best.predictions.t{i}")
        assert len(os.listdir(folder)) == NUM_OBJECTS // 2
    assert all(len(r) == 2 for v in results.values() for r in v.values())
    assert "+/-" in capsys.readouterr().out
    again = teval.evaluate(root, port, num_points=128, batch_size=8,
                           num_tests=2, output=out, device="cpu")
    assert "==> hit" in capsys.readouterr().out
    for name in CLASSES:
        np.testing.assert_array_equal(again[name]["3d"], results[name]["3d"])


def test_synthetic_root_is_consistent(root):
    """The ground truth matches the frustums' boxes: the val split's own
    targets, turned back into the camera frame by the evaluator's
    update_predictions, score the AP of perfect boxes (every 3-D AP equal
    to its bbox AP) against the label files."""
    val = FrustumKitti(root, 16, split="val", frustum_rotate=True)["val"]
    rgb = FrustumKitti(root, 16, split="val", frustum_rotate=True,
                       from_rgb_detection=True)["val"]
    pred = np.zeros((NUM_OBJECTS, 8))
    for i in range(NUM_OBJECTS):
        _, t = val[i]
        _, r = rgb[i]
        heading = t["heading_bin_id"] * 2 * np.pi / NH + t["heading_residual"]
        size = TEMPLATES[t["size_template_id"]] + t["size_residual"]
        teval.update_predictions(pred, t["center"][None], np.array([heading]),
                                 size[None], np.array([r["rotation_angle"]]),
                                 np.array([r["rgb_score"]]), i)
    with open(os.path.join(root, "frustum_carpedcyc_val.pickle"), "rb") as f:
        ids = pickle.load(f)
    folder = os.path.join(root, "perfect")
    teval.write_predictions(folder, ids, val.data["class_names"],
                            val.data["boxes_2d"], pred)
    _, results = common.eval_from_files(
        folder, os.path.join(root, "ground_truth"),
        os.path.join(root, "image_sets", "val.txt"))
    for r in results.values():
        assert r["bbox"].max() > 0
        np.testing.assert_allclose(r["3d"], r["bbox"])


def test_kitti_cli_trains_scores_and_resumes(root, tmp_path, capsys):
    """One short epoch of FrustumPointNet on the CPU: the four meters lie
    in [0, 1], latest, the per-epoch and the best checkpoints are
    written, and a second run resumes at epoch 1."""
    save = str(tmp_path / "run")
    args = ["--root", root, "--model", "pointnet", "--width", "0.25",
            "--batch-size", "4", "--num-points", "128", "--max-steps", "2",
            "--device", "cpu", "--save-path", save]
    scores = kitti_main(args + ["--epochs", "1"])
    for name in ("acc/iou_3d_val", "acc/acc_val", "acc/iou_3d_acc_val",
                 "acc/iou_3d_class_acc_val"):
        assert 0.0 <= scores[name] <= 1.0, name
    for name in ("latest.pth.tar", "latest/e0.pth.tar", "best.pth.tar",
                 "best/best.acc.iou_3d_class_acc_val.pth.tar",
                 "best/best.acc.iou_3d_acc_val.pth.tar"):
        assert os.path.exists(os.path.join(save, name)), name
    kitti_main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "loading checkpoint" in out and "training epoch 1/2" in out
    assert "training epoch 0/2" not in out
    assert torch.load(os.path.join(save, "latest.pth.tar"),
                      weights_only=True)["epoch"] == 1
