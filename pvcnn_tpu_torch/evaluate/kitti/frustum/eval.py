"""KITTI Frustum detection evaluation from 2-D detections (counterpart of
pvcnn_tpu/evaluate/kitti/frustum/eval.py; reference
evaluate/kitti/frustum/eval.py).

The Frustum model runs in eval mode over the rgb-detection frustums of the
val split; the argmax heading and size bins plus their residuals decode
each box, which is turned from the frustum frame back into the camera
frame and written as KITTI label files, one per image; the official AP
stack (evaluate/kitti/official_eval.py) scores them against the ground
truth. The model's foreground sampler and the reader's resampling draw
anew in every test, so `num_tests` tests, each reseeding both, give the
mean, spread and best AP. A test's predictions are cached in its stats
.npy: a second run with the same paths reuses them.

update_predictions and write_predictions are the JAX evaluator's numpy
code, restated so that the port imports nothing of the JAX package
(tests/test_torch_kitti_eval.py holds them equal).
"""

from __future__ import annotations

import os
import pathlib
import random
import shutil
import time

import numpy as np
import torch

from pvcnn_tpu_torch.evaluate.kitti.common import eval_from_files

__all__ = ["decode_boxes", "evaluate", "evaluate_from_configs",
           "update_predictions", "write_predictions"]


def update_predictions(predictions, center, heading, size, rotation_angle,
                       rgb_score, current_step):
    """Turn a batch of decoded boxes back into the camera frame and store
    (h, w, l, x, y, z, ry, score) rows at `current_step` (in place);
    y is the box's bottom, as KITTI labels give it."""
    batch_size = center.shape[0]
    l, w, h = size[:, 0], size[:, 1], size[:, 2]
    x, y, z = center[:, 0], center[:, 1], center[:, 2]
    r = rotation_angle
    v_cos, v_sin = np.cos(r), np.sin(r)
    # the inverse of the frustum rotation
    cx = v_cos * x + v_sin * z
    cy = y + h / 2.0
    cz = v_cos * z - v_sin * x
    ry = np.mod(r + heading + np.pi, 2 * np.pi) - np.pi
    predictions[current_step:current_step + batch_size] = np.stack(
        [h, w, l, cx, cy, cz, ry, rgb_score], axis=1)


def write_predictions(prediction_path, ids, classes, boxes_2d, predictions,
                      image_id_file_path=None):
    """One KITTI label file per image id under `prediction_path` (emptied
    first), and an empty one for every id of `image_id_file_path` without
    a detection -> that file, or the sorted ids written."""
    results: dict = {}
    for i in range(predictions.shape[0]):
        idx = ids[i]
        line = ("{} -1 -1 -10 "
                "{:f} {:f} {:f} {:f} "
                "{:f} {:f} {:f} {:f} {:f} {:f} {:f} {:f}\n").format(
            classes[i], *boxes_2d[i][:4], *predictions[i])
        results.setdefault(idx, []).append(line)

    if os.path.exists(prediction_path):
        shutil.rmtree(prediction_path)
    os.makedirs(prediction_path)
    for k, v in results.items():
        with open(os.path.join(prediction_path, f"{k:06d}.txt"), "w") as f:
            f.writelines(v)

    if image_id_file_path is not None and os.path.exists(image_id_file_path):
        with open(image_id_file_path) as f:
            for idx in f.readlines():
                p = os.path.join(prediction_path, f"{idx.strip()}.txt")
                if not os.path.exists(p):
                    pathlib.Path(p).touch()
        return image_id_file_path
    return sorted(results.keys())


def decode_boxes(outputs: dict, size_templates: np.ndarray,
                 num_heading_angle_bins: int):
    """numpy outputs of a Frustum model -> (center [B, 3], heading [B],
    size [B, 3]) from the argmax heading and size bins and their
    residuals."""
    center = np.asarray(outputs["center"])
    heading_scores = np.asarray(outputs["heading_scores"])
    heading_residuals = np.asarray(outputs["heading_residuals"])
    size_scores = np.asarray(outputs["size_scores"])
    size_residuals = np.asarray(outputs["size_residuals"])
    bin_centers = np.arange(0, 2 * np.pi, 2 * np.pi / num_heading_angle_bins)
    batch = np.arange(center.shape[0])
    heading_bin = heading_scores.argmax(-1)
    heading = bin_centers[heading_bin] + heading_residuals[batch, heading_bin]
    size_bin = size_scores.argmax(-1)
    size = size_templates[size_bin] + size_residuals[batch, size_bin]
    return center, heading, size


def _seeds(seed: int, num_tests: int) -> list:
    """Test 0 runs at `seed`, each later test at a seed drawn from
    random.Random(seed) (the JAX evaluator draws them from the clock, so
    its later tests cannot be repeated)."""
    draw = random.Random(seed)
    return [seed] + [draw.randint(1, 2 ** 31 - 1)
                     for _ in range(num_tests - 1)]


def _output_paths(output: str, num_tests: int):
    """(stats path, predictions path) per test: output.eval.npy and
    output.predictions for one test; else output.eval.t/best.eval.t{i}.npy
    and output.predictions.t/best.predictions.t{i}, as the JAX evaluator
    names them."""
    if num_tests == 1:
        return [(output + ".eval.npy", output + ".predictions")]
    return [(os.path.join(output + ".eval.t", f"best.eval.t{i}.npy"),
             os.path.join(output + ".predictions.t", f"best.predictions.t{i}"))
            for i in range(num_tests)]


def evaluate(root: str, model: torch.nn.Module | None = None, *,
             model_name: str = "pvcnne", checkpoint: str | None = None,
             width_multiplier: float = 1.0, num_points: int | None = None,
             batch_size: int = 32, num_tests: int = 20,
             ground_truth: str | None = None, image_ids: str | None = None,
             output: str | None = None, device: str = "cuda", seed: int = 0,
             timings: list | None = None):
    """Evaluate a Frustum model on the rgb-detection frustums of the val
    split at `root` -> the AP dict of eval_from_files ({class: {"bbox",
    "bev", "3d": [easy, moderate, hard]}}) for one test; for several,
    {class: {kind: [one such list a test]}}, with the mean / std / max
    table printed.

    Without `model`, builds `model_name` (models.kitti.frustum.MODELS) at
    `width_multiplier` with the weights of `checkpoint` (the port's
    training checkpoint or a reference .pth.tar: both carry the reference's
    module names; a trusted file, it is unpickled), or seeded random ones.
    `ground_truth` and `image_ids` default to root/ground_truth and
    root/image_sets/val.txt, `output` to the checkpoint's path without its
    extension (runs/kitti.frustum.<model>/best without one). `timings`, if
    given, gets one {"frustums", "data", "forward", "ap"} dict a test:
    seconds reading items, in the forward (to the outputs on the host; 0
    for a cached test) and writing and scoring the label files."""
    from pvcnn_tpu_torch.data.kitti.frustum import FrustumKitti
    from pvcnn_tpu_torch.data.loader import DataLoader
    from pvcnn_tpu_torch.models.kitti import frustum as kitti
    from pvcnn_tpu_torch.train.predict import predict
    from pvcnn_tpu_torch.train.trainer import (SAMPLE_SEED_OFFSET, Trainer,
                                               check_device)
    from pvcnn_tpu_torch.utils.weights import (init_random_,
                                               load_reference_checkpoint)

    device = check_device(device)
    if model is None:
        model = kitti.MODELS[model_name].build(width_multiplier)
        if checkpoint is not None:
            print(f'==> loading checkpoint "{checkpoint}"')
            load_reference_checkpoint(model, checkpoint)
        else:
            init_random_(model, seed)
    trainer = Trainer(model, None, None, device, seed)
    ground_truth = ground_truth or os.path.join(root, "ground_truth")
    image_ids = image_ids or os.path.join(root, "image_sets", "val.txt")
    if output is None:
        output = (os.path.join("runs", f"kitti.frustum.{model_name}", "best")
                  if checkpoint is None else
                  checkpoint.removesuffix(".tar").removesuffix(".pth"))
    dataset = FrustumKitti(
        root, kitti.NUM_POINTS if num_points is None else num_points,
        split="val", classes=kitti.CLASSES,
        num_heading_angle_bins=kitti.NUM_HEADING_ANGLE_BINS,
        from_rgb_detection=True, frustum_rotate=True)["val"]
    templates = model.size_templates.cpu().numpy().reshape(-1, 3)

    results: dict = {}
    paths = _output_paths(output, num_tests)
    for test, (seed_i, (stats_path, predictions_path)) in enumerate(
            zip(_seeds(seed, num_tests), paths)):
        if test > 0:
            print(f"\n==> Test [{test:02d}/{num_tests:02d}] seed={seed_i}")
        dataset.rng = np.random.RandomState(seed_i)
        trainer.sample_generator.manual_seed(seed_i + SAMPLE_SEED_OFFSET)
        os.makedirs(os.path.dirname(stats_path) or ".", exist_ok=True)
        spent = {"frustums": len(dataset), "data": 0.0, "forward": 0.0,
                 "ap": 0.0}
        if os.path.exists(stats_path):
            print(f"==> hit {stats_path}")
            predictions = np.load(stats_path)
        else:
            predictions = np.zeros((len(dataset), 8))
            current_step = 0
            # serial, no prefetch: each test's draws come from the
            # generator seeded above, in item order (a pool would
            # interleave them), and spent["data"] is the time to assemble
            # each batch
            batches = iter(DataLoader(dataset, batch_size, prefetch=0,
                                      num_workers=0))
            while True:
                start = time.perf_counter()
                batch = next(batches, None)
                spent["data"] += time.perf_counter() - start
                if batch is None:
                    break
                inputs, targets = batch
                start = time.perf_counter()
                outputs = predict(trainer.model, trainer._to_device(inputs))
                outputs = {k: v.cpu().numpy() for k, v in outputs.items()}
                spent["forward"] += time.perf_counter() - start
                center, heading, size = decode_boxes(
                    outputs, templates, kitti.NUM_HEADING_ANGLE_BINS)
                update_predictions(predictions, center, heading, size,
                                   np.asarray(targets["rotation_angle"]),
                                   np.asarray(targets["rgb_score"]),
                                   current_step)
                current_step += center.shape[0]
            np.save(stats_path, predictions)
        start = time.perf_counter()
        ids = write_predictions(
            predictions_path, ids=dataset.data["ids"],
            classes=dataset.data["class_names"],
            boxes_2d=dataset.data["boxes_2d"], predictions=predictions,
            image_id_file_path=image_ids)
        _, current = eval_from_files(
            prediction_folder=predictions_path,
            ground_truth_folder=ground_truth, image_ids=ids, verbose=True)
        spent["ap"] = time.perf_counter() - start
        if spent["forward"]:
            print(f"[frustums/s] = {len(dataset) / spent['forward']:.1f}  "
                  f"[seconds] data {spent['data']:.3f} forward "
                  f"{spent['forward']:.3f} ap {spent['ap']:.3f}")
        if timings is not None:
            timings.append(spent)
        if num_tests == 1:
            return current
        for class_name, v in current.items():
            for kind, r in v.items():
                results.setdefault(class_name, {}).setdefault(
                    kind, []).append(r)

    for class_name, v in results.items():
        print(f"{class_name}  AP(Average Precision)")
        for kind, r in v.items():
            r = np.asarray(r)
            line = ", ".join(
                f"{mv:.2f} +/- {sv:.2f} ({uv:.2f})"
                for mv, sv, uv in zip(r.mean(0), r.std(0), r.max(0)))
            print(f"{kind:<4} AP: {line}")
    return results


def evaluate_from_configs(configs):
    """The evaluation a config describes (configs.evaluate.fn; the JAX
    package's evaluate(configs)): the model configs.model() builds, with
    the weights of configs.evaluate.best_checkpoint_path (a trusted file,
    it is unpickled), on configs.device; the rgb-detection frustums of the
    val split at configs.dataset.root with its num_points;
    evaluate.batch_size, num_tests, ground_truth_path and
    image_id_file_path; test 0 seeded with configs.seed. A test's
    predictions and label files go beside evaluate.stats_path (its stem
    + .eval.npy and .predictions for one test, as the keyword evaluate
    names them). -> evaluate's AP dict, or None where the checkpoint is
    missing."""
    from pvcnn_tpu_torch.evaluate import configured_model

    model = configured_model(configs)
    if model is None:
        return None
    return evaluate(
        configs.dataset.root, model, num_points=configs.dataset.num_points,
        batch_size=configs.evaluate.batch_size,
        num_tests=int(configs.evaluate.get("num_tests", 1)),
        ground_truth=configs.evaluate.ground_truth_path,
        image_ids=configs.evaluate.image_id_file_path,
        output=configs.evaluate.stats_path.removesuffix(".eval.npy"),
        device=configs.device, seed=configs.get("seed") or 0)
