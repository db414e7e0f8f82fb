"""S3DIS scene-level voting evaluation (counterpart of
pvcnn_tpu/evaluate/s3dis/eval.py; reference evaluate/s3dis/eval.py): the
Area-5 scene mIoU that S3DIS results report.

Per scene of the test split and per window file of it (zero, then half),
windows go eval_batch at a time: each window's valid points are tiled and
shuffled into num_votes * ceil(maxP / N) sub-clouds of N points, the model
predicts softmax probabilities for them, and each point's vote (the top
probability and its class) goes back through `indices_split_to_full` to
the scene's full-resolution points, where the most confident vote wins
(evaluate/votes.py). Stats [3, classes, scenes] count each class's points,
predictions and true positives; print_stats gives the class IoUs, the
overall accuracy and the mIoU. The shuffles draw from
np.random.RandomState(seed) in the JAX evaluator's order, so a seed gives
its votes.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from pvcnn_tpu_torch.data.s3dis import S3DIS, open_h5
from pvcnn_tpu_torch.evaluate.votes import vote_reduce_max

__all__ = ["evaluate", "evaluate_from_configs", "print_stats",
           "update_stats"]

NUM_CLASSES = 13


def update_stats(stats, ground_truth, predictions, scene_index, num_classes):
    """Add a scene's points, predictions (those >= 0) and true positives
    per class to stats[:, :, scene_index]."""
    stats[0, :, scene_index] += np.bincount(ground_truth,
                                            minlength=num_classes)[:num_classes]
    valid = predictions >= 0
    stats[1, :, scene_index] += np.bincount(predictions[valid],
                                            minlength=num_classes)[:num_classes]
    agree = valid & (ground_truth == predictions)
    stats[2, :, scene_index] += np.bincount(ground_truth[agree],
                                            minlength=num_classes)[:num_classes]


def print_stats(stats):
    stats = stats.sum(axis=-1)
    iou = stats[2] / np.maximum(stats[0] + stats[1] - stats[2], 1)
    print("classes: {}".format("  ".join(
        map("{:>8d}".format, stats[0].astype(np.int64)))))
    print("positiv: {}".format("  ".join(
        map("{:>8d}".format, stats[1].astype(np.int64)))))
    print("truepos: {}".format("  ".join(
        map("{:>8d}".format, stats[2].astype(np.int64)))))
    print("clssiou: {}".format("  ".join(map("{:>8.2f}".format, iou * 100))))
    print("meanAcc: {:4.2f}".format(stats[2].sum() / max(stats[1].sum(), 1) * 100))
    print("meanIoU: {:4.2f}".format(iou.mean() * 100))


def evaluate(root: str, model: torch.nn.Module | None = None, *,
             model_name: str = "pvcnn", checkpoint: str | None = None,
             width_multiplier: float = 1.0, num_points: int | None = None,
             holdout_area: int = 5, num_votes: int = 1, batch_size: int = 10,
             stats_path: str | None = None, device: str = "cuda",
             seed: int = 0, opener=open_h5, timings: dict | None = None,
             scene_outputs: dict | None = None):
    """Scene-level voting evaluation of an S3DIS model on Area
    `holdout_area` of the prepared tree at `root` -> the stats
    [3, 13, scenes], printed; None where the checkpoint is missing.

    Without `model`, builds `model_name` (models.s3dis.MODELS) at
    `width_multiplier` with the weights of `checkpoint` (the port's
    training checkpoint or a reference .pth.tar: a trusted file, it is
    unpickled), by default <save path of its recipe>/best.pth.tar; the
    stats then go to the checkpoint's path with .eval.npy for its
    extension, unless `stats_path` names another, and a run finds them
    there and prints them instead of evaluating again. `num_points`
    defaults to the recipe's. `opener` reads the window files
    (data/s3dis.py: open_h5 or a WindowStore); each scene's ground truth
    is its label.npy. `timings`, if given, gets the seconds spent reading
    window files, assembling the sub-clouds, in the forward (to the votes
    on the host), reducing the votes and counting the stats, and the
    counts of windows, sub-clouds and points forwarded. `scene_outputs`, if
    given, gets {scene: (confidences, predictions)} per scene point."""
    from pvcnn_tpu_torch.models.s3dis import MODELS, save_path
    from pvcnn_tpu_torch.train.predict import predict
    from pvcnn_tpu_torch.train.trainer import check_device
    from pvcnn_tpu_torch.utils.weights import load_reference_checkpoint

    if num_points is None:
        num_points = MODELS[model_name].num_points
    if model is None:
        if checkpoint is None:
            checkpoint = os.path.join(
                save_path(model_name, width_multiplier, holdout_area),
                "best.pth.tar")
        if stats_path is None:
            stats_path = (checkpoint.removesuffix(".tar").removesuffix(".pth")
                          + ".eval.npy")
    if stats_path and os.path.exists(stats_path):
        stats = np.load(stats_path)
        print_stats(stats)
        return stats
    if model is None:
        if not os.path.exists(checkpoint):
            print(f"==> no checkpoint at {checkpoint}")
            return None
        print(f'==> loading checkpoint "{checkpoint}"')
        model = MODELS[model_name].build(width_multiplier)
        load_reference_checkpoint(model, checkpoint)
    device = check_device(device)
    model = model.to(device)

    rng = np.random.RandomState(seed)
    dataset = S3DIS(root, num_points, split="test",
                    holdout_area=holdout_area, opener=opener)["test"]
    spent = dict.fromkeys(("read", "assemble", "forward", "votes", "stats"),
                          0.0)
    spent.update(windows=0, sub_clouds=0, points=0)
    stats = np.zeros((3, NUM_CLASSES, len(dataset.scene_list)))
    for scene_index, (scene, scene_files) in enumerate(
            dataset.scene_list.items()):
        ground_truth = np.load(os.path.join(scene, "label.npy")).reshape(-1)
        total_scene_points = ground_truth.shape[0]
        confidences = np.zeros(total_scene_points, dtype=np.float32)
        predictions = np.full(total_scene_points, -1, dtype=np.int64)

        for filename in scene_files:
            start = time.perf_counter()
            window_file = opener(filename)
            try:
                scene_data = np.asarray(window_file.data, dtype=np.float32)
                scene_num_points = np.asarray(window_file.data_num,
                                              dtype=np.int64)
                mapping = np.asarray(window_file.indices_split_to_full,
                                     dtype=np.int64)
            finally:
                window_file.close()
            spent["read"] += time.perf_counter() - start

            num_windows, max_points_per_window, num_channels = scene_data.shape
            extra_batch = num_votes * math.ceil(max_points_per_window
                                                / num_points)
            total_voted = extra_batch * num_points
            for w0 in range(0, num_windows, batch_size):
                start = time.perf_counter()
                bs = min(w0 + batch_size, num_windows) - w0
                inputs = np.zeros((bs, total_voted, num_channels), np.float32)
                point_idx = np.zeros((bs, total_voted), np.int64)
                for wi in range(bs):
                    n_valid = scene_num_points[w0 + wi]
                    reps = math.ceil(total_voted / n_valid)
                    sel = np.tile(np.arange(n_valid), reps)[:total_voted]
                    rng.shuffle(sel)
                    inputs[wi] = scene_data[w0 + wi][sel]
                    point_idx[wi] = mapping[w0 + wi][sel]
                batch = torch.from_numpy(inputs.reshape(
                    bs * extra_batch, num_points, num_channels))
                spent["assemble"] += time.perf_counter() - start

                # no padding to one batch size (the JAX evaluator pads the
                # last chunk to keep one jit signature): in eval mode every
                # sub-cloud's output depends on that sub-cloud alone
                start = time.perf_counter()
                conf, pred = predict(model, batch.to(device)).max(-1)
                conf = conf.cpu().numpy().reshape(-1)
                pred = pred.cpu().numpy().reshape(-1)
                spent["forward"] += time.perf_counter() - start

                # one call for the batch's windows in order: the votes keep
                # the order of one call per window
                start = time.perf_counter()
                vote_reduce_max(conf, pred, point_idx.reshape(-1),
                                confidences, predictions)
                spent["votes"] += time.perf_counter() - start
                spent["windows"] += bs
                spent["sub_clouds"] += bs * extra_batch
                spent["points"] += bs * total_voted

        start = time.perf_counter()
        update_stats(stats, ground_truth, predictions, scene_index,
                     NUM_CLASSES)
        spent["stats"] += time.perf_counter() - start
        if scene_outputs is not None:
            scene_outputs[scene] = (confidences, predictions)

    if stats_path:
        os.makedirs(os.path.dirname(stats_path) or ".", exist_ok=True)
        np.save(stats_path, stats)
    print_stats(stats)
    if timings is not None:
        timings.update(spent)
    return stats


def evaluate_from_configs(configs):
    """The scene evaluation a config describes (configs.evaluate.fn; the
    JAX package's evaluate(configs)): the model configs.model() builds,
    with the weights of configs.evaluate.best_checkpoint_path (a trusted
    file, it is unpickled), on configs.device; the holdout area of
    configs.dataset.root with its num_points, holdout_area and opener
    (open_h5 unless the caller set one, e.g. a WindowStore);
    evaluate.num_votes and batch_size; the shuffles seeded with
    configs.seed. The stats go to evaluate.stats_path, where a later run
    finds and prints them. -> the stats, or None where the checkpoint is
    missing."""
    from pvcnn_tpu_torch.evaluate import configured_model

    stats_path = configs.evaluate.stats_path
    if os.path.exists(stats_path):
        stats = np.load(stats_path)
        print_stats(stats)
        return stats
    model = configured_model(configs)
    if model is None:
        return None
    dataset = configs.dataset
    return evaluate(dataset.root, model, num_points=dataset.num_points,
                    holdout_area=dataset.get("holdout_area", 5),
                    num_votes=configs.evaluate.num_votes,
                    batch_size=configs.evaluate.get("batch_size", 10),
                    stats_path=stats_path, device=configs.device,
                    seed=configs.get("seed") or 0,
                    opener=dataset.get("opener", open_h5))
