"""ShapeNet whole-shape voting evaluation (counterpart of
pvcnn_tpu/evaluate/shapenet/eval.py).

Protocol: for each full-resolution test shape, tile and shuffle its P points
into num_votes * ceil(P / N) sub-clouds of N points, predict every sub-cloud
in fixed-size padded batches, and keep for each original point the
prediction of its highest-confidence vote, with the argmax restricted to the
shape's part-class range. Reports per-class and mean IoU.

The IoU update is the JAX evaluator's numpy code, restated here so that the
port imports nothing of the JAX package; the item tables are parsed by
the host library (native.loadtxt), as JAX's are; the vote reduction is
evaluate/votes.py's, which the S3DIS evaluator shares
(tests/test_torch_model.py holds both equal to JAX's).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from pvcnn_tpu_torch import native
from pvcnn_tpu_torch.data import shapenet as shapenet_data
from pvcnn_tpu_torch.evaluate.votes import vote_reduce_max

__all__ = ["evaluate", "evaluate_with", "mean_iou", "part_class_ranges",
           "print_stats", "update_stats"]


def part_class_ranges():
    """part class -> (start, end) class range of its shape category."""
    out = []
    for _, parts in shapenet_data.SHAPE_PART_CLASSES:
        out += [(parts[0], parts[-1] + 1)] * len(parts)
    return out


def update_stats(stats, ground_truth, predictions, shape_id, start_class,
                 end_class):
    iou = 0.0
    for i in range(start_class, end_class):
        igt = ground_truth == i
        ipd = predictions == i
        union = np.sum(igt | ipd)
        iou += 1.0 if union == 0 else np.sum(igt & ipd) / union
    iou /= end_class - start_class
    stats[shape_id][0] += iou
    stats[shape_id][1] += 1


def evaluate_with(predict_fn, root: str, num_points: int = 2048,
                  num_votes: int = 10, batch_size: int = 32, seed: int = 0,
                  with_normal: bool = True,
                  with_one_hot_shape_id: bool = True):
    """Run the voting protocol over the test split of the ShapeNet tree at
    `root`. predict_fn maps a [batch_size, num_points, C] float32 numpy
    batch to [batch_size, num_points, 50] probabilities, where the C
    columns are xyz, then the normals (with_normal) and the one-hot shape
    id (with_one_hot_shape_id). -> stats [num_shapes, 2]: per shape
    category the IoU sum and the shape count."""
    rng = np.random.RandomState(seed)
    ranges = part_class_ranges()
    stats = np.zeros((shapenet_data.NUM_SHAPES, 2))
    for file_path, shape_id in shapenet_data.file_paths(root, "test"):
        data = native.loadtxt(file_path)
        total_points = data.shape[0]
        confidences = np.zeros(total_points, dtype=np.float32)
        predictions = np.full(total_points, -1, dtype=np.int64)
        coords = shapenet_data.normalize_point_cloud(data[:, :3])
        ground_truth = data[:, -1].astype(np.int64)
        columns = [coords]
        if with_normal:
            columns.append(data[:, 3:6])
        if with_one_hot_shape_id:
            one_hot = np.zeros((total_points, shapenet_data.NUM_SHAPES),
                               np.float32)
            one_hot[:, shape_id] = 1.0
            columns.append(one_hot)
        point_set = np.concatenate(columns, axis=-1).astype(np.float32)

        extra_batch = num_votes * math.ceil(total_points / num_points)
        total_voted = extra_batch * num_points
        num_repeats = math.ceil(total_voted / total_points)
        shuffled = np.tile(np.arange(total_points), num_repeats)[:total_voted]
        rng.shuffle(shuffled)
        start_class, end_class = ranges[int(ground_truth[0])]

        sub_clouds = point_set[shuffled].reshape(extra_batch, num_points, -1)
        vote_conf = np.zeros(total_voted, dtype=np.float32)
        vote_pred = np.zeros(total_voted, dtype=np.int64)
        for start in range(0, extra_batch, batch_size):
            chunk = sub_clouds[start:start + batch_size]
            true_bs = chunk.shape[0]
            if true_bs < batch_size:           # pad: one batch shape only
                pad = np.repeat(chunk[:1], batch_size - true_bs, axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            probs = np.asarray(predict_fn(chunk))[:true_bs]
            probs = probs[:, :, start_class:end_class]
            flat = slice(start * num_points, (start + true_bs) * num_points)
            vote_conf[flat] = probs.max(-1).reshape(-1)
            vote_pred[flat] = probs.argmax(-1).reshape(-1) + start_class

        vote_reduce_max(vote_conf, vote_pred, shuffled, confidences,
                        predictions)
        update_stats(stats, ground_truth, predictions, shape_id, start_class,
                     end_class)
    return stats


def evaluate(root: str, model: torch.nn.Module | None = None, *,
             model_name: str = "pvcnn", checkpoint: str | None = None,
             width_multiplier: float = 1.0, num_points: int = 2048,
             num_votes: int = 10, batch_size: int = 32,
             device: str = "cuda", seed: int = 0,
             stats_path: str | None = None):
    """Voting evaluation of a ShapeNet model on the test split at `root`.

    `model_name` names the model in models.shapenet.MODELS (pvcnn,
    pointnet, pointnet2ssg, pointnet2msg): its input columns are the ones
    its JAX config's dataset gives it. Without `model`, builds that model
    at `width_multiplier` with weights from a reference `.pth.tar`
    `checkpoint` (a trusted file: it is unpickled) or, without one, from a
    torch.Generator seeded with `seed`. Returns the stats array and prints
    the IoUs; saves the stats to `stats_path` if given."""
    from pvcnn_tpu_torch.models.shapenet import MODELS
    from pvcnn_tpu_torch.train.predict import predict
    from pvcnn_tpu_torch.utils.weights import (init_random_,
                                               load_reference_checkpoint)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    spec = MODELS[model_name]
    if model is None:
        model = spec.build(shapenet_data.NUM_CLASSES,
                           shapenet_data.NUM_SHAPES, width_multiplier)
        if checkpoint is not None:
            load_reference_checkpoint(model, checkpoint)
        else:
            init_random_(model, seed)
    model = model.to(device)

    def predict_fn(chunk):
        inputs = torch.from_numpy(chunk).to(device)
        return predict(model, inputs).cpu().numpy()

    stats = evaluate_with(predict_fn, root, num_points=num_points,
                          num_votes=num_votes, batch_size=batch_size,
                          seed=seed, with_normal=spec.with_normal,
                          with_one_hot_shape_id=spec.with_one_hot_shape_id)
    if stats_path:
        os.makedirs(os.path.dirname(stats_path) or ".", exist_ok=True)
        np.save(stats_path, stats)
    print_stats(stats)
    return stats


def mean_iou(stats) -> float:
    return float(stats[:, 0].sum() / max(stats[:, 1].sum(), 1))


def print_stats(stats):
    with np.errstate(invalid="ignore"):
        print("clssIoU: {}".format("  ".join(map(
            "{:>8.2f}".format,
            stats[:, 0] / np.maximum(stats[:, 1], 1) * 100))))
    print("meanIoU: {:4.2f}".format(mean_iou(stats) * 100))
