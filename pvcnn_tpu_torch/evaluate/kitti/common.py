"""KITTI label-file IO and the evaluation of a folder of label files
(counterpart of pvcnn_tpu/evaluate/kitti/common.py; reference
evaluate/kitti/utils/common.py), restated here so that the port imports
nothing of the JAX package."""

from __future__ import annotations

import pathlib
import re

import numpy as np

from pvcnn_tpu_torch.evaluate.kitti.official_eval import (
    get_official_eval_result)

__all__ = ["eval_from_files", "get_label_annotation", "get_label_annotations"]


def get_label_annotation(label_path):
    annotations = {}
    with open(label_path) as f:
        content = [line.strip().split(" ") for line in f.readlines()]
    annotations["name"] = np.array([x[0] for x in content])
    annotations["truncated"] = np.array([float(x[1]) for x in content])
    annotations["occluded"] = np.array([int(float(x[2])) for x in content])
    annotations["alpha"] = np.array([float(x[3]) for x in content])
    annotations["bbox"] = np.array(
        [[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4)
    # stored hwl -> standard lhw (camera) order
    annotations["dimensions"] = np.array(
        [[float(v) for v in x[8:11]] for x in content]).reshape(-1, 3)[:, [2, 0, 1]]
    annotations["location"] = np.array(
        [[float(v) for v in x[11:14]] for x in content]).reshape(-1, 3)
    annotations["rotation_y"] = np.array(
        [float(x[14]) for x in content]).reshape(-1)
    if content and len(content[0]) == 16:
        annotations["score"] = np.array([float(x[15]) for x in content])
    else:
        annotations["score"] = np.zeros(len(annotations["bbox"]))
    return annotations


def get_label_annotations(label_folder, image_ids=None):
    if image_ids is None:
        prog = re.compile(r"^\d{6}.txt$")
        paths = filter(lambda f: prog.match(f.name),
                       pathlib.Path(label_folder).glob("*.txt"))
        image_ids = sorted(int(p.stem) for p in paths)
    if not isinstance(image_ids, list):
        image_ids = list(range(image_ids))
    folder = pathlib.Path(label_folder)
    return [get_label_annotation(folder / f"{idx:06d}.txt") for idx in image_ids]


def eval_from_files(prediction_folder, ground_truth_folder, image_ids=None,
                    verbose=False):
    prediction_annotations = get_label_annotations(prediction_folder)
    if isinstance(image_ids, str):
        with open(image_ids) as f:
            image_ids = [int(line) for line in f.readlines()]
    ground_truth_annotations = get_label_annotations(ground_truth_folder,
                                                     image_ids=image_ids)
    metrics, results, results_str = get_official_eval_result(
        gt_annos=ground_truth_annotations, dt_annos=prediction_annotations,
        current_classes=[0, 1, 2])
    if verbose:
        print(results_str)
    return metrics, results
