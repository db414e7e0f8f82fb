"""KITTI Frustum training meters (counterpart of
pvcnn_tpu/meters/kitti/frustum.py; reference meters/kitti/frustum.py:11-89):
the foreground accuracy, the mean box IoU in 2-D (bird's eye view) and
3-D, and the share of boxes over an IoU threshold (0.7, and per class 0.7
for cars, 0.5 for pedestrians and cyclists), numpy on the decoded boxes of
the port's dict outputs. Restated here so that the port imports nothing of
the JAX package (tests/test_torch_kitti_eval.py holds the two equal)."""

from __future__ import annotations

import numpy as np

from pvcnn_tpu_torch.data.kitti.frustum import box_corners_np
from pvcnn_tpu_torch.meters.kitti.utils import get_box_iou_3d

__all__ = ["MeterFrustumKitti"]


class MeterFrustumKitti:
    def __init__(self, num_heading_angle_bins, num_size_templates, size_templates,
                 class_name_to_class_id, metric="iou_3d"):
        assert metric in ("iou_2d", "iou_3d", "accuracy", "iou_3d_accuracy",
                          "iou_3d_class_accuracy")
        self.metric = metric
        self.num_heading_angle_bins = num_heading_angle_bins
        self.num_size_templates = num_size_templates
        self.size_templates = np.asarray(size_templates).reshape(
            num_size_templates, 3)
        self.heading_angle_bin_centers = np.arange(
            0, 2 * np.pi, 2 * np.pi / num_heading_angle_bins)
        self.class_name_to_class_id = class_name_to_class_id
        self.reset()

    def reset(self):
        self.total_seen_num = 0
        self.total_correct_num = 0
        self.iou_3d_correct_num = 0
        self.iou_2d_sum = 0.0
        self.iou_3d_sum = 0.0
        self.iou_3d_correct_num_per_class = {
            c: 0 for c in self.class_name_to_class_id}
        self.total_seen_num_per_class = {c: 0 for c in self.class_name_to_class_id}

    def update(self, outputs, targets):
        if self.metric == "accuracy":
            mask_logits = np.asarray(outputs["mask_logits"])    # [B, N, 2]
            mask_target = np.asarray(targets["mask_logits"])    # [B, N]
            self.total_seen_num += mask_target.size
            self.total_correct_num += int(
                np.sum(mask_logits.argmax(-1) == mask_target))
            return

        center = np.asarray(outputs["center"])
        heading_scores = np.asarray(outputs["heading_scores"])
        heading_residuals = np.asarray(outputs["heading_residuals"])
        size_scores = np.asarray(outputs["size_scores"])
        size_residuals = np.asarray(outputs["size_residuals"])

        center_target = np.asarray(targets["center"])
        heading_bin_id_target = np.asarray(targets["heading_bin_id"])
        heading_residual_target = np.asarray(targets["heading_residual"])
        size_template_id_target = np.asarray(targets["size_template_id"])
        size_residual_target = np.asarray(targets["size_residual"])
        class_id_target = np.asarray(targets["class_id"])

        batch = np.arange(center.shape[0])
        heading_bin_id = heading_scores.argmax(-1)
        heading = (self.heading_angle_bin_centers[heading_bin_id]
                   + heading_residuals[batch, heading_bin_id])
        size_template_id = size_scores.argmax(-1)
        size = (self.size_templates[size_template_id]
                + size_residuals[batch, size_template_id])
        corners = box_corners_np(center, heading, size)
        heading_target = (self.heading_angle_bin_centers[heading_bin_id_target]
                          + heading_residual_target)
        size_target = (self.size_templates[size_template_id_target]
                       + size_residual_target)
        corners_target = box_corners_np(center_target, heading_target,
                                        size_target)

        iou_3d, iou_2d = get_box_iou_3d(corners, corners_target)
        self.iou_2d_sum += iou_2d.sum()
        self.iou_3d_sum += iou_3d.sum()
        self.iou_3d_correct_num += int(np.sum(iou_3d >= 0.7))
        self.total_seen_num += center.shape[0]
        for cls, cls_id in self.class_name_to_class_id.items():
            mask = class_id_target == cls_id
            threshold = 0.7 if cls == "Car" else 0.5
            self.iou_3d_correct_num_per_class[cls] += int(
                np.sum(iou_3d[mask] >= threshold))
            self.total_seen_num_per_class[cls] += int(np.sum(mask))

    def compute(self):
        if self.metric == "iou_3d":
            return self.iou_3d_sum / self.total_seen_num
        if self.metric == "iou_2d":
            return self.iou_2d_sum / self.total_seen_num
        if self.metric == "accuracy":
            return self.total_correct_num / self.total_seen_num
        if self.metric == "iou_3d_accuracy":
            return self.iou_3d_correct_num / self.total_seen_num
        return sum(
            self.iou_3d_correct_num_per_class[c]
            / max(self.total_seen_num_per_class[c], 1)
            for c in self.class_name_to_class_id) / len(self.class_name_to_class_id)
