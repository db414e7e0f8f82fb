"""The Frustum detection pipeline: instance segmentation, foreground
resampling, center regression, box estimation (counterpart of
pvcnn_tpu/models/kitti/frustum/frustum_net.py; reference
models/kitti/frustum/frustum_net.py).

Input {"features": [B, N, 3 + extra], "one_hot_vectors": [B, num_classes]};
output the dict of frustum_net.py:81-92 (mask_logits [B, N, 2], center_reg,
center [B, 3], heading scores and residuals [B, NH], size scores [B, NS],
size residuals [B, NS, 3]). The foreground sampler (ops.logits_mask) draws
from `self.sample_generator`, a torch.Generator on the model's device that
the trainer sets (models/utils.py:set_sample_generator), in train and eval
mode alike, as the JAX model draws from its `sample` stream. Module names
follow the reference (`inst_seg_net`, `center_reg_net`, `box_est_net`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from pvcnn_tpu_torch.models.kitti.frustum.box_estimation import (
    BoxEstimationPointNet, BoxEstimationPointNet2, CenterRegressionNet)
from pvcnn_tpu_torch.models.kitti.frustum.segmentation import (
    InstanceSegmentationPointNet, InstanceSegmentationPointNet2,
    InstanceSegmentationPVCNN)
from pvcnn_tpu_torch.ops import sampling

__all__ = ["FrustumNet", "FrustumPVCNNE", "FrustumPointNet",
           "FrustumPointNet2"]


class FrustumNet(nn.Module):
    sample_generator: torch.Generator | None = None

    def __init__(self, inst_seg_net: nn.Module, box_est_net: nn.Module,
                 num_classes: int, num_heading_angle_bins: int,
                 num_size_templates: int, num_points_per_object: int,
                 size_templates, width_multiplier: float = 1):
        super().__init__()
        self.num_heading_angle_bins = int(num_heading_angle_bins)
        self.num_size_templates = int(num_size_templates)
        self.num_points_per_object = int(num_points_per_object)
        self.inst_seg_net = inst_seg_net
        self.center_reg_net = CenterRegressionNet(
            num_classes=num_classes, width_multiplier=width_multiplier)
        self.box_est_net = box_est_net
        # a buffer, as the reference's: its checkpoints hold it
        self.register_buffer("size_templates", torch.as_tensor(
            np.asarray(size_templates), dtype=torch.float32).reshape(
                1, self.num_size_templates, 3))

    def forward(self, inputs: dict) -> dict:
        features = inputs["features"]
        one_hot = inputs["one_hot_vectors"]
        mask_logits = self.inst_seg_net({"features": features,
                                         "one_hot_vectors": one_hot})
        foreground, foreground_mean, _ = sampling.logits_mask(
            features[..., :3], mask_logits, self.num_points_per_object,
            self.sample_generator)
        delta = self.center_reg_net({"coords": foreground,
                                     "one_hot_vectors": one_hot})
        foreground = foreground - delta[:, None, :]
        estimation = self.box_est_net({"coords": foreground,
                                       "one_hot_vectors": one_hot})

        nh, ns = self.num_heading_angle_bins, self.num_size_templates
        center_delta, heading_scores, heading_res_norm, size_scores, \
            size_res = estimation.split([3, nh, nh, ns, 3 * ns], dim=-1)
        templates = self.size_templates.to(estimation.dtype)
        size_res_norm = size_res.reshape(-1, ns, 3)
        center_reg = foreground_mean + delta
        return {"mask_logits": mask_logits,
                "center_reg": center_reg,
                "center": center_delta + center_reg,
                "heading_scores": heading_scores,
                "heading_residuals_normalized": heading_res_norm,
                "heading_residuals": heading_res_norm * (math.pi / nh),
                "size_scores": size_scores,
                "size_residuals_normalized": size_res_norm,
                "size_residuals": size_res_norm * templates}


def _net(make_seg, make_box, num_classes, num_heading_angle_bins,
         num_size_templates, num_points_per_object, size_templates,
         width_multiplier):
    wm = (list(width_multiplier)
          if isinstance(width_multiplier, (list, tuple))
          else [width_multiplier] * 3)
    box = make_box(num_classes=num_classes,
                   num_heading_angle_bins=num_heading_angle_bins,
                   num_size_templates=num_size_templates,
                   width_multiplier=wm[2])
    return FrustumNet(make_seg(wm[0]), box, num_classes,
                      num_heading_angle_bins, num_size_templates,
                      num_points_per_object, size_templates, wm[1])


def FrustumPointNet(num_classes, num_heading_angle_bins, num_size_templates,
                    num_points_per_object, size_templates,
                    extra_feature_channels=1, width_multiplier=1):
    return _net(lambda wm: InstanceSegmentationPointNet(
        num_classes, extra_feature_channels, wm), BoxEstimationPointNet,
        num_classes, num_heading_angle_bins, num_size_templates,
        num_points_per_object, size_templates, width_multiplier)


def FrustumPointNet2(num_classes, num_heading_angle_bins, num_size_templates,
                     num_points_per_object, size_templates,
                     extra_feature_channels=1, width_multiplier=1):
    return _net(lambda wm: InstanceSegmentationPointNet2(
        num_classes, extra_feature_channels, wm), BoxEstimationPointNet2,
        num_classes, num_heading_angle_bins, num_size_templates,
        num_points_per_object, size_templates, width_multiplier)


def FrustumPVCNNE(num_classes, num_heading_angle_bins, num_size_templates,
                  num_points_per_object, size_templates,
                  extra_feature_channels=1, width_multiplier=1,
                  voxel_resolution_multiplier=1):
    return _net(lambda wm: InstanceSegmentationPVCNN(
        num_classes, extra_feature_channels, wm,
        voxel_resolution_multiplier), BoxEstimationPointNet,
        num_classes, num_heading_angle_bins, num_size_templates,
        num_points_per_object, size_templates, width_multiplier)
