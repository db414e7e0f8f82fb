"""Frustum box-estimation heads and the center-regression T-Net
(counterpart of pvcnn_tpu/models/kitti/frustum/box_estimation.py;
reference models/kitti/frustum/box_estimation/{pointnet,pointnetpp}.py and
center_regression_net.py).

Input {"coords": [B, M, 3] foreground coords, "one_hot_vectors":
[B, num_classes]}. CenterRegressionNet gives the center correction
[B, 3]; the box heads give 3 + 2 NH + 4 NS box parameters a cloud.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pvcnn_tpu_torch.models.shapenet.pointnetpp import run_sa_layers
from pvcnn_tpu_torch.models.utils import (apply_layers, create_mlp_components,
                                          create_pointnet2_sa_components,
                                          create_pointnet_components)

__all__ = ["BoxEstimationPointNet", "BoxEstimationPointNet2",
           "CenterRegressionNet"]


def _head_width(num_heading_angle_bins: int, num_size_templates: int) -> int:
    return 3 + 2 * num_heading_angle_bins + 4 * num_size_templates


class CenterRegressionNet(nn.Module):
    """SharedMLP 128, 128, 256, the global max, then DenseBNReLU 256, 128
    and Linear 3 on [max, one-hot] (center_regression_net.py:10-32)."""

    blocks = (128, 128, 256)

    def __init__(self, num_classes: int = 3, width_multiplier: float = 1):
        super().__init__()
        layers, channels = create_mlp_components(
            3, self.blocks, classifier=False,
            width_multiplier=width_multiplier)
        self.features = nn.Sequential(*layers)
        layers, _ = create_mlp_components(
            channels + num_classes, [256, 128, 3], classifier=True, dim=1,
            width_multiplier=width_multiplier)
        self.regression = nn.Sequential(*layers)

    def forward(self, inputs: dict) -> torch.Tensor:
        h = self.features(inputs["coords"]).amax(dim=1)
        return self.regression(torch.cat([h, inputs["one_hot_vectors"]],
                                         dim=-1))


class BoxEstimationPointNet(nn.Module):
    """PointNet point blocks, the global max, then the box head
    (box_estimation/pointnet.py:10-47)."""

    blocks = ((128, 2, None), (256, 1, None), (512, 1, None))

    def __init__(self, num_classes: int = 3, num_heading_angle_bins: int = 12,
                 num_size_templates: int = 8, width_multiplier: float = 1):
        super().__init__()
        layers, channels_point, _ = create_pointnet_components(
            self.blocks, 3, with_se=False, normalize=True, eps=1e-15,
            width_multiplier=width_multiplier)
        self.features = nn.Sequential(*layers)
        layers, _ = create_mlp_components(
            channels_point + num_classes,
            [512, 256, _head_width(num_heading_angle_bins,
                                   num_size_templates)],
            classifier=True, dim=1, width_multiplier=width_multiplier)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs: dict) -> torch.Tensor:
        h = self.features(inputs["coords"]).amax(dim=1)
        return self.classifier(torch.cat([h, inputs["one_hot_vectors"]],
                                         dim=-1))


class BoxEstimationPointNet2(nn.Module):
    """PointNet++ set abstraction down to one feature a cloud, flattened,
    then the box head (box_estimation/pointnetpp.py:10-55)."""

    sa_blocks = (
        (None, (128, 0.2, 64, (64, 64, 128))),
        (None, (32, 0.4, 64, (128, 128, 256))),
        (None, (None, None, None, (256, 256, 512))),
    )

    def __init__(self, num_classes: int = 3, num_heading_angle_bins: int = 12,
                 num_size_templates: int = 8, width_multiplier: float = 1):
        super().__init__()
        sa_layers, _, channels_sa, num_centers = \
            create_pointnet2_sa_components(
                self.sa_blocks, 0, with_se=False,
                width_multiplier=width_multiplier)
        self.features = nn.ModuleList(sa_layers)
        layers, _ = create_mlp_components(
            channels_sa * num_centers + num_classes,
            [512, 256, _head_width(num_heading_angle_bins,
                                   num_size_templates)],
            classifier=True, dim=1, width_multiplier=width_multiplier)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs: dict) -> torch.Tensor:
        features, _, _, _ = run_sa_layers(self.features, None,
                                          inputs["coords"])
        features = features.reshape(features.shape[0], -1)
        return apply_layers(self.classifier,
                            torch.cat([features, inputs["one_hot_vectors"]],
                                      dim=-1))
