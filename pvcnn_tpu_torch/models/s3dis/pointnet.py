"""PointNet for S3DIS semantic segmentation (counterpart of
pvcnn_tpu/models/s3dis/pointnet.py; reference models/s3dis/pointnet.py).

Input [B, N, 3 + extra_feature_channels] (S3DIS: xyz in the block, rgb,
room-normalized xyz); output [B, N, num_classes] logits. Five SharedMLP
point blocks (64 x 3, 128, 1024), a per-cloud MLP (256, 128) on their
max-pooled output, and a classifier over the last point features and the
cloud feature.
"""

from __future__ import annotations

import torch.nn as nn

from pvcnn_tpu_torch.models.utils import (apply_layers, create_mlp_components,
                                          create_pointnet_components)

__all__ = ["PointNet"]


class PointNet(nn.Module):
    blocks = ((64, 3, None), (128, 1, None), (1024, 1, None))

    def __init__(self, num_classes: int, extra_feature_channels: int = 6,
                 width_multiplier: float = 1):
        super().__init__()
        self.in_channels = extra_feature_channels + 3
        layers, channels_point, _ = create_pointnet_components(
            blocks=self.blocks, in_channels=self.in_channels,
            width_multiplier=width_multiplier)
        self.point_features = nn.Sequential(*layers)
        layers, channels_cloud = create_mlp_components(
            in_channels=channels_point, out_channels=[256, 128],
            classifier=False, dim=1, width_multiplier=width_multiplier)
        self.cloud_features = nn.Sequential(*layers)
        layers, _ = create_mlp_components(
            in_channels=channels_point + channels_cloud,
            out_channels=[512, 256, 0.3, num_classes], classifier=True,
            width_multiplier=width_multiplier)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs):
        if isinstance(inputs, dict):
            inputs = inputs["features"]
        point_features = self.point_features(inputs)
        cloud = self.cloud_features(point_features.amax(dim=1))
        # [B, 1, C]: the classifier's first layer broadcasts it instead of
        # tiling it over the points
        features = self.classifier[0]([point_features, cloud[:, None, :]])
        return apply_layers(self.classifier[1:], features)
