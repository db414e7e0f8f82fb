"""PVCNN for S3DIS semantic segmentation (counterpart of
pvcnn_tpu/models/s3dis/pvcnn.py, without the training presort: the presort
reorders points for the TPU's sorted kernels and computes the same
function; reference models/s3dis/pvcnn.py).

Input [B, N, 3 + extra_feature_channels] (S3DIS: xyz in the block, rgb,
room-normalized xyz); output [B, N, num_classes] logits. Four point blocks
(PVConvs at R = 32, 16, 16, 16 without SE, then a SharedMLP to 1024), a
per-cloud MLP on the max-pooled features, and a classifier over the
channel concat of every block output and the cloud feature.
"""

from __future__ import annotations

import torch.nn as nn

from pvcnn_tpu_torch.models.utils import (apply_layers, create_mlp_components,
                                          create_pointnet_components)
from pvcnn_tpu_torch.nn import PVConv

__all__ = ["PVCNN"]


class PVCNN(nn.Module):
    blocks = ((64, 1, 32), (64, 2, 16), (128, 1, 16), (1024, 1, None))

    def __init__(self, num_classes: int, extra_feature_channels: int = 6,
                 width_multiplier: float = 1,
                 voxel_resolution_multiplier: float = 1):
        super().__init__()
        self.in_channels = extra_feature_channels + 3
        layers, channels_point, concat_channels_point = \
            create_pointnet_components(
                blocks=self.blocks, in_channels=self.in_channels,
                with_se=False, width_multiplier=width_multiplier,
                voxel_resolution_multiplier=voxel_resolution_multiplier)
        self.point_features = nn.ModuleList(layers)
        layers, channels_cloud = create_mlp_components(
            in_channels=channels_point, out_channels=[256, 128],
            classifier=False, dim=1, width_multiplier=width_multiplier)
        self.cloud_features = nn.Sequential(*layers)
        layers, _ = create_mlp_components(
            in_channels=concat_channels_point + channels_cloud,
            out_channels=[512, 0.3, 256, 0.3, num_classes], classifier=True,
            width_multiplier=width_multiplier)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs):
        if isinstance(inputs, dict):
            inputs = inputs["features"]
        coords = inputs[..., :3]
        features, out_features_list = inputs, []
        for layer in self.point_features:
            if isinstance(layer, PVConv):
                features, _ = layer(features, coords)
            else:
                features = layer(features)
            out_features_list.append(features)
        cloud = apply_layers(self.cloud_features, features.amax(dim=1))
        # [B, 1, C]: the classifier's first layer broadcasts it instead of
        # tiling it over the points
        out_features_list.append(cloud[:, None, :])
        features = self.classifier[0](out_features_list)
        return apply_layers(self.classifier[1:], features)
