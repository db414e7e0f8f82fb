"""Frustum instance-segmentation backbones (counterpart of
pvcnn_tpu/models/kitti/frustum/segmentation.py; reference
models/kitti/frustum/segmentation/{pointnet,pointnetpp}.py).

Input {"features": [B, N, 3 + extra], "one_hot_vectors": [B, num_classes]};
output mask logits [B, N, 2]. Module names follow the reference
(`point_features`, `cloud_features`, `classifier`; `sa_layers`,
`fp_layers`), so released checkpoints load as they are.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pvcnn_tpu_torch.models.shapenet.pointnetpp import (run_fp_layers,
                                                        run_sa_layers)
from pvcnn_tpu_torch.models.utils import (apply_layers, create_mlp_components,
                                          create_pointnet2_fp_modules,
                                          create_pointnet2_sa_components,
                                          create_pointnet_components)
from pvcnn_tpu_torch.nn import PVConv

__all__ = ["InstanceSegmentationNet", "InstanceSegmentationPVCNN",
           "InstanceSegmentationPointNet", "InstanceSegmentationPointNet2"]


def _run_blocks(layers, features, coords):
    for layer in layers:
        if isinstance(layer, PVConv):
            features, coords = layer(features, coords)
        else:
            features = layer(features)
    return features, coords


class InstanceSegmentationNet(nn.Module):
    """Point blocks, cloud blocks, the global max, then a per-point
    classifier on [one-hot, point features, global max]
    (segmentation/pointnet.py:10-44)."""

    def __init__(self, num_classes: int, point_blocks, cloud_blocks,
                 extra_feature_channels: int = 1,
                 width_multiplier: float = 1,
                 voxel_resolution_multiplier: float = 1):
        super().__init__()
        kw = dict(width_multiplier=width_multiplier,
                  voxel_resolution_multiplier=voxel_resolution_multiplier)
        layers, channels_point, _ = create_pointnet_components(
            point_blocks, extra_feature_channels + 3, **kw)
        self.point_features = nn.Sequential(*layers)
        layers, channels_cloud, _ = create_pointnet_components(
            cloud_blocks, channels_point, **kw)
        self.cloud_features = nn.Sequential(*layers)
        layers, _ = create_mlp_components(
            channels_point + channels_cloud + num_classes,
            [512, 256, 128, 128, 0.5, 2], classifier=True,
            width_multiplier=width_multiplier)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs: dict) -> torch.Tensor:
        features = inputs["features"]                      # [B, N, 3+extra]
        one_hot = inputs["one_hot_vectors"]                # [B, num_classes]
        point_features, coords = _run_blocks(self.point_features, features,
                                             features[..., :3])
        cloud_features, _ = _run_blocks(self.cloud_features, point_features,
                                        coords)
        # [B, 1, C] one-hot and global segments: the first layer broadcasts
        # them instead of tiling them over the points
        x = self.classifier[0]([one_hot[:, None, :], point_features,
                                cloud_features.amax(dim=1, keepdim=True)])
        return apply_layers(self.classifier[1:], x)


def InstanceSegmentationPointNet(num_classes: int = 3,
                                 extra_feature_channels: int = 1,
                                 width_multiplier: float = 1):
    return InstanceSegmentationNet(
        num_classes, point_blocks=((64, 3, None),),
        cloud_blocks=((128, 1, None), (1024, 1, None)),
        extra_feature_channels=extra_feature_channels,
        width_multiplier=width_multiplier)


def InstanceSegmentationPVCNN(num_classes: int = 3,
                              extra_feature_channels: int = 1,
                              width_multiplier: float = 1,
                              voxel_resolution_multiplier: float = 1):
    return InstanceSegmentationNet(
        num_classes,
        point_blocks=((64, 2, 16), (64, 1, 12), (128, 1, 12),
                      (1024, 1, None)),
        cloud_blocks=(), extra_feature_channels=extra_feature_channels,
        width_multiplier=width_multiplier,
        voxel_resolution_multiplier=voxel_resolution_multiplier)


class InstanceSegmentationPointNet2(nn.Module):
    """MSG set abstraction and feature propagation, with the one-hot class
    vector appended to the group-all level's features before the first
    feature propagation (segmentation/pointnetpp.py:10-71)."""

    sa_blocks = (
        (None, (128, [0.2, 0.4, 0.8], [32, 64, 128],
                [(32, 32, 64), (64, 64, 128), (64, 96, 128)])),
        (None, (32, [0.4, 0.8, 1.6], [64, 64, 128],
                [(64, 64, 128), (128, 128, 256), (128, 128, 256)])),
        (None, (None, None, None, (128, 256, 1024))),
    )
    fp_blocks = (((128, 128), None), ((128, 128), None), ((128, 128), None))

    def __init__(self, num_classes: int = 3, extra_feature_channels: int = 1,
                 width_multiplier: float = 1):
        super().__init__()
        sa_layers, sa_in_channels, channels_sa, _ = \
            create_pointnet2_sa_components(
                self.sa_blocks, extra_feature_channels,
                width_multiplier=width_multiplier)
        self.sa_layers = nn.ModuleList(sa_layers)
        sa_in_channels[-1] += num_classes
        fp_layers, channels_fp = create_pointnet2_fp_modules(
            self.fp_blocks, channels_sa, sa_in_channels,
            width_multiplier=width_multiplier)
        self.fp_layers = nn.ModuleList(fp_layers)
        layers, _ = create_mlp_components(channels_fp, [128, 0.3, 2],
                                          classifier=True,
                                          width_multiplier=width_multiplier)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs: dict) -> torch.Tensor:
        features = inputs["features"]
        one_hot = inputs["one_hot_vectors"]
        coords = features[..., :3]
        extra, coords, coords_list, in_features_list = run_sa_layers(
            self.sa_layers, features[..., 3:], coords)
        in_features_list[0] = features
        extra = torch.cat([extra, one_hot[:, None, :].expand(
            -1, extra.shape[1], -1)], dim=-1)
        extra, _ = run_fp_layers(self.fp_layers, coords_list,
                                 in_features_list, extra, coords)
        return apply_layers(self.classifier, extra)
