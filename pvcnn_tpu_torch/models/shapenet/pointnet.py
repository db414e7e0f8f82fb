"""PointNet for ShapeNet part segmentation, with the optional T-Net
(counterpart of pvcnn_tpu/models/shapenet/pointnet.py; reference
models/shapenet/pointnet.py).

Input [B, N, 3 + extra_feature_channels + num_shapes]: xyz (the config
gives no normals) and the one-hot shape id per point; output
[B, N, num_classes] logits. Five SharedMLP point blocks, a T-Net before the
first and the fourth with `with_transformer`, and a classifier over the
channel concat of the one-hot id, every block output and the global max.
Module names follow the reference, the T-Net's `tranformer` typo included.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pvcnn_tpu_torch.models.utils import apply_layers, create_mlp_components
from pvcnn_tpu_torch.nn import BatchNorm, SharedMLP
from pvcnn_tpu_torch.utils.dtype import fp32_only

__all__ = ["PointNet", "Transformer"]


class Transformer(nn.Module):
    """T-Net: a per-cloud [C, C] matrix W from the max-pooled features of
    three SharedMLPs and a Linear-BN-ReLU head; x [B, N, C] -> x (W + I)^T."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        self.features = nn.Sequential(SharedMLP(channels, 64),
                                      SharedMLP(64, 128),
                                      SharedMLP(128, 1024))
        self.tranformer = nn.Sequential(
            nn.Linear(1024, 512), BatchNorm(512), nn.ReLU(),
            nn.Linear(512, 256), BatchNorm(256), nn.ReLU(),
            nn.Linear(256, channels * channels))

    def forward(self, x):
        w = self.tranformer(self.features(x).amax(dim=1))
        w = w.view(-1, self.channels, self.channels) + torch.eye(
            self.channels, dtype=w.dtype, device=w.device)
        # the reference's bmm(W, x) on channel-major features
        return torch.bmm(x, w.transpose(1, 2))


class PointNet(nn.Module):
    # (T-Net before the first block, out channels, number of blocks)
    blocks = ((True, 64, 1), (False, 128, 2), (True, 512, 1),
              (False, 2048, 1))

    def __init__(self, num_classes: int, num_shapes: int,
                 with_transformer: bool = False,
                 extra_feature_channels: int = 0,
                 width_multiplier: float = 1, dtype=None):
        fp32_only(dtype, "ShapeNet PointNet")
        super().__init__()
        r = width_multiplier
        self.in_channels = in_channels = extra_feature_channels + 3
        self.num_shapes = num_shapes
        layers, concat_channels = [], 0
        for with_t, out_channels, num_blocks in self.blocks:
            out_channels = int(r * out_channels)
            for block in range(num_blocks):
                mlp = SharedMLP(in_channels, out_channels)
                if with_t and with_transformer and block == 0:
                    mlp = nn.Sequential(Transformer(in_channels), mlp)
                layers.append(mlp)
                in_channels = out_channels
                concat_channels += out_channels
        self.point_features = nn.ModuleList(layers)
        layers, _ = create_mlp_components(
            in_channels=num_shapes + concat_channels + in_channels,
            out_channels=[256, 0.2, 256, 0.2, 128, num_classes],
            classifier=True, width_multiplier=width_multiplier)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs):
        if inputs.shape[-1] != self.in_channels + self.num_shapes:
            raise ValueError(f"PointNet takes {self.in_channels} + "
                             f"{self.num_shapes} channels, got "
                             f"{inputs.shape[-1]}")
        features = inputs[..., :self.in_channels]
        out_features_list = [inputs[..., -self.num_shapes:]]
        for layer in self.point_features:
            features = layer(features)
            out_features_list.append(features)
        # [B, 1, C] global feature: the classifier's first layer broadcasts
        # it instead of tiling it over the points
        out_features_list.append(features.amax(dim=1, keepdim=True))
        features = self.classifier[0](out_features_list)
        return apply_layers(self.classifier[1:], features)
