"""PVCNN for ShapeNet part segmentation (counterpart of
pvcnn_tpu/models/shapenet/pvcnn.py, without the training presort: the
presort reorders points for the TPU's sorted kernels and computes the same
function).

Input [B, N, in_channels + num_shapes]: xyz, normals and the one-hot shape
id per point. Output [B, N, num_classes] logits.

dtype (None, "float32", "bfloat16" or a torch dtype; the JAX model's
`dtype`, --configs.model.dtype): with bfloat16 the activations run in bf16
and the logits are bf16, while the parameters, BatchNorm statistics and
their gradients stay float32 (nn/shared_mlp.py). The input stays float32
up to the first PVConv: its voxelized mean is float32 (K1 in fp32) and its
conv casts it (nn/conv3d.py), as in the JAX model, whose
models/shapenet/pvcnn.py:42-44 casts nothing; every later K1-K5 launch is
bf16. Coordinates stay float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from pvcnn_tpu_torch.models.utils import (apply_layers, create_mlp_components,
                                          create_pointnet_components)
from pvcnn_tpu_torch.nn import PVConv
from pvcnn_tpu_torch.utils.dtype import resolve_dtype

__all__ = ["PVCNN"]


class PVCNN(nn.Module):
    blocks = ((64, 1, 32), (128, 2, 16), (512, 1, None), (2048, 1, None))

    def __init__(self, num_classes: int, num_shapes: int,
                 extra_feature_channels: int = 3, width_multiplier: float = 1,
                 voxel_resolution_multiplier: float = 1, dtype=None):
        super().__init__()
        self.act_dtype = resolve_dtype(dtype)
        self.in_channels = extra_feature_channels + 3
        self.num_shapes = num_shapes
        layers, channels_point, concat_channels_point = \
            create_pointnet_components(
                blocks=self.blocks, in_channels=self.in_channels,
                with_se=True, normalize=False,
                width_multiplier=width_multiplier,
                voxel_resolution_multiplier=voxel_resolution_multiplier,
                dtype=dtype)
        self.point_features = nn.ModuleList(layers)
        layers, _ = create_mlp_components(
            in_channels=num_shapes + channels_point + concat_channels_point,
            out_channels=[256, 0.2, 256, 0.2, 128, num_classes],
            classifier=True, width_multiplier=width_multiplier, dtype=dtype)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs: torch.Tensor):
        features = inputs[..., :self.in_channels]
        one_hot_vectors = inputs[..., -self.num_shapes:]
        coords = features[..., :3]
        out_features_list = [one_hot_vectors]
        for layer in self.point_features:
            if isinstance(layer, PVConv):
                features, _ = layer(features, coords)
            else:
                features = layer(features)
            out_features_list.append(features)
        # [B, 1, C] global feature: the classifier's first layer broadcasts
        # it instead of tiling it over the points
        out_features_list.append(features.amax(dim=1, keepdim=True))
        features = self.classifier[0](out_features_list)
        return apply_layers(self.classifier[1:], features)
