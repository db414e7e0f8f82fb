"""PVCNN++ (PVCNN2) for S3DIS semantic segmentation: the PointNet++ SA/FP
skeleton with PVConv blocks before each set abstraction and after each
feature propagation (counterpart of pvcnn_tpu/models/s3dis/pvcnnpp.py;
reference models/s3dis/pvcnnpp.py).

Input [B, N, 3 + extra_feature_channels] (S3DIS: xyz in the block, rgb,
room-normalized xyz); output [B, N, num_classes] logits. The first SA group
sees all input channels; the last FP skip takes only the extra features.
Every PVConv uses SE, normalize=True and eps=0. `sa_blocks`/`fp_blocks` are
class attributes, so a subclass can shrink them. `dtype` is the
activation dtype of every module (bfloat16: bf16 activations, float32
parameters; the logits come out bf16, as the JAX model's).
"""

from __future__ import annotations

import torch.nn as nn

from pvcnn_tpu_torch.models.shapenet.pointnetpp import (run_fp_layers,
                                                        run_sa_layers)
from pvcnn_tpu_torch.models.utils import (apply_layers, create_mlp_components,
                                          create_pointnet2_fp_modules,
                                          create_pointnet2_sa_components)
from pvcnn_tpu_torch.utils.dtype import resolve_dtype

__all__ = ["PVCNN2"]


class PVCNN2(nn.Module):
    sa_blocks = (
        ((32, 2, 32), (1024, 0.1, 32, (32, 64))),
        ((64, 3, 16), (256, 0.2, 32, (64, 128))),
        ((128, 3, 8), (64, 0.4, 32, (128, 256))),
        (None, (16, 0.8, 32, (256, 256, 512))),
    )
    fp_blocks = (
        ((256, 256), (256, 1, 8)),
        ((256, 256), (256, 1, 8)),
        ((256, 128), (128, 2, 16)),
        ((128, 128, 64), (64, 1, 32)),
    )

    def __init__(self, num_classes: int, extra_feature_channels: int = 6,
                 width_multiplier: float = 1,
                 voxel_resolution_multiplier: float = 1, dtype=None):
        super().__init__()
        self.act_dtype = resolve_dtype(dtype)
        self.in_channels = extra_feature_channels + 3
        sa_layers, sa_in_channels, channels_sa, _ = \
            create_pointnet2_sa_components(
                self.sa_blocks, extra_feature_channels, with_se=True,
                width_multiplier=width_multiplier,
                voxel_resolution_multiplier=voxel_resolution_multiplier,
                dtype=dtype)
        self.sa_layers = nn.ModuleList(sa_layers)
        # only the raw extra features feed the last FP skip
        sa_in_channels[0] = extra_feature_channels
        fp_layers, channels_fp = create_pointnet2_fp_modules(
            self.fp_blocks, channels_sa, sa_in_channels, with_se=True,
            width_multiplier=width_multiplier,
            voxel_resolution_multiplier=voxel_resolution_multiplier,
            dtype=dtype)
        self.fp_layers = nn.ModuleList(fp_layers)
        layers, _ = create_mlp_components(
            channels_fp, [128, 0.5, num_classes], classifier=True,
            width_multiplier=width_multiplier, dtype=dtype)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs):
        if isinstance(inputs, dict):
            inputs = inputs["features"]
        coords = inputs[..., :3]
        features, coords, coords_list, in_features_list = run_sa_layers(
            self.sa_layers, inputs, coords)
        in_features_list[0] = inputs[..., 3:]
        features, _ = run_fp_layers(self.fp_layers, coords_list,
                                    in_features_list, features, coords)
        return apply_layers(self.classifier, features)
