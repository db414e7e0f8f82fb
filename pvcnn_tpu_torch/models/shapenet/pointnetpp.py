"""PointNet++ SSG/MSG for ShapeNet part segmentation, and the PointNet++
stack runners the PointNet++ family shares (counterpart of
pvcnn_tpu/models/shapenet/pointnetpp.py; reference
models/shapenet/pointnetpp.py).

Input [B, N, 6 (+ num_shapes)]: xyz, normals (and the one-hot shape id per
point, MSG); output [B, N, num_classes] logits. The set-abstraction stack
sees the normals, the coordinates apart; the last feature-propagation skip
takes the whole input. Module names follow the reference (`sa_layers`,
`fp_layers`, `classifier`), so released checkpoints load as they are.
"""

from __future__ import annotations

import torch.nn as nn

from pvcnn_tpu_torch.models.utils import (apply_layers, create_mlp_components,
                                          create_pointnet2_fp_modules,
                                          create_pointnet2_sa_components)
from pvcnn_tpu_torch.nn import (PointNetAModule, PointNetFPModule,
                                PointNetSAModule, PVConv)

__all__ = ["MSG_FP_BLOCKS", "MSG_SA_BLOCKS", "PointNet2", "PointNet2MSG",
           "PointNet2SSG", "SSG_FP_BLOCKS", "SSG_SA_BLOCKS", "pointnet2_msg",
           "pointnet2_ssg", "run_fp_layers", "run_sa_layers"]

# (conv_configs | None, (num_centers, radius, num_neighbors, out_channels))
# per set abstraction; (mlp channels, conv_configs | None) per feature
# propagation; a list of radii, neighbor counts and channel lists is a
# multi-scale grouping, num_centers None the group-all level
SSG_SA_BLOCKS = (
    (None, (512, 0.2, 64, (64, 64, 128))),
    (None, (128, 0.4, 64, (128, 128, 256))),
    (None, (None, None, None, (256, 512, 1024))),
)
SSG_FP_BLOCKS = (((256, 256), None), ((256, 128), None),
                 ((128, 128, 128), None))
MSG_SA_BLOCKS = (
    (None, (512, [0.1, 0.2, 0.4], [32, 64, 128],
            [(32, 32, 64), (64, 64, 128), (64, 96, 128)])),
    (None, (128, [0.4, 0.8], [64, 128], [(128, 128, 256), (128, 196, 256)])),
    (None, (None, None, None, (256, 512, 1024))),
)
MSG_FP_BLOCKS = (((256, 256), None), ((256, 128), None),
                 ((128, 128, 128), None))


def _members(group):
    return list(group) if isinstance(group, nn.Sequential) else [group]


def run_sa_layers(sa_layers, features, coords):
    """Run the set-abstraction groups -> (features, coords, coords_list,
    in_features_list): each group's input coordinates and features, for the
    skips of the feature-propagation stack."""
    coords_list, in_features_list = [], []
    for group in sa_layers:
        in_features_list.append(features)
        coords_list.append(coords)
        for layer in _members(group):
            if isinstance(layer, (PVConv, PointNetAModule,
                                  PointNetSAModule)):
                features, coords = layer(features, coords)
            else:
                features = layer(features)
    return features, coords, coords_list, in_features_list


def run_fp_layers(fp_layers, coords_list, in_features_list, features,
                  coords):
    """Run the feature-propagation groups, skips indexed from the back ->
    (features, coords)."""
    for fp_idx, group in enumerate(fp_layers):
        fp_module, *rest = _members(group)
        if not isinstance(fp_module, PointNetFPModule):
            raise TypeError("a feature-propagation group starts with a "
                            f"PointNetFPModule, got {type(fp_module)}")
        features, coords = fp_module(coords_list[-1 - fp_idx], coords,
                                     features, in_features_list[-1 - fp_idx])
        for layer in rest:
            if isinstance(layer, PVConv):
                features, coords = layer(features, coords)
            else:
                features = layer(features)
    return features, coords


class PointNet2(nn.Module):
    def __init__(self, num_classes: int, num_shapes: int, sa_blocks,
                 fp_blocks, with_one_hot_shape_id: bool = True,
                 extra_feature_channels: int = 3,
                 width_multiplier: float = 1,
                 voxel_resolution_multiplier: float = 1):
        super().__init__()
        self.in_channels = extra_feature_channels + 3
        self.num_shapes = num_shapes
        self.with_one_hot_shape_id = with_one_hot_shape_id
        sa_layers, sa_in_channels, channels_sa, _ = \
            create_pointnet2_sa_components(
                sa_blocks, extra_feature_channels,
                width_multiplier=width_multiplier)
        self.sa_layers = nn.ModuleList(sa_layers)
        # the last skip takes the whole input, one-hot shape id included
        if with_one_hot_shape_id:
            sa_in_channels[0] += num_shapes
        fp_layers, channels_fp = create_pointnet2_fp_modules(
            fp_blocks, channels_sa, sa_in_channels,
            width_multiplier=width_multiplier,
            voxel_resolution_multiplier=voxel_resolution_multiplier)
        self.fp_layers = nn.ModuleList(fp_layers)
        layers, _ = create_mlp_components(
            channels_fp, [128, 0.5, num_classes], classifier=True,
            width_multiplier=width_multiplier)
        self.classifier = nn.Sequential(*layers)

    def forward(self, inputs):
        features = inputs[..., :self.in_channels]
        if self.with_one_hot_shape_id:
            if inputs.shape[-1] != self.in_channels + self.num_shapes:
                raise ValueError(f"PointNet2 takes {self.in_channels} + "
                                 f"{self.num_shapes} channels, got "
                                 f"{inputs.shape[-1]}")
            skip = inputs
        else:
            skip = features
        coords = features[..., :3]
        features, coords, coords_list, in_features_list = run_sa_layers(
            self.sa_layers, features[..., 3:], coords)
        in_features_list[0] = skip
        features, _ = run_fp_layers(self.fp_layers, coords_list,
                                    in_features_list, features, coords)
        return apply_layers(self.classifier, features)


class PointNet2SSG(PointNet2):
    pass


class PointNet2MSG(PointNet2):
    pass


def pointnet2_ssg(num_classes: int, num_shapes: int,
                  extra_feature_channels: int = 3,
                  width_multiplier: float = 1,
                  voxel_resolution_multiplier: float = 1) -> PointNet2SSG:
    """Single-scale grouping, without the one-hot shape id."""
    return PointNet2SSG(num_classes, num_shapes, SSG_SA_BLOCKS, SSG_FP_BLOCKS,
                        with_one_hot_shape_id=False,
                        extra_feature_channels=extra_feature_channels,
                        width_multiplier=width_multiplier,
                        voxel_resolution_multiplier=voxel_resolution_multiplier)


def pointnet2_msg(num_classes: int, num_shapes: int,
                  extra_feature_channels: int = 3,
                  width_multiplier: float = 1,
                  voxel_resolution_multiplier: float = 1) -> PointNet2MSG:
    """Multi-scale grouping, with the one-hot shape id."""
    return PointNet2MSG(num_classes, num_shapes, MSG_SA_BLOCKS, MSG_FP_BLOCKS,
                        with_one_hot_shape_id=True,
                        extra_feature_channels=extra_feature_channels,
                        width_multiplier=width_multiplier,
                        voxel_resolution_multiplier=voxel_resolution_multiplier)
