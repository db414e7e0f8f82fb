"""The PointNet++ stack runners shared by the PointNet++ family (counterpart
of pvcnn_tpu/models/shapenet/pointnetpp.py:run_sa_layers / run_fp_layers,
where the JAX package keeps them; its PointNet2 classes are not ported
yet)."""

from __future__ import annotations

import torch.nn as nn

from pvcnn_tpu_torch.nn import (PointNetAModule, PointNetFPModule,
                                PointNetSAModule, PVConv)

__all__ = ["run_fp_layers", "run_sa_layers"]


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
