"""PointNet++ building blocks: the BallQuery grouper and the A/SA/FP modules
(counterpart of pvcnn_tpu/nn/pointnet.py; reference modules/ball_query.py,
modules/pointnet.py).

Channel-last throughout: the set abstraction's SharedMLP (dim=2, Conv2d
weights as in the reference) runs on grouped neighborhoods [B, M, U, C],
and the max over the neighbors is `amax`, which splits the gradient evenly
between tied maxima as JAX's max does (the first-hit fill repeats a
neighbor, so ties are common). Module names follow the reference
(`groupers`, `mlps`, `mlp`), so `state_dict()` keys match released
checkpoints.

Activation dtype (`dtype=`, as pvcnn_tpu/nn/pointnet.py's): the modules'
SharedMLPs run in bf16; neighbors, FPS centers and three-NN weights come
from the float32 coordinates. The concatenation of the float32 relative
coordinates (or float32 skip features) with bf16 features is float32, as
JAX promotes it, and the next Dense rounds it to bf16; its backward hands
the bf16 part a bf16 cotangent (autograd casts a gradient to its input's
dtype, as JAX's convert transposes), so take_rows sums it in K1's bf16 sum
mode. The BallQuery grouper itself has no dtype: it groups what it gets.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from pvcnn_tpu_torch import ops
from pvcnn_tpu_torch.nn.shared_mlp import SharedMLP

__all__ = ["BallQuery", "PointNetAModule", "PointNetFPModule",
           "PointNetSAModule"]


def _branches(out_channels) -> list:
    """A flat channel list or a list of per-branch lists -> list of lists."""
    if not isinstance(out_channels, (list, tuple)):
        return [[int(out_channels)]]
    if not isinstance(out_channels[0], (list, tuple)):
        return [[int(c) for c in out_channels]]
    return [[int(c) for c in oc] for oc in out_channels]


class BallQuery(nn.Module):
    def __init__(self, radius: float, num_neighbors: int,
                 include_coordinates: bool = True):
        super().__init__()
        self.radius = float(radius)
        self.num_neighbors = int(num_neighbors)
        self.include_coordinates = include_coordinates

    def forward(self, points_coords, centers_coords, points_features=None):
        """points [B, N, 3], centers [B, M, 3], features [B, N, C] ->
        neighborhoods [B, M, U, 3 + C] (coordinates relative to the center
        first), or [B, M, U, 3] without features."""
        idx = ops.ball_query(centers_coords, points_coords, self.radius,
                             self.num_neighbors)
        neighbor_coords = (ops.grouping(points_coords, idx)
                           - centers_coords[:, :, None, :])
        if points_features is None:
            if not self.include_coordinates:
                raise ValueError("BallQuery has no features to group")
            return neighbor_coords
        neighbor_features = ops.grouping(points_features, idx)
        if self.include_coordinates:
            return torch.cat([neighbor_coords, neighbor_features], dim=-1)
        return neighbor_features


class PointNetAModule(nn.Module):
    """Group-all set abstraction: features [B, N, C] (+ coords) -> one
    max-pooled feature per cloud [B, 1, C'] and a zero center."""

    def __init__(self, in_channels: int, out_channels,
                 include_coordinates: bool = True, dtype=None):
        super().__init__()
        branches = _branches(out_channels)
        extra = 3 if include_coordinates else 0
        self.mlps = nn.ModuleList([SharedMLP(in_channels + extra, oc,
                                             dtype=dtype)
                                   for oc in branches])
        self.include_coordinates = include_coordinates
        self.out_channels = sum(oc[-1] for oc in branches)

    def forward(self, features, coords):
        if self.include_coordinates:
            features = torch.cat([features, coords], dim=-1)
        outs = [mlp(features).amax(dim=1, keepdim=True) for mlp in self.mlps]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return out, coords.new_zeros((coords.shape[0], 1, 3))


class PointNetSAModule(nn.Module):
    """FPS centers + (multi-scale) ball-query grouping + SharedMLP + max
    over the neighbors: features [B, N, C], coords [B, N, 3] ->
    ([B, M, C'], centers [B, M, 3])."""

    def __init__(self, num_centers: int, radius, num_neighbors,
                 in_channels: int, out_channels,
                 include_coordinates: bool = True, dtype=None):
        super().__init__()
        radius = list(radius) if isinstance(radius, (list, tuple)) \
            else [radius]
        if not isinstance(num_neighbors, (list, tuple)):
            num_neighbors = [num_neighbors] * len(radius)
        branches = _branches(out_channels)
        if len(branches) == 1 and len(radius) > 1:
            branches = branches * len(radius)
        extra = 3 if include_coordinates else 0
        self.num_centers = int(num_centers)
        self.groupers = nn.ModuleList([
            BallQuery(r, u, include_coordinates)
            for r, u in zip(radius, num_neighbors)])
        self.mlps = nn.ModuleList([SharedMLP(in_channels + extra, oc, dim=2,
                                             dtype=dtype)
                                   for oc in branches])
        self.out_channels = sum(oc[-1] for oc in branches)

    def forward(self, features, coords):
        centers = ops.furthest_point_sample(coords, self.num_centers)
        outs = [mlp(grouper(coords, centers, features)).amax(dim=2)
                for grouper, mlp in zip(self.groupers, self.mlps)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return out, centers


class PointNetFPModule(nn.Module):
    """Feature propagation: three-NN interpolation of the center features
    onto the points, the skip features appended, then a SharedMLP."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 dtype=None):
        super().__init__()
        self.mlp = SharedMLP(in_channels, list(out_channels), dtype=dtype)

    def forward(self, points_coords, centers_coords, centers_features,
                points_features=None):
        """-> (features [B, N, C'], points_coords)."""
        out = ops.nearest_neighbor_interpolate(points_coords, centers_coords,
                                               centers_features)
        if points_features is not None:
            out = torch.cat([out, points_features], dim=-1)
        return self.mlp(out), points_coords
