"""PVConv: the point-voxel convolution block, with Voxelization and SE3d
(counterpart of pvcnn_tpu/nn/pvconv.py).

Two voxel branches, as in the JAX package. By default (PVCNN_TPU_CONV_ROWS
auto) the flat-rows branch: the grid stays channel-major and flat,
[B, C, R^3], from the scatter-mean to the trilinear gather (K1 writes it in
that layout, K3 reads and writes it, K2 reads it through strides). It is
fused by default; with PVCNN_TPU_CONV_BN_FUSED=0 it runs unfused: K3 without
its prologue and statistics, then BatchNorm and LeakyReLU as passes of their
own, twice. With PVCNN_TPU_CONV_ROWS=0 (which takes precedence) the unfused
NDHWC branch: K1 and K2 in their channel-last modes around
Conv3dSame.ndhwc -> BatchNorm -> LeakyReLU twice.
Module names follow the reference (voxel_layers.0/1/3/4/6, point_features)
on both branches, so `state_dict()` keys match released checkpoints.
"""

from __future__ import annotations

import torch.nn as nn

from pvcnn_tpu_torch import ops
from pvcnn_tpu_torch.nn.conv3d import Conv3dSame
from pvcnn_tpu_torch.nn.shared_mlp import BatchNorm, SharedMLP
from pvcnn_tpu_torch.utils import knobs

__all__ = ["PVConv", "SE3d", "Voxelization"]


class Voxelization(nn.Module):
    def __init__(self, resolution: int, normalize: bool = True,
                 eps: float = 0.0):
        super().__init__()
        self.resolution = int(resolution)
        self.normalize = normalize
        self.eps = eps

    def forward(self, features, coords, channels_first: bool = True):
        """features [B, N, C], coords [B, N, 3] -> (grid rows [B, C, R^3],
        or [B, R^3, C] without channels_first, norm_coords [B, N, 3])."""
        vox_coords, norm_coords = ops.normalize_coords(
            coords, self.resolution, normalize=self.normalize, eps=self.eps)
        flat = ops.flat_voxel_index(vox_coords, self.resolution)
        grid = ops.scatter_mean(features, flat, self.resolution ** 3,
                                channels_first=channels_first)
        return grid, norm_coords


class SE3d(nn.Module):
    """Squeeze-and-excitation over the voxel grid (reference modules/se.py)."""

    def __init__(self, channels: int, reduction: int = 8):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid())

    def forward(self, x):
        """x [B, C, R^3] rows or [B, R, R, R, C] grid -> x scaled per
        (cloud, channel)."""
        if x.dim() == 5:
            return x * self.fc(x.mean(dim=(1, 2, 3)))[:, None, None, None, :]
        return x * self.fc(x.mean(dim=2))[:, :, None]


class PVConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, resolution: int = 32,
                 with_se: bool = False, normalize: bool = True,
                 eps: float = 0.0):
        super().__init__()
        self.resolution = int(resolution)
        self.voxelization = Voxelization(resolution, normalize, eps)
        layers = [Conv3dSame(in_channels, out_channels, kernel_size),
                  BatchNorm(out_channels, eps=1e-4), nn.LeakyReLU(0.1),
                  Conv3dSame(out_channels, out_channels, kernel_size),
                  BatchNorm(out_channels, eps=1e-4), nn.LeakyReLU(0.1)]
        if with_se:
            layers.append(SE3d(out_channels))
        self.voxel_layers = nn.Sequential(*layers)
        self.point_features = SharedMLP(in_channels, out_channels)

    def forward(self, features, coords):
        """features [B, N, C], coords [B, N, 3] -> (fused [B, N, C'], coords).

        With PVCNN_TPU_CONV_ROWS=0 the voxel branch is the NDHWC one
        (_voxel_ndhwc); with PVCNN_TPU_CONV_BN_FUSED=0 the unfused rows one
        (_rows_unfused). Otherwise it is fused as in the JAX package: conv0,
        then conv1 with BatchNorm 0's folded affine and LeakyReLU as its
        input prologue, then BatchNorm 1 and LeakyReLU as one elementwise
        pass, then SE and the trilinear gather. In eval mode the BatchNorms fold their running
        statistics; in train mode each conv also returns its output's
        per-channel sums, and its BatchNorm folds those batch statistics
        (updating its running ones)."""
        if knobs.get("PVCNN_TPU_CONV_ROWS") == "0":
            voxel_features = self._voxel_ndhwc(features, coords)
            return voxel_features + self.point_features(features), coords
        r = self.resolution
        conv0, bn0, _, conv1, bn1, _ = self.voxel_layers[:6]
        grid, norm_coords = self.voxelization(features, coords)
        if knobs.get("PVCNN_TPU_CONV_BN_FUSED") == "0":
            grid = self._rows_unfused(grid)
        elif self.training:
            count = grid.shape[0] * r ** 3
            grid, s1, s2 = conv0(grid, r, want_stats=True)
            pro = bn0.fold_from_sums(s1, s2, count)
            grid, s1, s2 = conv1(grid, r, prologue=pro, want_stats=True)
            grid = ops.leaky_affine(grid, *bn1.fold_from_sums(s1, s2, count))
        else:
            grid, _, _ = conv0(grid, r)
            grid, _, _ = conv1(grid, r, prologue=bn0.fold())
            grid = ops.leaky_affine(grid, *bn1.fold())
        for se in self.voxel_layers[6:]:
            grid = se(grid)
        voxel_features = ops.devoxelize_rows(grid, norm_coords, r,
                                             channels_first=True)
        return voxel_features + self.point_features(features), coords

    def _rows_unfused(self, grid):
        """The unfused rows branch (pvcnn_tpu/nn/pvconv.py with
        PVCNN_TPU_CONV_BN_FUSED=0) on [B, C, R^3] rows: each conv without
        prologue or statistics, then its BatchNorm over the channel axis (batch
        statistics in train mode, running ones in eval mode) and LeakyReLU,
        each a pass of its own."""
        r = self.resolution
        for conv, bn, act in (self.voxel_layers[0:3], self.voxel_layers[3:6]):
            grid, _, _ = conv(grid, r)
            grid = act(bn.channels_first(grid))
        return grid

    def _voxel_ndhwc(self, features, coords):
        """The unfused NDHWC voxel branch (pvcnn_tpu/nn/pvconv.py with
        PVCNN_TPU_CONV_ROWS=0): [B, N, C] features -> [B, N, C'] voxel
        features. Each BatchNorm normalizes over the grid's last axis, with
        batch statistics in train mode and running ones in eval mode."""
        r = self.resolution
        grid, norm_coords = self.voxelization(features, coords,
                                              channels_first=False)
        grid = grid.reshape(grid.shape[0], r, r, r, grid.shape[2])
        conv0, bn0, act0, conv1, bn1, act1 = self.voxel_layers[:6]
        grid = act0(_batch_norm_ndhwc(bn0, conv0.ndhwc(grid)))
        grid = act1(_batch_norm_ndhwc(bn1, conv1.ndhwc(grid)))
        for se in self.voxel_layers[6:]:
            grid = se(grid)
        return ops.devoxelize_rows(grid.reshape(grid.shape[0], r ** 3, -1),
                                   norm_coords, r, channels_first=False)


def _batch_norm_ndhwc(bn: BatchNorm, grid):
    """BatchNorm over the last axis of a [B, R, R, R, C] grid. In train
    mode the batch statistics come from per-channel sums over the grid
    (mean = sum(x) / n, var = sum(x^2) / n - mean^2, as the JAX package's
    BatchNorm computes them) through BatchNorm.apply_from_sums: on the CPU,
    F.batch_norm over the [B * R^3, C] rows accumulates them about 50 times
    less accurately (4e-5 against 8e-7 at 524,288 rows)."""
    if not bn.training:
        return bn(grid)
    rows = grid.reshape(-1, grid.shape[-1])
    return bn.apply_from_sums(grid, rows.sum(0), (rows * rows).sum(0),
                              rows.shape[0])
