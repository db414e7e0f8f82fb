"""Conv3d (stride 1, SAME) for the PVConv voxel branch on flat rows
(counterpart of pvcnn_tpu/nn/conv3d.py:Conv3dSame in its fused rows mode).

The parameters are torch Conv3d's (weight [Co, Ci, k, k, k], bias [Co]),
so checkpoints of the reference load unchanged; the forward runs
ops.conv3d_rows_act on [B, Ci, R^3] rows."""

from __future__ import annotations

import torch
import torch.nn as nn

from pvcnn_tpu_torch.ops.conv3d import conv3d_rows_act

__all__ = ["Conv3dSame"]


class Conv3dSame(nn.Conv3d):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3):
        k = int(kernel_size)
        # an even k pads asymmetrically in SAME convs and differs from the
        # reference's Conv3d(padding=k // 2): only odd k is defined
        if k % 2 != 1:
            raise ValueError(f"Conv3dSame requires an odd kernel_size, got {k}")
        super().__init__(in_channels, out_channels, k, padding=k // 2)

    def forward(self, x: torch.Tensor, resolution: int, prologue=None,
                want_stats: bool = False):
        """x [B, Ci, R^3] rows -> (y [B, Co, R^3], s1 [Co], s2 [Co]).
        prologue: optional (scale, shift) [Ci] pair applied as
        leaky(x * scale + shift, 0.1) to the input inside the conv (the
        previous BatchNorm, folded). want_stats: s1, s2 are the per-channel
        sum and sum of squares of y (zeros otherwise)."""
        pscale, pshift = prologue if prologue is not None else (None, None)
        return conv3d_rows_act(x, self.weight, self.bias, pscale, pshift,
                               resolution, prologue is not None, want_stats)
