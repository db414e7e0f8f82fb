"""Conv3d (stride 1, SAME) for the PVConv voxel branch (counterpart of
pvcnn_tpu/nn/conv3d.py:Conv3dSame), on flat rows or on NDHWC grids.

The parameters are torch Conv3d's (weight [Co, Ci, k, k, k], bias [Co]),
so checkpoints of the reference load unchanged in either layout. `forward`
runs ops.conv3d_rows_act on [B, Ci, R^3] rows (the fused rows mode);
`ndhwc` runs on [B, R, R, R, Ci] grids (the JAX package's NDHWC mode, taken
with PVCNN_TPU_CONV_ROWS=0)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from pvcnn_tpu_torch.ops.conv3d import conv3d_rows_act, conv3d_same
from pvcnn_tpu_torch.utils import knobs

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

    def ndhwc(self, x: torch.Tensor):
        """x [B, R, R, R, Ci] grid -> y [B, R, R, R, Co] (bias added).
        With PVCNN_TPU_CUSTOM_CONV_WGRAD=1 the conv is ops.conv3d_same,
        whose weight gradient is kernel K11; otherwise F.conv3d with torch's
        own autograd (XLA autodiff in the JAX package)."""
        if knobs.get("PVCNN_TPU_CUSTOM_CONV_WGRAD"):
            y = conv3d_same(x, self.weight)
        else:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight,
                         padding=self.padding).permute(0, 2, 3, 4, 1)
        return y + self.bias
