"""SharedMLP: per-point 1x1 conv -> BatchNorm -> ReLU stacks on channel-last
[B, N, C] features (counterpart of pvcnn_tpu/nn/shared_mlp.py).

Parameters keep the reference's torch names and shapes (Conv1d weight
[out, in, 1], or Conv2d [out, in, 1, 1] for the `dim=2` stacks of the
PointNet++ set abstraction; BatchNorm weight/bias/running stats), so the
port's `state_dict()` matches released checkpoints key for key.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["BatchNorm", "Dense2d", "SharedMLP", "SplitDense"]


class SplitDense(nn.Conv1d):
    """The reference's 1x1 Conv1d, applied over the last axis of channel-last
    features.

    Given a LIST of arrays it computes Dense(concat(xs)) as the sum of
    per-segment products, never building the concat; a segment with a
    singleton points axis ([B, 1, C], the global feature) broadcasts instead
    of being tiled. That is how PVCNN's classifier reads its 4944 input
    channels at width 1."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x):
        w = self.weight[..., 0]                               # [out, in]
        if not isinstance(x, (list, tuple)):
            return F.linear(x, w, self.bias)
        y, off = None, 0
        for seg in x:
            c = seg.shape[-1]
            t = torch.matmul(seg, w[:, off:off + c].t())
            y = t if y is None else y + t
            off += c
        if off != w.shape[1]:
            raise ValueError(f"segments hold {off} channels, the layer "
                             f"takes {w.shape[1]}")
        return y + self.bias


class Dense2d(nn.Conv2d):
    """The reference's 1x1 Conv2d, applied over the last axis of
    channel-last features such as grouped neighborhoods [B, M, U, C]."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 1)

    def forward(self, x):
        return F.linear(x, self.weight[..., 0, 0], self.bias)


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of channel-last features, with torch's
    semantics and state (running_var tracks the unbiased variance).

    `fold()` gives the eval-mode affine (scale_eff, shift_eff) with
    bn(y) == y * scale_eff + shift_eff, the prologue the fused conv
    (ops/conv3d.py) applies in place of a normalize pass over the grid.
    `fold_from_sums()` is its training-mode twin, from the batch sums the
    conv's statistics epilogue returns."""

    def forward(self, x):
        c = x.shape[-1]
        y = F.batch_norm(x.reshape(-1, c), self.running_mean,
                         self.running_var, self.weight, self.bias,
                         self.training, self.momentum, self.eps)
        return y.reshape(x.shape)

    def fold(self):
        if self.training:
            raise RuntimeError("BatchNorm.fold() folds the running "
                               "statistics; call it in eval mode")
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def fold_from_sums(self, s1, s2, count: int):
        """Training mode: per-channel sums s1 = sum(y), s2 = sum(y^2) over
        `count` elements -> the folded (scale_eff, shift_eff) of the batch
        statistics (mean = s1 / n, biased var = s2 / n - mean^2), updating the
        running mean and the unbiased running variance (x n / (n - 1)) with
        the module's momentum, as pvcnn_tpu/nn/shared_mlp.py:
        BatchNorm._affine does. Differentiable in s1, s2, weight and bias."""
        if not self.training:
            raise RuntimeError("BatchNorm.fold_from_sums() folds batch "
                               "statistics; call it in train mode")
        n = int(count)
        mean = s1 / n
        var = s2 / n - mean * mean
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        scale = self.weight * torch.rsqrt(var + self.eps)
        return scale, self.bias - mean * scale


class SharedMLP(nn.Module):
    """Stack of 1x1 conv -> BatchNorm -> ReLU named `layers`
    (reference modules/shared_mlp.py), over the last axis of channel-last
    features. dim=1 holds Conv1d weights (SplitDense: the input may be a
    list of arrays, meaning their channel concat); dim=2 holds Conv2d
    weights (Dense2d), as the reference's set-abstraction MLPs do."""

    def __init__(self, in_channels: int, out_channels: int | Sequence[int],
                 dim: int = 1):
        super().__init__()
        if dim not in (1, 2):
            raise ValueError(f"SharedMLP dim must be 1 or 2, got {dim}")
        dense = SplitDense if dim == 1 else Dense2d
        if not isinstance(out_channels, (list, tuple)):
            out_channels = [out_channels]
        layers = []
        for oc in out_channels:
            layers += [dense(in_channels, int(oc)), BatchNorm(int(oc)),
                       nn.ReLU()]
            in_channels = int(oc)
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x)
