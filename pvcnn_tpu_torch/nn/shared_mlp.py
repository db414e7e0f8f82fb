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

from pvcnn_tpu_torch.ops.dense_rows import dense_rows_act
from pvcnn_tpu_torch.utils import knobs

__all__ = ["BatchNorm", "Dense2d", "DenseBNReLU", "SharedMLP", "SplitDense"]


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
    conv's statistics epilogue returns; `apply_from_sums()` applies it.
    `channels_first()` normalizes channel-major features instead (the
    unfused rows branch's grids)."""

    def forward(self, x):
        c = x.shape[-1]
        y = F.batch_norm(x.reshape(-1, c), self.running_mean,
                         self.running_var, self.weight, self.bias,
                         self.training, self.momentum, self.eps)
        return y.reshape(x.shape)

    def channels_first(self, x):
        """BatchNorm over axis 1 of channel-major features [B, C, ...] (the
        rows branch's grids [B, C, R^3])."""
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, self.training,
                            self.momentum, self.eps)

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

    def apply_from_sums(self, y, s1, s2, count: int):
        """Training mode: y [..., C] normalized by the batch statistics of
        its per-channel sums s1, s2 over `count` rows (fold_from_sums),
        i.e. y * scale_eff + shift_eff."""
        scale, shift = self.fold_from_sums(s1, s2, count)
        return y * scale + shift


class SharedMLP(nn.Module):
    """Stack of 1x1 conv -> BatchNorm -> ReLU named `layers`
    (reference modules/shared_mlp.py), over the last axis of channel-last
    features. dim=1 holds Conv1d weights (SplitDense: the input may be a
    list of arrays, meaning their channel concat); dim=2 holds Conv2d
    weights (Dense2d), as the reference's set-abstraction MLPs do.

    With PVCNN_TPU_DENSE_BN_FUSED=auto, a train-mode layer whose input is
    one array of rows >= 1024 with rows % 256 == 0 (the JAX plan's shape
    conditions, pvcnn_tpu/ops/pallas/dense_rows.py:dense_rows_plan) runs
    as in the JAX package's fused path: ops.dense_rows_act with its
    statistics epilogue (kernel K9 on the card), BatchNorm.apply_from_sums,
    then relu. The TPU plan's VMEM budget is not carried
    over: at S3DIS PVCNN 1x's shapes (32 x 4096 rows, 9 to 512 input and
    64 to 1024 output channels) it accepts all six layers, as the shape
    conditions do, so both packages route the same layers. Eval mode never
    takes this path."""

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
        if not self.training:
            return self.layers(x)
        for i in range(0, len(self.layers), 3):
            dense, bn, relu = self.layers[i:i + 3]
            if _fused_rows(x):
                co, ci = dense.weight.shape[:2]
                y, s1, s2 = dense_rows_act(
                    x, dense.weight.reshape(co, ci).t(), dense.bias, None,
                    None, 0.0, False, True)
                x = relu(bn.apply_from_sums(y, s1, s2, x.numel() // ci))
            else:
                x = relu(bn(dense(x)))
        return x


def _fused_rows(x) -> bool:
    """Does a train-mode layer on x take the fused Dense + statistics
    path? (The knob is read only for an array input, as in JAX.)"""
    if isinstance(x, (list, tuple)):
        return False
    rows = x.numel() // x.shape[-1]
    return (knobs.get("PVCNN_TPU_DENSE_BN_FUSED") == "auto"
            and rows >= 1024 and rows % 256 == 0)


class DenseBNReLU(nn.Sequential):
    """Linear -> BatchNorm -> ReLU on per-cloud features [B, C] (reference
    models/utils.py:_linear_bn_relu; its children 0 and 1 give the
    reference's state_dict keys)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(nn.Linear(in_channels, out_channels),
                         BatchNorm(out_channels), nn.ReLU())
