"""SharedMLP: per-point 1x1 conv -> BatchNorm -> ReLU stacks on channel-last
[B, N, C] features (counterpart of pvcnn_tpu/nn/shared_mlp.py).

Parameters keep the reference's torch names and shapes (Conv1d weight
[out, in, 1], or Conv2d [out, in, 1, 1] for the `dim=2` stacks of the
PointNet++ set abstraction; BatchNorm weight/bias/running stats), so the
port's `state_dict()` matches released checkpoints key for key.

Activation dtype (`dtype=`, the JAX modules' `dtype`): None or float32
runs as before, with no cast anywhere; bfloat16 runs the activations in
bf16 while the parameters, BatchNorm's running statistics and every
gradient of a parameter stay float32. Where the JAX package rounds
(pvcnn_tpu/nn/shared_mlp.py): a Dense casts its input, kernel and bias to
bf16 at use (flax nn.Dense(dtype)); SplitDense casts its parts and its
kernel, accumulates the parts' products in f32, adds the f32 bias and
rounds once (:42-62); BatchNorm takes its statistics and normalizes in f32
and rounds its output to its dtype (:127-152). The f32 accumulation of a
bf16 product is the card's when cuBLAS's reduced-precision reduction is
off (train/predict.py:fp32_precision turns it off).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from pvcnn_tpu_torch.ops.dense_rows import dense_rows_act, dense_rows_plan
from pvcnn_tpu_torch.utils import knobs
from pvcnn_tpu_torch.utils.dtype import resolve_dtype, wide

__all__ = ["BatchNorm", "Dense2d", "DenseBNReLU", "Linear", "SharedMLP",
           "SplitDense"]


def _cast(t, dtype):
    return t if dtype is None or t is None else t.to(dtype)


class SplitDense(nn.Conv1d):
    """The reference's 1x1 Conv1d, applied over the last axis of channel-last
    features.

    Given a LIST of arrays it computes Dense(concat(xs)) as the sum of
    per-segment products, never building the concat; a segment with a
    singleton points axis ([B, 1, C], the global feature) broadcasts instead
    of being tiled. That is how PVCNN's classifier reads its 4944 input
    channels at width 1. With dtype bfloat16 the parts are cast to bf16 and
    their products summed in f32 with the f32 bias, rounded once (the
    products of the widened bf16 operands are exact in f32); one array
    runs as nn.Dense(dtype) does, in bf16 with a bf16 bias."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__(in_channels, out_channels, 1)
        self.act_dtype = resolve_dtype(dtype)

    def forward(self, x):
        dt = self.act_dtype
        w = _cast(self.weight[..., 0], dt)                    # [out, in]
        if not isinstance(x, (list, tuple)):
            return F.linear(_cast(x, dt), w, _cast(self.bias, dt))
        if sum(seg.shape[-1] for seg in x) != w.shape[1]:
            raise ValueError(f"segments hold {sum(s.shape[-1] for s in x)} "
                             f"channels, the layer takes {w.shape[1]}")
        if dt is not None:
            return _SplitDenseBF16.apply(w, self.bias,
                                         *(seg.to(dt) for seg in x))
        y, off = None, 0
        for seg in x:
            c = seg.shape[-1]
            t = torch.matmul(seg, w[:, off:off + c].t())
            y = t if y is None else y + t
            off += c
        return y + self.bias


def _mm_f32(a, b):
    """a [M, K] @ b [K, N] of bf16 operands -> float32, the products
    summed in f32 and not rounded (cuBLAS's out_dtype on the card; the
    exact products of the widened operands on the CPU)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _SplitDenseBF16(torch.autograd.Function):
    """SplitDense on bf16 parts [..., N or 1, C_i] with a bf16 weight [out,
    in] and a float32 bias, as the JAX package's SplitDense(dtype) and its
    transposes (pvcnn_tpu/nn/shared_mlp.py:42-62): forward, the parts'
    products summed in f32 with the bias, rounded once to bf16; backward,
    a full part's input and weight gradients as bf16 products with f32
    sums (dot_general's transposes into the bf16 operands' dtype), a
    broadcast part's from the cotangent summed over the points in f32,
    and the bias gradient the f32 sum of the cotangent."""

    @staticmethod
    def forward(ctx, weight, bias, *segs):
        co = weight.shape[0]
        y, off = None, 0
        for seg in segs:
            c = seg.shape[-1]
            t = _mm_f32(seg.reshape(-1, c), weight[:, off:off + c].t())
            t = t.reshape(*seg.shape[:-1], co)
            y = t if y is None else y + t
            off += c
        ctx.save_for_backward(weight, *segs)
        return (y + bias).to(weight.dtype)

    @staticmethod
    def backward(ctx, g):
        weight, *segs = ctx.saved_tensors
        co = weight.shape[0]
        rows = g.reshape(-1, co)
        dbias = g.float().reshape(-1, co).sum(0)
        dw = torch.empty_like(weight)
        dsegs, off = [], 0
        for seg in segs:
            c = seg.shape[-1]
            w = weight[:, off:off + c]
            x = seg.reshape(-1, c)
            if seg.shape[-2] == g.shape[-2]:       # a part of every point
                dsegs.append((rows @ w).reshape(seg.shape))
                dw[:, off:off + c] = rows.t() @ x
            else:                                  # broadcast over points
                gs = g.float().sum(dim=-2).reshape(-1, co)
                dsegs.append((gs @ w.float()).to(seg.dtype).reshape(
                    seg.shape))
                dw[:, off:off + c] = (gs.t() @ x.float()).to(weight.dtype)
            off += c
        return (dw, dbias, *dsegs)


class Linear(nn.Linear):
    """nn.Linear with an activation dtype: with bfloat16 its input, weight
    and bias are cast to bf16 at use (flax nn.Dense(dtype)); the parameters
    stay float32."""

    def __init__(self, in_features: int, out_features: int, bias=True,
                 dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.act_dtype = resolve_dtype(dtype)

    def forward(self, x):
        dt = self.act_dtype
        return F.linear(_cast(x, dt), _cast(self.weight, dt),
                        _cast(self.bias, dt))


class Dense2d(nn.Conv2d):
    """The reference's 1x1 Conv2d, applied over the last axis of
    channel-last features such as grouped neighborhoods [B, M, U, C].
    With dtype bfloat16 its input, weight and bias are cast to bf16 at use,
    as Linear's (flax nn.Dense(dtype)); the parameters stay float32."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__(in_channels, out_channels, 1)
        self.act_dtype = resolve_dtype(dtype)

    def forward(self, x):
        dt = self.act_dtype
        return F.linear(_cast(x, dt), _cast(self.weight[..., 0, 0], dt),
                        _cast(self.bias, dt))


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of channel-last features, with torch's
    semantics and state (running_var tracks the unbiased variance).

    `fold()` gives the eval-mode affine (scale_eff, shift_eff) with
    bn(y) == y * scale_eff + shift_eff, the prologue the fused conv
    (ops/conv3d.py) applies in place of a normalize pass over the grid.
    `fold_from_sums()` is its training-mode twin, from the batch sums the
    conv's statistics epilogue returns; `apply_from_sums()` applies it.
    `channels_first()` normalizes channel-major features instead (the
    unfused rows branch's grids). With dtype bfloat16 (or a bf16 input)
    the statistics and the normalization run in f32 and the output is
    rounded to bf16."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, dtype=None):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.act_dtype = resolve_dtype(dtype)

    def forward(self, x):
        c = x.shape[-1]
        # a bf16 x with the float32 parameters: torch's batch norm takes
        # its statistics and normalizes in f32 and rounds once to bf16
        y = F.batch_norm(x.reshape(-1, c), self.running_mean,
                         self.running_var, self.weight, self.bias,
                         self.training, self.momentum, self.eps)
        return y.reshape(x.shape).to(self.act_dtype or x.dtype)

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
    one array that the JAX package's plan takes
    (ops.dense_rows.dense_rows_plan, in the layer's activation dtype) runs
    as in the JAX package's fused path: ops.dense_rows_act with its
    statistics epilogue (kernel K9 on the card), BatchNorm.apply_from_sums,
    then relu. Eval mode never takes this path.

    dtype bfloat16 runs the layers' activations in bf16 (dim=2: on the
    grouped neighborhoods [B, M, U, C]); on the fused path as the JAX
    package's DenseStats(dtype) and its affine (pvcnn_tpu/nn/shared_mlp.py:
    228-260): the input cast to bf16, K9's bf16 mode (y bf16, its
    statistics from the f32 sums), the BatchNorm affine in f32 rounded
    once to bf16, then relu."""

    def __init__(self, in_channels: int, out_channels: int | Sequence[int],
                 dim: int = 1, dtype=None):
        super().__init__()
        if dim not in (1, 2):
            raise ValueError(f"SharedMLP dim must be 1 or 2, got {dim}")
        self.act_dtype = resolve_dtype(dtype)
        if not isinstance(out_channels, (list, tuple)):
            out_channels = [out_channels]
        layers = []
        for oc in out_channels:
            dense = (SplitDense if dim == 1 else Dense2d)(
                in_channels, int(oc), dtype=dtype)
            layers += [dense, BatchNorm(int(oc), dtype=dtype), nn.ReLU()]
            in_channels = int(oc)
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        if not self.training:
            return self.layers(x)
        dt = self.act_dtype
        for i in range(0, len(self.layers), 3):
            dense, bn, relu = self.layers[i:i + 3]
            co, ci = dense.weight.shape[:2]
            if _fused_rows(x, co, dt):
                y, s1, s2 = dense_rows_act(
                    _cast(x, dt), dense.weight.reshape(co, ci).t(),
                    dense.bias, None, None, 0.0, False, True)
                # a bf16 y's affine in f32, rounded once (relu commutes
                # with the rounding: JAX's maximum(t, 0).astype(dt))
                x = relu(bn.apply_from_sums(wide(y), s1, s2,
                                            x.numel() // ci).to(y.dtype))
            else:
                x = relu(bn(dense(x)))
        return x


def _fused_rows(x, co: int, dtype) -> bool:
    """Does a train-mode layer of `co` outputs on x take the fused Dense +
    statistics path? The JAX package's gate: the knob, read only for an
    array input, and its plan at the layer's shape in its activation dtype
    (dtype, or x's where the layer has none)."""
    if isinstance(x, (list, tuple)):
        return False
    rows = x.numel() // x.shape[-1]
    return (knobs.get("PVCNN_TPU_DENSE_BN_FUSED") == "auto"
            and dense_rows_plan(rows, x.shape[-1], co,
                                dtype or x.dtype) is not None)


class DenseBNReLU(nn.Sequential):
    """Linear -> BatchNorm -> ReLU on per-cloud features [B, C] (reference
    models/utils.py:_linear_bn_relu; its children 0 and 1 give the
    reference's state_dict keys), with an activation dtype."""

    def __init__(self, in_channels: int, out_channels: int, dtype=None):
        super().__init__(Linear(in_channels, out_channels, dtype=dtype),
                         BatchNorm(out_channels, dtype=dtype), nn.ReLU())
