"""Loss primitives (counterpart of pvcnn_tpu/ops/losses.py). The class axis
is the LAST axis, as in the JAX package's channel-last layout.

bf16 logits (a model with bf16 activations) are widened to f32 first, so
the log-softmax, its sum and the mean run in f32 and the loss is float32;
the gradient reaches the logits as f32 and is rounded to bf16 there. The
JAX package runs jax.nn.log_softmax in the logits' dtype: its max-shift,
exp, log and the one-hot product round to bf16 (the sums accumulate in
f32 and round), and its loss is a bf16 scalar. The port's loss is the
exact one of the same bf16 logits, within about one bf16 rounding (2^-9
relative) of the JAX value."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pvcnn_tpu_torch.utils.dtype import wide

__all__ = ["cross_entropy", "huber_loss", "kl_loss"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean softmax cross entropy with integer labels: logits [..., K],
    labels [...] -> scalar (torch F.cross_entropy over every position)."""
    k = logits.shape[-1]
    return F.cross_entropy(wide(logits).reshape(-1, k),
                           labels.reshape(-1).long())


def kl_loss(x: torch.Tensor, y: torch.Tensor):
    """KL(softmax(x) || softmax(y)) over the last axis, the mean over the
    others, with x detached (deep mutual learning: x is the peer's logits).
    Computed as the JAX package does, softmax then log for x and log_softmax
    for y, so both give the same value where a probability underflows."""
    p = torch.softmax(wide(x.detach()), dim=-1)
    return (p * (torch.log(p) - torch.log_softmax(wide(y), dim=-1))).sum(
        -1).mean()


def huber_loss(error: torch.Tensor, delta: float):
    """Mean Huber loss (smooth L1 with knee `delta`) over all elements:
    0.5 * min(|e|, delta)^2 + delta * (|e| - min(|e|, delta))."""
    abs_error = error.abs()
    quadratic = abs_error.clamp(max=delta)
    return (0.5 * quadratic ** 2 + delta * (abs_error - quadratic)).mean()
