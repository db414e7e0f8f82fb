"""Loss primitives (counterpart of pvcnn_tpu/ops/losses.py). The class axis
is the LAST axis, as in the JAX package's channel-last layout."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy", "huber_loss", "kl_loss"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean softmax cross entropy with integer labels: logits [..., K],
    labels [...] -> scalar (torch F.cross_entropy over every position)."""
    k = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, k), labels.reshape(-1).long())


def kl_loss(x: torch.Tensor, y: torch.Tensor):
    """KL(softmax(x) || softmax(y)) over the last axis, the mean over the
    others, with x detached (deep mutual learning: x is the peer's logits).
    Computed as the JAX package does, softmax then log for x and log_softmax
    for y, so both give the same value where a probability underflows."""
    p = torch.softmax(x.detach(), dim=-1)
    return (p * (torch.log(p) - torch.log_softmax(y, dim=-1))).sum(-1).mean()


def huber_loss(error: torch.Tensor, delta: float):
    """Mean Huber loss (smooth L1 with knee `delta`) over all elements:
    0.5 * min(|e|, delta)^2 + delta * (|e| - min(|e|, delta))."""
    abs_error = error.abs()
    quadratic = abs_error.clamp(max=delta)
    return (0.5 * quadratic ** 2 + delta * (abs_error - quadratic)).mean()
