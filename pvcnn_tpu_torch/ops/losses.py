"""Loss primitives (counterpart of pvcnn_tpu/ops/losses.py, the part the
segmentation configs use). The class axis is the LAST axis, as in the JAX
package's channel-last layout."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cross_entropy"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Mean softmax cross entropy with integer labels: logits [..., K],
    labels [...] -> scalar (torch F.cross_entropy over every position)."""
    k = logits.shape[-1]
    return F.cross_entropy(logits.reshape(-1, k), labels.reshape(-1).long())
