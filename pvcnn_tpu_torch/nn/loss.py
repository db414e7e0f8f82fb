"""Training criteria (counterpart of pvcnn_tpu/nn/loss.py)."""

from __future__ import annotations

from pvcnn_tpu_torch.ops.losses import cross_entropy

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss:
    """Per-point or per-example softmax cross entropy, mean over positions;
    logits [..., num_classes], integer labels [...]."""

    def __call__(self, logits, labels):
        return cross_entropy(logits, labels)
