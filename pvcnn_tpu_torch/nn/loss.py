"""Training criteria (counterpart of pvcnn_tpu/nn/loss.py)."""

from __future__ import annotations

from pvcnn_tpu_torch.ops.losses import cross_entropy, kl_loss

__all__ = ["CrossEntropyLoss", "KLLoss"]


class CrossEntropyLoss:
    """Per-point or per-example softmax cross entropy, mean over positions;
    logits [..., num_classes], integer labels [...]. bf16 logits are
    widened to f32 (ops/losses.py says where that differs from the JAX
    package's bf16 log_softmax)."""

    def __call__(self, logits, labels):
        return cross_entropy(logits, labels)


class KLLoss:
    """The deep-mutual-learning criterion: KL(softmax(peer) || softmax(own))
    over the last (class) axis, the peer's logits detached."""

    def __call__(self, x, y):
        return kl_loss(x, y)
