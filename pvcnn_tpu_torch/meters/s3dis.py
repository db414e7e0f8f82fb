"""S3DIS overall-accuracy / class-accuracy / mIoU meter (counterpart of
pvcnn_tpu/meters/s3dis.py), numpy over channel-last outputs
[B, N, num_classes]. Restated here so that the port imports nothing of the
JAX package (tests/test_torch_pvcnn2.py holds the two equal)."""

from __future__ import annotations

import numpy as np

__all__ = ["MeterS3DIS"]


class MeterS3DIS:
    def __init__(self, metric: str = "iou", num_classes: int = 13):
        if metric not in ("overall", "class", "iou"):
            raise ValueError(f"unknown metric {metric!r}")
        self.metric = metric
        self.num_classes = num_classes
        self.reset()

    def reset(self):
        self.total_seen = np.zeros(self.num_classes, dtype=np.int64)
        self.total_correct = np.zeros(self.num_classes, dtype=np.int64)
        self.total_positive = np.zeros(self.num_classes, dtype=np.int64)
        self.total_seen_num = 0
        self.total_correct_num = 0

    def update(self, outputs, targets):
        """outputs [B, N, num_classes] logits, targets [B, N] int labels."""
        targets = np.asarray(targets).reshape(-1)
        predictions = np.asarray(outputs).argmax(-1).reshape(-1)
        if self.metric == "overall":
            self.total_seen_num += targets.size
            self.total_correct_num += int(np.sum(targets == predictions))
            return
        nc = self.num_classes
        self.total_seen += np.bincount(targets, minlength=nc)[:nc]
        self.total_positive += np.bincount(predictions, minlength=nc)[:nc]
        correct = targets[targets == predictions]
        self.total_correct += np.bincount(correct, minlength=nc)[:nc]

    def compute(self):
        if self.metric == "class":
            acc = np.where(self.total_seen == 0, 1.0,
                           self.total_correct / np.maximum(self.total_seen, 1))
            return float(acc.mean())
        if self.metric == "iou":
            union = self.total_seen + self.total_positive - self.total_correct
            iou = np.where(self.total_seen == 0, 1.0,
                           self.total_correct / np.maximum(union, 1))
            return float(iou.mean())
        return self.total_correct_num / self.total_seen_num
