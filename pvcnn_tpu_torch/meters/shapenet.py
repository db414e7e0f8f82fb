"""ShapeNet part-IoU meter (counterpart of pvcnn_tpu/meters/shapenet.py),
numpy over channel-last outputs [B, N, num_classes]. The argmax is
restricted to the target shape's part-class range; a part with an empty
union counts as IoU 1. Restated here so that the port imports nothing of the
JAX package (tests/test_torch_train.py holds the two equal)."""

from __future__ import annotations

import numpy as np

from pvcnn_tpu_torch.data.shapenet import SHAPE_PART_CLASSES

__all__ = ["MeterShapeNet"]


class MeterShapeNet:
    def __init__(self, num_classes: int = 50, num_shapes: int = 16):
        self.num_classes = num_classes
        self.num_shapes = num_shapes
        self.part_class_to_shape_part_classes = []
        for _, parts in SHAPE_PART_CLASSES:
            self.part_class_to_shape_part_classes += \
                [(parts[0], parts[-1] + 1)] * len(parts)
        self.reset()

    def reset(self):
        self.iou_sum = 0.0
        self.shape_count = 0

    def update(self, outputs, targets):
        """outputs [B, N, num_classes] logits, targets [B, N] int labels."""
        outputs = np.asarray(outputs)
        targets = np.asarray(targets)
        for b in range(outputs.shape[0]):
            start, end = self.part_class_to_shape_part_classes[
                int(targets[b, 0])]
            prediction = np.argmax(outputs[b, :, start:end], axis=-1) + start
            target = targets[b]
            iou = 0.0
            for i in range(start, end):
                itarget = target == i
                ipred = prediction == i
                union = np.sum(itarget | ipred)
                iou += 1.0 if union == 0 else np.sum(itarget & ipred) / union
            self.iou_sum += iou / (end - start)
            self.shape_count += 1

    def compute(self):
        return self.iou_sum / self.shape_count
