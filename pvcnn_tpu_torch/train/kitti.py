"""python -m pvcnn_tpu_torch.train.kitti --root <frustum data> ...

Train a KITTI Frustum model with the port, as train.py does for the JAX
package's configs/kitti/frustum/{pvcnne,pointnet2,pointnet}.py (--model;
pvcnne by default): the train split of the frustum pickles at --root
(FrustumKitti, 1,024 points a frustum) with the frustum rotation, random
flip and depth shift, FrustumPointNetLoss, Adam at lr 1e-3 for 209 epochs
with the model's batch size and schedule (models/kitti/frustum MODELS),
fp32 with TF32 off. After each epoch the val split is scored with the
configs' four MeterFrustumKitti meters (acc/iou_3d_val, acc/acc_val,
acc/iou_3d_acc_val, acc/iou_3d_class_acc_val), and the checkpoints
<save-path>/latest.pth.tar and latest/e{N}.pth.tar are written, with, on a
new best, best/best.acc.iou_3d_class_acc_val.pth.tar and
best/best.acc.iou_3d_acc_val.pth.tar, and best.pth.tar for the first (the
evaluator's checkpoint; train/trainer.py:fit). A run whose save path holds latest.pth.tar
resumes from it. Weights are drawn from a torch.Generator seeded with
--seed unless --checkpoint names a reference .pth.tar; the reader draws
from np.random.RandomState(--seed), the sampler from the Trainer's
generator. --max-steps cuts every epoch short (smoke runs).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pvcnn_tpu_torch.data.kitti import attributes
from pvcnn_tpu_torch.data.kitti.frustum import FrustumKitti
from pvcnn_tpu_torch.data.loader import DataLoader
from pvcnn_tpu_torch.meters.kitti.frustum import MeterFrustumKitti
from pvcnn_tpu_torch.models.kitti import frustum as kitti
from pvcnn_tpu_torch.train.optim import Adam
from pvcnn_tpu_torch.train.trainer import Trainer, check_device, fit
from pvcnn_tpu_torch.utils.weights import (init_random_,
                                           load_reference_checkpoint)

__all__ = ["METRICS", "main", "meters", "train"]

# the configs' metrics for the best checkpoints, the first for best.pth.tar
METRICS = ("acc/iou_3d_class_acc_val", "acc/iou_3d_acc_val")


def meters(split: str) -> dict:
    """The configs' four Frustum meters of `split`, by name."""
    templates = attributes.size_templates()
    classes = {c: i for i, c in enumerate(kitti.CLASSES)}
    return {name.format(split): MeterFrustumKitti(
        kitti.NUM_HEADING_ANGLE_BINS, len(templates), templates, classes,
        metric=metric)
        for name, metric in (("acc/iou_3d_{}", "iou_3d"),
                             ("acc/acc_{}", "accuracy"),
                             ("acc/iou_3d_acc_{}", "iou_3d_accuracy"),
                             ("acc/iou_3d_class_acc_{}",
                              "iou_3d_class_accuracy"))}


def train(root: str, *, model: str = "pvcnne", width_multiplier: float = 1.0,
          batch_size: int | None = None, epochs: int = kitti.EPOCHS,
          max_steps: int | None = None, save_path: str | None = None,
          device: str = "cuda", seed: int = 0,
          checkpoint: str | None = None,
          num_points: int = kitti.NUM_POINTS) -> dict:
    """Train (or resume) the Frustum model named `model`
    (models.kitti.frustum.MODELS) and return the last evaluation's meters.
    `batch_size` defaults to the model's, `save_path` to
    runs/kitti.frustum.<model>."""
    spec = kitti.MODELS[model]
    batch_size = spec.batch_size if batch_size is None else batch_size
    save_path = (os.path.join("runs", f"kitti.frustum.{model}")
                 if save_path is None else save_path)
    device = check_device(device)
    dataset = FrustumKitti(root, num_points, classes=kitti.CLASSES,
                           num_heading_angle_bins=kitti.NUM_HEADING_ANGLE_BINS,
                           random_flip=True, random_shift=True,
                           frustum_rotate=True,
                           rng=np.random.RandomState(seed))
    loaders = {"train": DataLoader(dataset["train"], batch_size,
                                   shuffle=True, seed=seed),
               "val": DataLoader(dataset["val"], batch_size)}
    net = spec.build(width_multiplier)
    if checkpoint is not None:
        load_reference_checkpoint(net, checkpoint)
    else:
        init_random_(net, seed)
    net = net.to(device)
    optimizer = Adam(net.parameters(), lr=kitti.LR, weight_decay=0.0)
    trainer = Trainer(net, kitti.criterion(), optimizer, device, seed)
    return fit(trainer, loaders["train"], loaders["val"],
               lambda: meters("val"), METRICS, epochs=epochs,
               save_path=save_path,
               scheduler=spec.scheduler(epochs).bind(kitti.LR),
               max_steps=max_steps)[""]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.train.kitti",
        description="Train a KITTI Frustum 3-D detection model")
    p.add_argument("--root", required=True,
                   help="folder of frustum_carpedcyc_{train,val}.pickle")
    p.add_argument("--model", choices=sorted(kitti.MODELS), default="pvcnne",
                   help="the model, trained with its config's recipe")
    p.add_argument("--width", type=float, default=1.0,
                   help="width multiplier of the model")
    p.add_argument("--batch-size", type=int, default=None,
                   help="32 (24 for pointnet2)")
    p.add_argument("--epochs", type=int, default=kitti.EPOCHS)
    p.add_argument("--max-steps", type=int, default=None,
                   help="train at most this many steps per epoch")
    p.add_argument("--num-points", type=int, default=kitti.NUM_POINTS)
    p.add_argument("--save-path", default=None,
                   help="default runs/kitti.frustum.<model>")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth.tar to start from; seeded random "
                        "weights if absent")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    return train(args.root, model=args.model, width_multiplier=args.width,
                 batch_size=args.batch_size, epochs=args.epochs,
                 max_steps=args.max_steps, save_path=args.save_path,
                 device=args.device, seed=args.seed,
                 checkpoint=args.checkpoint, num_points=args.num_points)


if __name__ == "__main__":
    main()
