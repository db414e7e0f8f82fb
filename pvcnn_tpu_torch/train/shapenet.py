"""python -m pvcnn_tpu_torch.train.shapenet --root <ShapeNet tree> ...

Train a ShapeNet model with the port, as train.py does for the JAX
package's config of it (--model): pvcnn (configs/shapenet/pvcnn/c1.py, the
default), pointnet, pointnet2ssg or pointnet2msg
(configs/shapenet/{pointnet,pointnet2ssg,pointnet2msg}.py). The train (+
val) split resampled to 2048 points and jittered, with the input columns
the config's dataset gives the model, CrossEntropyLoss, Adam (lr 1e-3, no
weight decay), fp32 with TF32 off; PVCNN runs 250 epochs of
CosineAnnealingLR, the others 200 of StepLR (step 20, gamma 0.5), each
stepped per epoch. After each epoch the test split is
scored with MeterShapeNet (acc/iou_test) and the checkpoints
<save-path>/latest.pth.tar, <save-path>/latest/e{N}.pth.tar and, on a new
best, <save-path>/best.pth.tar are written. A run whose save path holds
latest.pth.tar resumes from it. Weights are drawn from a torch.Generator
seeded with --seed unless --checkpoint names a reference .pth.tar.
--max-steps cuts every epoch short (smoke runs).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from pvcnn_tpu_torch.data.loader import DataLoader
from pvcnn_tpu_torch.data.shapenet import (NUM_CLASSES, NUM_SHAPES,
                                           ShapeNetDataset)
from pvcnn_tpu_torch.meters.shapenet import MeterShapeNet
from pvcnn_tpu_torch.models.shapenet import MODELS
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train.optim import Adam, CosineAnnealingLR, StepLR
from pvcnn_tpu_torch.train.trainer import (Trainer, copy_checkpoint,
                                           load_checkpoint, save_checkpoint)
from pvcnn_tpu_torch.utils.weights import (init_random_,
                                           load_reference_checkpoint)

__all__ = ["main", "train"]

METRIC = "acc/iou_test"
LR = 1e-3
# each model's epochs and schedule (epochs -> epoch -> lr factor) and
# default save path, as its JAX config sets them
RECIPES = {
    "pvcnn": (250, lambda epochs: CosineAnnealingLR(t_max=epochs),
              "runs/shapenet.pvcnn.c1"),
    **{name: (200, lambda epochs: StepLR(step_size=20, gamma=0.5),
              f"runs/shapenet.{name}")
       for name in ("pointnet", "pointnet2ssg", "pointnet2msg")},
}


def train(root: str, *, model: str = "pvcnn", width_multiplier: float = 1.0,
          batch_size: int = 32, epochs: int | None = None,
          max_steps: int | None = None, save_path: str | None = None,
          device: str = "cuda", seed: int = 0,
          checkpoint: str | None = None, num_points: int = 2048) -> dict:
    """Train (or resume) the model named `model` (models.shapenet.MODELS)
    and return the last evaluation's meters. `epochs` and `save_path`
    default to the model's recipe."""
    spec = MODELS[model]
    default_epochs, schedule, default_path = RECIPES[model]
    epochs = default_epochs if epochs is None else epochs
    save_path = default_path if save_path is None else save_path
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    columns = dict(with_normal=spec.with_normal,
                   with_one_hot_shape_id=spec.with_one_hot_shape_id)
    loaders = {
        "train": DataLoader(ShapeNetDataset(root, num_points, "train",
                                            seed=seed, **columns),
                            batch_size, shuffle=True, seed=seed),
        "test": DataLoader(ShapeNetDataset(root, num_points, "test",
                                           seed=seed + 1, **columns),
                           batch_size),
    }
    net = spec.build(NUM_CLASSES, NUM_SHAPES, width_multiplier)
    if checkpoint is not None:
        load_reference_checkpoint(net, checkpoint)
    else:
        init_random_(net, seed)
    net = net.to(device)
    optimizer = Adam(net.parameters(), lr=LR, weight_decay=0.0)
    scheduler = schedule(epochs).bind(LR)
    trainer = Trainer(net, CrossEntropyLoss(), optimizer, device, seed)

    latest = os.path.join(save_path, "latest.pth.tar")
    start, best = 0, None
    if os.path.exists(latest):
        print(f'==> loading checkpoint "{latest}"')
        epoch, meters = load_checkpoint(latest, trainer.model, optimizer)
        start, best = epoch + 1, meters.get(METRIC + "_best")

    def evaluate():
        return trainer.evaluate(loaders["test"],
                                {METRIC: MeterShapeNet(NUM_CLASSES,
                                                       NUM_SHAPES)})

    if start >= epochs:                   # finished: report once
        meters = evaluate()
        for k, v in meters.items():
            print(f"[{k}] = {v:2f}")
        return meters

    for epoch in range(start, epochs):
        print(f"\n==> training epoch {epoch}/{epochs}")
        begin = time.perf_counter()
        loss = trainer.train_epoch(loaders["train"], epoch, scheduler,
                                   max_steps)
        seconds = time.perf_counter() - begin
        print(f"[loss/train] = {loss:.6f}  [seconds] = {seconds:.3f}")
        meters = evaluate()
        is_best = best is None or best < meters[METRIC]
        if is_best:
            best = meters[METRIC]
        meters[METRIC + "_best"] = best
        for k, v in meters.items():
            print(f"[{k}] = {v:2f}")
        save_checkpoint(latest, epoch, trainer.model, optimizer, meters)
        copy_checkpoint(latest, os.path.join(save_path, "latest",
                                             f"e{epoch}.pth.tar"))
        if is_best:
            copy_checkpoint(latest, os.path.join(save_path, "best.pth.tar"))
        print(f"[save_path] = {save_path}")
    return meters


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.train.shapenet",
        description="Train a ShapeNet part-segmentation model")
    p.add_argument("--root", required=True,
                   help="ShapeNet tree (synsetoffset2category.txt, "
                        "train_test_split/, one folder per category)")
    p.add_argument("--model", choices=sorted(MODELS), default="pvcnn",
                   help="the model, trained with its config's recipe")
    p.add_argument("--width", type=float, default=1.0,
                   help="width multiplier of the model")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=None,
                   help="250 for pvcnn, 200 for the others")
    p.add_argument("--max-steps", type=int, default=None,
                   help="train at most this many steps per epoch")
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--save-path", default=None,
                   help="runs/shapenet.pvcnn.c1 for pvcnn, else "
                        "runs/shapenet.<model>")
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
