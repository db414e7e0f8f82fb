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
best, <save-path>/best.pth.tar and best/best.acc.iou_test.pth.tar are
written (train/trainer.py:fit). A run whose save path holds
latest.pth.tar resumes from it. Weights are drawn from a torch.Generator
seeded with --seed unless --checkpoint names a reference .pth.tar.
--max-steps cuts every epoch short (smoke runs). Both splits load with
--num-workers (0: serial; clamped to the host's cores) in --workers-mode
(process, the JAX ShapeNet config's) and --prefetch 2, train()'s own
defaults. Scalars go to a
ScalarWriter in the save path (each step's loss, perf/points_per_sec and
the meters per epoch); --profile traces steps 1-5 of the first epoch into
<save-path>/profile.
"""

from __future__ import annotations

import argparse

import torch

from pvcnn_tpu_torch.data.loader import DataLoader
from pvcnn_tpu_torch.data.shapenet import (NUM_CLASSES, NUM_SHAPES,
                                           ShapeNetDataset)
from pvcnn_tpu_torch.meters.shapenet import MeterShapeNet
from pvcnn_tpu_torch.models.shapenet import MODELS
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss, KLLoss
from pvcnn_tpu_torch.train.optim import Adam, CosineAnnealingLR, StepLR
from pvcnn_tpu_torch.train.trainer import (STUDENT_SEED_OFFSET, DMLTrainer,
                                           Trainer, add_host_arguments,
                                           check_device, fit, host_options)
from pvcnn_tpu_torch.utils.weights import (init_random_,
                                           load_reference_checkpoint)

__all__ = ["LR", "METRIC", "RECIPES", "main", "make_loaders", "make_model",
           "train", "train_peers"]

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


def make_loaders(root: str, model: str, num_points: int, batch_size: int,
                 seed: int, **options) -> dict:
    """The train split (shuffled, jittered) and the test split of the tree
    at `root`, with the input columns the model's config gives it;
    `options` are DataLoader keywords for both (num_workers, workers_mode,
    prefetch)."""
    spec = MODELS[model]
    columns = dict(with_normal=spec.with_normal,
                   with_one_hot_shape_id=spec.with_one_hot_shape_id)
    return {
        "train": DataLoader(ShapeNetDataset(root, num_points, "train",
                                            seed=seed, **columns),
                            batch_size, shuffle=True, seed=seed, **options),
        "test": DataLoader(ShapeNetDataset(root, num_points, "test",
                                           seed=seed + 1, **columns),
                           batch_size, **options),
    }


def make_model(model: str, width_multiplier: float, checkpoint: str | None,
               seed: int, device) -> torch.nn.Module:
    """The model named `model` with a reference checkpoint's weights, or
    seeded random ones, on `device`."""
    net = MODELS[model].build(NUM_CLASSES, NUM_SHAPES, width_multiplier)
    if checkpoint is not None:
        load_reference_checkpoint(net, checkpoint)
    else:
        init_random_(net, seed)
    return net.to(device)


def train(root: str, *, model: str = "pvcnn", width_multiplier: float = 1.0,
          batch_size: int = 32, epochs: int | None = None,
          max_steps: int | None = None, save_path: str | None = None,
          device: str = "cuda", seed: int = 0,
          checkpoint: str | None = None, num_points: int = 2048,
          num_workers: int = 0, workers_mode: str = "thread",
          prefetch: int = 2, profile: bool = False) -> dict:
    """Train (or resume) the model named `model` (models.shapenet.MODELS)
    and return the last evaluation's meters. `epochs` and `save_path`
    default to the model's recipe; `num_workers`, `workers_mode` and
    `prefetch` set both splits' DataLoader; `profile` traces steps 1-5 of
    the first epoch into <save_path>/profile."""
    return train_peers(root, model=model, width_multiplier=width_multiplier,
                       batch_size=batch_size, epochs=epochs,
                       max_steps=max_steps, save_path=save_path,
                       device=device, seed=seed, checkpoint=checkpoint,
                       num_points=num_points, num_workers=num_workers,
                       workers_mode=workers_mode, prefetch=prefetch,
                       profile=profile)[""]


def train_peers(root: str, *, model: str, width_multiplier: float,
                batch_size: int, epochs: int | None, max_steps: int | None,
                save_path: str | None, device: str, seed: int,
                checkpoint: str | None, num_points: int,
                scheduler_unit: str = "epoch", dml: bool = False,
                num_workers: int = 0, workers_mode: str = "thread",
                prefetch: int = 2, profile: bool = False) -> dict:
    """train's recipe for one model or, with `dml`, for two peers trained
    by deep mutual learning (the student's weights drawn with seed +
    STUDENT_SEED_OFFSET) -> trainer.fit's {peer suffix: last meters}."""
    default_epochs, schedule, default_path = RECIPES[model]
    epochs = default_epochs if epochs is None else epochs
    save_path = default_path if save_path is None else save_path
    device = check_device(device)
    loaders = make_loaders(root, model, num_points, batch_size, seed,
                           num_workers=num_workers,
                           workers_mode=workers_mode, prefetch=prefetch)
    net = make_model(model, width_multiplier, checkpoint, seed, device)
    optimizer = Adam(net.parameters(), lr=LR, weight_decay=0.0)
    if dml:
        student = make_model(model, width_multiplier, checkpoint,
                             seed + STUDENT_SEED_OFFSET, device)
        trainer = DMLTrainer(net, CrossEntropyLoss(), optimizer, student,
                             Adam(student.parameters(), lr=LR,
                                  weight_decay=0.0),
                             KLLoss(), device, seed)
    else:
        trainer = Trainer(net, CrossEntropyLoss(), optimizer, device, seed)
    return fit(trainer, loaders["train"], loaders["test"],
               lambda: {METRIC: MeterShapeNet(NUM_CLASSES, NUM_SHAPES)},
               (METRIC,), epochs=epochs, save_path=save_path,
               scheduler=schedule(epochs).bind(LR),
               scheduler_unit=scheduler_unit, max_steps=max_steps,
               profile=profile)


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
    add_host_arguments(p, "process")
    args = p.parse_args(argv)
    return train(args.root, model=args.model, width_multiplier=args.width,
                 batch_size=args.batch_size, epochs=args.epochs,
                 max_steps=args.max_steps, save_path=args.save_path,
                 device=args.device, seed=args.seed,
                 checkpoint=args.checkpoint, num_points=args.num_points,
                 **host_options(args))


if __name__ == "__main__":
    main()
