"""python -m pvcnn_tpu_torch.train.s3dis --root <prepared tree> ...

Train an S3DIS model with the port, as train.py does for the JAX package's
configs/s3dis/<model>/area5 configs (--model): pvcnn (the default),
pvcnn2 or pointnet, each with its recipe (models/s3dis MODELS): windows of
the prepared tree at --root (data/s3dis.py; 4,096 points, 8,192 for
pvcnn2) from every area but the holdout area, shuffled, CrossEntropyLoss,
Adam at lr 1e-3 with the model's weight decay and schedule, 50 epochs at
batch 32, fp32 with TF32 off. After each epoch the holdout area's windows
are scored with MeterS3DIS (acc/iou_test: the mIoU, acc/acc_test: the
overall accuracy) and the checkpoints <save-path>/latest.pth.tar and
latest/e{N}.pth.tar are written, with, on a new best acc/iou_test,
best.pth.tar (the scene evaluator's checkpoint) and
best/best.acc.iou_test.pth.tar (train/trainer.py:fit). A run whose save
path holds latest.pth.tar resumes from it. Weights are drawn from a
torch.Generator seeded with --seed unless --checkpoint names a reference
.pth.tar; the reader draws from np.random.RandomState(--seed). The save
path defaults to the JAX train.py's, runs/s3dis.<model>.area5.c1 at width
1 (runs/s3dis.pointnet.area5 for pointnet). --max-steps cuts every epoch
short (smoke runs). Both splits load with --num-workers (0: serial;
clamped to the host's cores) in --workers-mode (thread, the JAX configs')
and --prefetch 2, train()'s own defaults. Scalars go to a ScalarWriter in
the save path; --profile
traces steps 1-5 of the first epoch into <save-path>/profile.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from pvcnn_tpu_torch.data.loader import DataLoader
from pvcnn_tpu_torch.data.s3dis import S3DIS, open_h5
from pvcnn_tpu_torch.meters.s3dis import MeterS3DIS
from pvcnn_tpu_torch.models import s3dis
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train.optim import Adam
from pvcnn_tpu_torch.train.trainer import (Trainer, add_host_arguments,
                                           check_device, fit, host_options)
from pvcnn_tpu_torch.utils.weights import (init_random_,
                                           load_reference_checkpoint)

__all__ = ["METRIC", "TimedLoader", "main", "meters", "train"]

# the configs' metric for the best checkpoints
METRIC = "acc/iou_test"


def meters() -> dict:
    """The configs' two meters of the test split, by name."""
    return {METRIC: MeterS3DIS("iou", s3dis.NUM_CLASSES),
            "acc/acc_test": MeterS3DIS("overall", s3dis.NUM_CLASSES)}


class TimedLoader:
    """A loader whose batches are timed: the seconds spent waiting for each
    batch add up under timings[key]. `epoch` and close() pass through."""

    def __init__(self, loader, timings: dict, key: str):
        self.loader, self.timings, self.key = loader, timings, key
        timings.setdefault(key, 0.0)

    @property
    def epoch(self):
        return self.loader.epoch

    @epoch.setter
    def epoch(self, epoch):
        self.loader.epoch = epoch

    def __len__(self):
        return len(self.loader)

    def close(self):
        self.loader.close()

    def __iter__(self):
        batches = iter(self.loader)
        try:
            while True:
                start = time.perf_counter()
                batch = next(batches, None)
                self.timings[self.key] += time.perf_counter() - start
                if batch is None:
                    return
                yield batch
        finally:
            batches.close()


def train(root: str, *, model: str = "pvcnn", width_multiplier: float = 1.0,
          batch_size: int = s3dis.BATCH_SIZE, epochs: int = s3dis.EPOCHS,
          max_steps: int | None = None, save_path: str | None = None,
          device: str = "cuda", seed: int = 0,
          checkpoint: str | None = None, num_points: int | None = None,
          holdout_area: int = s3dis.HOLDOUT_AREA, opener=open_h5,
          timings: dict | None = None, num_workers: int = 0,
          workers_mode: str = "thread", prefetch: int = 2,
          profile: bool = False) -> dict:
    """Train (or resume) the S3DIS model named `model` (models.s3dis.MODELS)
    and return the last evaluation's meters. `num_points` and `save_path`
    default to the model's recipe; `opener` reads the window files
    (data/s3dis.py); `num_workers`, `workers_mode` and `prefetch` set both
    splits' DataLoader; `profile` traces steps 1-5 of the first epoch into
    <save_path>/profile. `timings`, if given, gets the seconds of training
    and scoring (trainer.fit) and, within them, of waiting for the train
    and test batches ("train_data", "test_data")."""
    spec = s3dis.MODELS[model]
    num_points = spec.num_points if num_points is None else num_points
    if save_path is None:
        save_path = s3dis.save_path(model, width_multiplier, holdout_area)
    device = check_device(device)
    dataset = S3DIS(root, num_points, holdout_area=holdout_area,
                    rng=np.random.RandomState(seed), opener=opener)
    options = dict(num_workers=num_workers, workers_mode=workers_mode,
                   prefetch=prefetch)
    train_loader = DataLoader(dataset["train"], batch_size, shuffle=True,
                              seed=seed, **options)
    test_loader = DataLoader(dataset["test"], batch_size, **options)
    if timings is not None:
        train_loader = TimedLoader(train_loader, timings, "train_data")
        test_loader = TimedLoader(test_loader, timings, "test_data")
    net = spec.build(width_multiplier)
    if checkpoint is not None:
        load_reference_checkpoint(net, checkpoint)
    else:
        init_random_(net, seed)
    net = net.to(device)
    optimizer = Adam(net.parameters(), lr=s3dis.LR,
                     weight_decay=spec.weight_decay)
    trainer = Trainer(net, CrossEntropyLoss(), optimizer, device, seed)
    return fit(trainer, train_loader, test_loader, meters, (METRIC,),
               epochs=epochs, save_path=save_path,
               scheduler=spec.scheduler().bind(s3dis.LR),
               max_steps=max_steps, timings=timings, profile=profile)[""]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.train.s3dis",
        description="Train an S3DIS semantic-segmentation model")
    p.add_argument("--root", required=True,
                   help="prepared tree (Area_N/<room>/{zero,half}_0.h5; "
                        "data/prepare_s3dis.py)")
    p.add_argument("--model", choices=sorted(s3dis.MODELS), default="pvcnn",
                   help="the model, trained with its config's recipe")
    p.add_argument("--width", type=float, default=1.0,
                   help="width multiplier of the model")
    p.add_argument("--batch-size", type=int, default=s3dis.BATCH_SIZE)
    p.add_argument("--epochs", type=int, default=s3dis.EPOCHS)
    p.add_argument("--max-steps", type=int, default=None,
                   help="train at most this many steps per epoch")
    p.add_argument("--num-points", type=int, default=None,
                   help="points a window (default: the recipe's)")
    p.add_argument("--holdout-area", type=int, default=s3dis.HOLDOUT_AREA)
    p.add_argument("--save-path", default=None,
                   help="default runs/s3dis.<model>.area5.c<width> "
                        "(runs/s3dis.pointnet.area5)")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth.tar to start from; seeded random "
                        "weights if absent")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    add_host_arguments(p, "thread")
    args = p.parse_args(argv)
    return train(args.root, model=args.model, width_multiplier=args.width,
                 batch_size=args.batch_size, epochs=args.epochs,
                 max_steps=args.max_steps, save_path=args.save_path,
                 device=args.device, seed=args.seed,
                 checkpoint=args.checkpoint, num_points=args.num_points,
                 holdout_area=args.holdout_area, **host_options(args))


if __name__ == "__main__":
    main()
