"""python -m pvcnn_tpu_torch.train.dml --root <ShapeNet tree> ...

Deep mutual learning on ShapeNet with the port, as train_dml.py does for
the JAX package (the reference's train_dml.py): two peers of the model
named by --model (pvcnn, the default, pointnet, pointnet2ssg or
pointnet2msg) train at once on train/shapenet.py's data, recipe (Adam at
lr 1e-3, the model's epochs and schedule) and MeterShapeNet; each peer's
loss adds KL(softmax(peer) || softmax(own)) with the peer's logits
detached (train/trainer.py:DMLTrainer). The teacher's weights are drawn
with --seed, the student's with --seed + 100 (the JAX DMLTrainer's param
seeds 0 and 100), unless --checkpoint names a reference .pth.tar for both.

--scheduler-unit iter sets the lr before every step and stretches a
cosine schedule's t_max by the steps in an epoch. --no-dml trains the
model alone with the plain Trainer (the configs'
deep_mutual_learning=False).

Checkpoints, in the JAX layout under --save-path (train/trainer.py:fit):
the teacher at latest.pth.tar, the student at latest.pth.tar.student, the
teacher's of every epoch at latest/e{N}.pth.tar, and on a new best of
acc/iou_test best.pth.tar (teacher) and best_student.pth.tar (student). A
run whose save path holds latest.pth.tar resumes both peers from it, and
the step count of an iter schedule from its epoch. After each epoch the
test split is scored for both peers: the student's meters print with a
_student suffix.
The loader, writer and trace flags are train.shapenet's (--num-workers 0
with --workers-mode process, --prefetch 2, --profile); the scalars carry JAX
train_dml.py's tags (loss/train, loss/train_student, the meters and their
_student twins).
"""

from __future__ import annotations

import argparse

from pvcnn_tpu_torch.models.shapenet import MODELS
from pvcnn_tpu_torch.train.shapenet import RECIPES, train_peers
from pvcnn_tpu_torch.train.trainer import add_host_arguments, host_options

__all__ = ["main", "train"]


def train(root: str, *, model: str = "pvcnn", width_multiplier: float = 1.0,
          batch_size: int = 32, epochs: int | None = None,
          max_steps: int | None = None, save_path: str | None = None,
          device: str = "cuda", seed: int = 0,
          checkpoint: str | None = None, num_points: int = 2048,
          scheduler_unit: str = "epoch", dml: bool = True,
          num_workers: int = 0, workers_mode: str = "thread",
          prefetch: int = 2, profile: bool = False):
    """Train (or resume) two peers of `model` by deep mutual learning (one
    model with `dml=False`) -> (the teacher's last meters, the student's;
    {} without DML). `epochs` defaults to the model's recipe, `save_path`
    to the recipe's path with a `.dml` suffix."""
    if save_path is None:
        save_path = RECIPES[model][2] + ".dml"
    scores = train_peers(root, model=model,
                         width_multiplier=width_multiplier,
                         batch_size=batch_size, epochs=epochs,
                         max_steps=max_steps, save_path=save_path,
                         device=device, seed=seed, checkpoint=checkpoint,
                         num_points=num_points,
                         scheduler_unit=scheduler_unit, dml=dml,
                         num_workers=num_workers, workers_mode=workers_mode,
                         prefetch=prefetch, profile=profile)
    return scores[""], scores.get("_student", {})


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.train.dml",
        description="Train two ShapeNet part-segmentation models by deep "
                    "mutual learning")
    p.add_argument("--root", required=True,
                   help="ShapeNet tree (synsetoffset2category.txt, "
                        "train_test_split/, one folder per category)")
    p.add_argument("--model", choices=sorted(MODELS), default="pvcnn",
                   help="the peers' model, trained with its config's recipe")
    p.add_argument("--width", type=float, default=1.0,
                   help="width multiplier of the model")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--epochs", type=int, default=None,
                   help="250 for pvcnn, 200 for the others")
    p.add_argument("--max-steps", type=int, default=None,
                   help="train at most this many steps per epoch")
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--save-path", default=None,
                   help="runs/shapenet.pvcnn.c1.dml for pvcnn, else "
                        "runs/shapenet.<model>.dml")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth.tar both peers start from; seeded "
                        "random weights if absent")
    p.add_argument("--scheduler-unit", choices=("epoch", "iter"),
                   default="epoch",
                   help="set the lr per epoch, or per step (a cosine "
                        "t_max then counts steps)")
    p.add_argument("--no-dml", action="store_true",
                   help="train one model with the plain Trainer")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    add_host_arguments(p, "process")
    args = p.parse_args(argv)
    return train(args.root, model=args.model, width_multiplier=args.width,
                 batch_size=args.batch_size, epochs=args.epochs,
                 max_steps=args.max_steps, save_path=args.save_path,
                 device=args.device, seed=args.seed,
                 checkpoint=args.checkpoint, num_points=args.num_points,
                 scheduler_unit=args.scheduler_unit, dml=not args.no_dml,
                 **host_options(args))


if __name__ == "__main__":
    main()
