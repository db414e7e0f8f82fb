"""python -m pvcnn_tpu_torch.evaluate.shapenet --root <ShapeNet tree> ...

Voting evaluation of a ShapeNet model with the port (see eval.py): PVCNN
by default, or PointNet, PointNet++ SSG or MSG (--model)."""

from __future__ import annotations

import argparse

from pvcnn_tpu_torch.evaluate.shapenet.eval import evaluate
from pvcnn_tpu_torch.models.shapenet import MODELS


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.evaluate.shapenet",
        description="ShapeNet part-segmentation voting evaluation")
    p.add_argument("--root", required=True,
                   help="ShapeNet tree (synsetoffset2category.txt, "
                        "train_test_split/, one folder per category)")
    p.add_argument("--model", choices=sorted(MODELS), default="pvcnn",
                   help="the model, with the input columns of its config")
    p.add_argument("--checkpoint", default=None,
                   help="reference .pth.tar; seeded random weights if absent")
    p.add_argument("--width", type=float, default=1.0,
                   help="width multiplier of the model")
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--num-votes", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stats-path", default=None,
                   help="save the [16, 2] IoU stats here (.npy)")
    args = p.parse_args(argv)
    evaluate(args.root, model_name=args.model, checkpoint=args.checkpoint,
             width_multiplier=args.width, num_points=args.num_points,
             num_votes=args.num_votes, batch_size=args.batch_size,
             device=args.device, seed=args.seed, stats_path=args.stats_path)


if __name__ == "__main__":
    main()
