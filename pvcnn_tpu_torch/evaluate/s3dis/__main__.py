"""python -m pvcnn_tpu_torch.evaluate.s3dis --root <prepared tree> ...

Scene-level voting evaluation of an S3DIS model with the port (see
eval.py): PVCNN by default, or PVCNN2 or PointNet (--model), on the rooms
of the holdout area, from --checkpoint (by default best.pth.tar under the
save path of the model's recipe, runs/s3dis.<model>.area5.c1 for width 1).
Prints the class IoUs, the overall accuracy and the mIoU, and keeps the
stats beside the checkpoint (.eval.npy) unless --stats-path names another
file; a later run prints those."""

from __future__ import annotations

import argparse

from pvcnn_tpu_torch.evaluate.s3dis.eval import evaluate
from pvcnn_tpu_torch.models.s3dis import HOLDOUT_AREA, MODELS


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.evaluate.s3dis",
        description="S3DIS scene-level voting evaluation")
    p.add_argument("--root", required=True,
                   help="prepared tree (Area_N/<room>/{zero,half}_0.h5 and "
                        "label.npy; data/prepare_s3dis.py)")
    p.add_argument("--model", choices=sorted(MODELS), default="pvcnn")
    p.add_argument("--width", type=float, default=1.0,
                   help="width multiplier of the model")
    p.add_argument("--checkpoint", default=None,
                   help="the port's training checkpoint or a reference "
                        ".pth.tar (default: best.pth.tar of the recipe's "
                        "save path)")
    p.add_argument("--num-points", type=int, default=None,
                   help="points a sub-cloud (default: the recipe's)")
    p.add_argument("--holdout-area", type=int, default=HOLDOUT_AREA)
    p.add_argument("--num-votes", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=10,
                   help="windows a forward")
    p.add_argument("--stats-path", default=None,
                   help="default: the checkpoint's path with .eval.npy")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    return evaluate(args.root, model_name=args.model,
                    checkpoint=args.checkpoint, width_multiplier=args.width,
                    num_points=args.num_points,
                    holdout_area=args.holdout_area, num_votes=args.num_votes,
                    batch_size=args.batch_size, stats_path=args.stats_path,
                    device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
