"""python -m pvcnn_tpu_torch.evaluate.kitti.frustum --root <frustum data> ...

KITTI Frustum detection evaluation of a Frustum model with the port (see
eval.py): FrustumPVCNNE by default, or FrustumPointNet2 or FrustumPointNet
(--model), on the rgb-detection frustums of the val split, scored with the
official KITTI AP over --num-tests reseeded tests."""

from __future__ import annotations

import argparse

from pvcnn_tpu_torch.evaluate.kitti.frustum.eval import evaluate
from pvcnn_tpu_torch.models.kitti.frustum import MODELS


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.evaluate.kitti.frustum",
        description="KITTI Frustum detection evaluation from 2-D "
                    "detections")
    p.add_argument("--root", required=True,
                   help="folder of frustum_carpedcyc_val_rgb_detection"
                        ".pickle")
    p.add_argument("--ground-truth", default=None,
                   help="folder of KITTI label files (default "
                        "<root>/ground_truth)")
    p.add_argument("--image-ids", default=None,
                   help="list of the val image ids (default "
                        "<root>/image_sets/val.txt)")
    p.add_argument("--model", choices=sorted(MODELS), default="pvcnne")
    p.add_argument("--checkpoint", default=None,
                   help="the port's training checkpoint or a reference "
                        ".pth.tar; seeded random weights if absent")
    p.add_argument("--width", type=float, default=1.0,
                   help="width multiplier of the model")
    p.add_argument("--num-tests", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--output", default=None,
                   help="prefix of the stats (.eval.npy) and predictions "
                        "(.predictions) paths (default: the checkpoint's "
                        "path without its extension)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    return evaluate(args.root, model_name=args.model,
                    checkpoint=args.checkpoint, width_multiplier=args.width,
                    batch_size=args.batch_size, num_tests=args.num_tests,
                    ground_truth=args.ground_truth, image_ids=args.image_ids,
                    output=args.output, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
