"""Released-checkpoint parity runs of the port (counterpart of the JAX
package's tools/parity.py; reference README.md:76-147).

    python -m pvcnn_tpu_torch.tools.parity --list
    python -m pvcnn_tpu_torch.tools.parity shapenet_pvcnn_c1 --dry-run [--devices cpu]

A parity run evaluates a released `.pth.tar` with its config's voting
evaluator and prints the measured metric beside the released one. The real
run needs the released checkpoints and the datasets, which are not in the
repository: without --dry-run the tool says so and exits non-zero. It
downloads nothing.

The dry run (ShapeNet and S3DIS workloads) checks the command path end to
end on fixtures it makes: a synthetic tree from the port's own writers
(data/shapenet.py:write_synthetic; for S3DIS synthetic rooms prepared
into h5 windows by data/prepare_s3dis.py, which needs h5py) and a
checkpoint in the released files' layout, `{"model": state_dict}` of the
config's model with seeded random weights (the port's modules carry the
reference's names). It then runs the command a user would,
`python -m pvcnn_tpu_torch.evaluate <config> --configs.evaluate.
best_checkpoint_path=<checkpoint> ...`, in a process of its own, and
prints report()'s line: a number meaningless by construction. The
evaluation runs on cuda:0 unless --devices names another device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIGS = "pvcnn_tpu_torch/configs"

# workload -> (config, dataset kind, released file stem, released metric,
#              metric name)  [reference README.md:76-126]
WORKLOADS = {
    "shapenet_pointnet": (f"{CONFIGS}/shapenet/pointnet.py", "shapenet",
                          "shapenet.pointnet", 83.5, "mIoU"),
    "shapenet_pvcnn_c0p25": (f"{CONFIGS}/shapenet/pvcnn/c0p25.py",
                             "shapenet", "shapenet.pvcnn.c0p25", 84.9,
                             "mIoU"),
    "shapenet_pvcnn_c0p25_dml": (f"{CONFIGS}/shapenet/pvcnn/c0p25.py",
                                 "shapenet", "shapenet.pvcnn.c0p25.dml",
                                 85.1, "mIoU"),
    "shapenet_pvcnn_c0p5": (f"{CONFIGS}/shapenet/pvcnn/c0p5.py", "shapenet",
                            "shapenet.pvcnn.c0p5", 85.5, "mIoU"),
    "shapenet_pvcnn_c1": (f"{CONFIGS}/shapenet/pvcnn/c1.py", "shapenet",
                          "shapenet.pvcnn.c1", 85.8, "mIoU"),
    "shapenet_pvcnn_c1_dml": (f"{CONFIGS}/shapenet/pvcnn/c1.py", "shapenet",
                              "shapenet.pvcnn.c1.dml", 86.1, "mIoU"),
    "s3dis_pointnet": (f"{CONFIGS}/s3dis/pointnet/area5.py", "s3dis",
                       "s3dis.pointnet.area5", 44.03, "mIoU"),
    "s3dis_pvcnn_c0p125": (f"{CONFIGS}/s3dis/pvcnn/area5/c0p125.py", "s3dis",
                           "s3dis.pvcnn.area5.c0p125", 48.75, "mIoU"),
    "s3dis_pvcnn_c0p25": (f"{CONFIGS}/s3dis/pvcnn/area5/c0p25.py", "s3dis",
                          "s3dis.pvcnn.area5.c0p25", 53.08, "mIoU"),
    "s3dis_pvcnn_c1": (f"{CONFIGS}/s3dis/pvcnn/area5/c1.py", "s3dis",
                       "s3dis.pvcnn.area5.c1", 56.64, "mIoU"),
    "s3dis_pvcnn2_c0p5": (f"{CONFIGS}/s3dis/pvcnn2/area5/c0p5.py", "s3dis",
                          "s3dis.pvcnn2.area5.c0p5", 58.30, "mIoU"),
    "s3dis_pvcnn2_c1": (f"{CONFIGS}/s3dis/pvcnn2/area5/c1.py", "s3dis",
                        "s3dis.pvcnn2.area5.c1", 59.02, "mIoU"),
    "kitti_frustum_pointnet": (f"{CONFIGS}/kitti/frustum/pointnet.py",
                               "kitti", "kitti.frustum.pointnet", 56.90,
                               "Car 3D AP (moderate)"),
    "kitti_frustum_pvcnne": (f"{CONFIGS}/kitti/frustum/pvcnne.py", "kitti",
                             "kitti.frustum.pvcnne", 61.24,
                             "Car 3D AP (moderate)"),
}


def run_evaluate(config, overrides, ckpt, num_votes=None):
    """`python -m pvcnn_tpu_torch.evaluate <config> ...` from the
    repository's root, in a process of its own -> its stats path."""
    cmd = [sys.executable, "-m", "pvcnn_tpu_torch.evaluate",
           os.path.join(REPO, config),
           f"--configs.evaluate.best_checkpoint_path={ckpt}", *overrides]
    if num_votes is not None:
        cmd.append(f"--configs.evaluate.num_votes={num_votes}")
    print("==>", " ".join(cmd), flush=True)
    subprocess.check_call(cmd, cwd=REPO)
    return ckpt[:-len(".pth.tar")] + ".eval.npy"


def report(kind, stats_path, expected, metric):
    stats = np.load(stats_path)
    if kind == "shapenet":
        got = stats[:, 0].sum() / max(stats[:, 1].sum(), 1) * 100
    elif kind == "s3dis":
        s = stats.sum(axis=-1)
        iou = s[2] / np.maximum(s[0] + s[1] - s[2], 1)
        got = iou.mean() * 100
    else:
        got = float("nan")  # kitti: the official AP table printed above
    print(f"==> measured {metric}: {got:.2f}  (released reference: "
          f"{expected:.2f}, paper tolerance ±0.2)")
    return got


def _dry_fixture(kind, tmp):
    """A micro tree of `kind` under `tmp` -> (root, config overrides that
    fit it)."""
    rng = np.random.RandomState(0)
    if kind == "shapenet":
        from pvcnn_tpu_torch.data.shapenet import write_synthetic

        root = os.path.join(tmp, "shapenet")
        os.makedirs(root)
        write_synthetic(root, [(int(s), int(n)) for s, n in zip(
            rng.randint(0, 16, 6), rng.randint(40, 80, 6))])
        return root, ["--configs.dataset.num_points=32",
                      "--configs.model.width_multiplier=0.125"]
    if kind == "s3dis":
        from pvcnn_tpu_torch.data.prepare_s3dis import (prepare_windows,
                                                        synthetic_room)

        root = os.path.join(tmp, "s3dis")
        for area in ("Area_1", "Area_5"):
            room = os.path.join(root, area, "office_1")
            os.makedirs(room)
            xyzrgb, labels = synthetic_room(rng, 3000)
            np.save(os.path.join(room, "xyzrgb.npy"), xyzrgb)
            np.save(os.path.join(room, "label.npy"), labels)
        prepare_windows(root, max_num_points=128, rng=rng)
        return root, ["--configs.dataset.num_points=128"]
    raise SystemExit("the dry run covers the shapenet and s3dis workloads "
                     "(the KITTI evaluator's micro runs are in "
                     "tests/test_torch_kitti_eval.py)")


def _dry_checkpoint(config, overrides, tmp):
    """The config's model (with the overrides) with seeded random weights,
    saved as the released files are, {"model": state_dict} -> its path."""
    import torch

    from pvcnn_tpu_torch.utils.config import configs
    from pvcnn_tpu_torch.utils.weights import init_random_

    configs.clear()
    try:
        configs.update_from_file(os.path.join(REPO, config))
        configs.update_from_arguments(
            *(o for o in overrides if o.startswith("--configs.model.")))
        model = init_random_(configs.model(), 0)
    finally:
        configs.clear()
    path = os.path.join(tmp, "released.pth.tar")
    torch.save({"model": model.state_dict()}, path)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m pvcnn_tpu_torch.tools.parity",
        description="Evaluate a released checkpoint with its config")
    ap.add_argument("workload", nargs="?", choices=sorted(WORKLOADS))
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--devices", default=None,
                    help="device of the evaluation (default cuda:0)")
    ap.add_argument("--num-votes", type=int, default=None,
                    help="override evaluate.num_votes (the dry run uses 2)")
    args = ap.parse_args(argv)
    if args.list or not args.workload:
        for name, (cfg, kind, stem, expected, metric) in WORKLOADS.items():
            print(f"{name:28s} {cfg:52s} {metric} {expected}")
        return None
    cfg, kind, stem, expected, metric = WORKLOADS[args.workload]
    if not args.dry_run:
        raise SystemExit(
            f"{args.workload}: the released checkpoint {stem}.pth.tar and "
            f"the {kind} dataset are not in the repository, and this tool "
            "downloads nothing; --dry-run checks the command path on "
            "synthetic fixtures")
    with tempfile.TemporaryDirectory() as tmp:
        root, extra = _dry_fixture(kind, tmp)
        ckpt = _dry_checkpoint(cfg, extra, tmp)
        overrides = [f"--configs.dataset.root={root}", "--configs.seed=0",
                     *extra]
        if args.devices is not None:
            overrides += ["--devices", args.devices]
        stats = run_evaluate(cfg, overrides, ckpt, args.num_votes or 2)
        got = report(kind, stats, expected, metric)
        print("==> DRY-RUN complete: command path exercised end-to-end on "
              "synthetic fixtures (measured number is meaningless by "
              "construction)")
    return got


if __name__ == "__main__":
    main()
