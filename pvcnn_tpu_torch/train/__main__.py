"""python -m pvcnn_tpu_torch.train <config.py> [--devices SPEC] [--evaluate]
[--configs.x.y=z ...]

Train the model a config of the port's tree (pvcnn_tpu_torch/configs/)
describes, as the JAX package's train.py does for its tree: prepare the
config (train/cli.py), then with --evaluate run its evaluator
(configs.evaluate.fn), else train it (cli.run), resuming from the save
path's latest.pth.tar. The run goes on cuda:0 unless --devices names
another card or `cpu`.

    python -m pvcnn_tpu_torch.train pvcnn_tpu_torch/configs/shapenet/pvcnn/c1.py \\
        --configs.dataset.root=<ShapeNet tree>
"""

from __future__ import annotations

from pvcnn_tpu_torch.train.cli import prepare, run


def main(argv=None):
    configs = prepare(argv)
    if configs.evaluate is not None:
        return configs.evaluate.fn(configs)
    return run(configs)


if __name__ == "__main__":
    main()
