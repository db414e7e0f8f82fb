"""python -m pvcnn_tpu_torch.evaluate <config.py> [--devices SPEC]
[--configs.x.y=z ...]

Run the evaluator of a config of the port's tree: the same as
`python -m pvcnn_tpu_torch.train <config.py> --evaluate` (counterpart of
pvcnn_tpu/evaluate/__main__.py). The checkpoint is
--configs.evaluate.best_checkpoint_path, by default the config's save
path's best.pth.tar.
"""

from __future__ import annotations

import sys


def main(argv=None):
    from pvcnn_tpu_torch.train.__main__ import main as train_main

    argv = sys.argv[1:] if argv is None else list(argv)
    return train_main([*argv, "--evaluate"])


if __name__ == "__main__":
    main()
