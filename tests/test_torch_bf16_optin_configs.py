"""The S3DIS PVCNN config with --configs.model.dtype=bfloat16 and the three
switches that open its opt-in path (PVCNN_TPU_DENSE_BN_FUSED=auto,
PVCNN_TPU_CONV_ROWS=0, PVCNN_TPU_CUSTOM_CONV_WGRAD=1) through the
config-driven entry points (train/cli.py's prepare and run, the
evaluator), over tests/test_torch_bf16_configs.py's WindowStore of
synthetic rooms: a few CPU steps at width 0.125 with finite meters, the
fused SharedMLPs and the NDHWC weight gradient on bf16 operands (their
kernels' plain versions here), and the evaluator's finite stats from the
run's best checkpoint.
"""

import os

import numpy as np
import torch

from pvcnn_tpu_torch.ops import conv3d, dense_rows
from pvcnn_tpu_torch.train.cli import prepare, run
from test_torch_bf16_configs import CONFIGS, few_threads, rooms  # noqa: F401

SWITCHES = {"PVCNN_TPU_DENSE_BN_FUSED": "auto", "PVCNN_TPU_CONV_ROWS": "0",
            "PVCNN_TPU_CUSTOM_CONV_WGRAD": "1"}


def test_s3dis_pvcnn_config_runs_bf16_switched(rooms, tmp_path, monkeypatch):
    root, store = rooms
    for name, value in SWITCHES.items():
        monkeypatch.setenv(name, value)
    seen = []
    for module, name in ((dense_rows, "_forward_plain"),
                         (dense_rows, "_wgrad_plain"),
                         (conv3d, "_ndhwc_wgrad_plain")):
        plain = getattr(module, name)
        monkeypatch.setattr(module, name, lambda x, *a, plain=plain,
                            name=name: (seen.append((name, x.dtype)),
                                        plain(x, *a))[1])
    # 4 windows of 256 points: the 1,024 rows the fused layers take
    args = [os.path.join(CONFIGS, "s3dis/pvcnn/area5/c1.py"), "--devices",
            "cpu", "--configs.model.dtype=bfloat16",
            "--configs.model.width_multiplier=0.125",
            f"--configs.dataset.root={root}",
            "--configs.dataset.num_points=256",
            "--configs.train.batch_size=4", "--configs.train.num_epochs=1",
            "--configs.train.max_steps=2", "--configs.evaluate.batch_size=4",
            f"--configs.train.save_path={tmp_path / 'run'}"]
    configs = prepare(args)
    assert configs.model().act_dtype == torch.bfloat16
    configs.dataset.opener = store
    meters = run(configs)
    assert all(np.isfinite(v) for v in meters.values()), meters
    assert {name for name, dt in seen if dt == torch.bfloat16} == {
        "_forward_plain", "_wgrad_plain", "_ndhwc_wgrad_plain"}
    configs = prepare(args + ["--evaluate"])
    configs.dataset.opener = store
    stats = configs.evaluate.fn(configs)
    assert np.isfinite(stats).all() and stats[1].sum() > 0
