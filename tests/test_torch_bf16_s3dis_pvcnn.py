"""S3DIS PVCNN with bf16 activations (dtype="bfloat16") against the JAX
package's PVCNN(dtype="bfloat16") and its fp32 PVCNN on its default path:
the eval forward, the train-mode gradients, a 3-step Adam trajectory (the
c1 recipe's weight decay) and the dtypes of what a step keeps, by
tests/test_torch_bf16_pvcnn2.py's checks and rule.

Model size as tests/test_torch_pvcnn_s3dis.py: width 0.25, voxel
resolution multiplier 0.25 (PVConv grids at R = 8 and 4), B = 4 windows
of N = 256 points (at B = 2 the cloud MLP's BatchNorm normalizes over two
samples: JAX's own fp32 gradients lie 0.57 (rel-L2) from its fp64 ones),
dropout off. The cloud MLP (DenseBNReLU) runs in bf16 on the points' max,
and the classifier's SplitDense takes the [B, 1, C] cloud segment.
"""

import pytest
import torch

from pvcnn_tpu.models.s3dis import PVCNN as JPVCNN
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.models.s3dis import PVCNN
from test_torch_bf16_pvcnn2 import (check_eval_forward,  # noqa: F401
                                    check_train_gradients, check_trajectory,
                                    few_threads, make_case)
from test_torch_pvcnn2 import windows
from test_torch_train import no_dropout  # noqa: F401 (fixture)

B, N = 4, 256
SIZE = dict(width_multiplier=0.25, voxel_resolution_multiplier=0.25)


@pytest.fixture(scope="module")
def case():
    return make_case(
        lambda dt: JPVCNN(num_classes=13, extra_feature_channels=6,
                          dtype=dt, **SIZE),
        lambda dt: PVCNN(13, 6, dtype=dt, **SIZE),
        ci.pvcnn_s3dis_mapping(), lambda seed: windows(seed, B, N), 13)


def test_eval_forward(case):
    check_eval_forward(case, 5)


def test_train_gradients(case, no_dropout):
    check_train_gradients(case, 2)


def test_three_step_trajectory(case, no_dropout):
    check_trajectory(case, weight_decay=1e-5)


def test_bf16_through_every_layer(case):
    """The point blocks, the cloud MLP and the classifier all run bf16:
    each layer's output is bf16, the cloud feature [B, C] too."""
    model = case.port().eval()
    outs = []
    hooks = [m.register_forward_hook(lambda mod, i, o: outs.append(
        (type(mod).__name__, (o[0] if isinstance(o, tuple) else o).dtype)))
        for m in list(model.point_features) + list(model.cloud_features)
        + list(model.classifier)]
    x, _ = windows(9, B, N)
    with torch.no_grad():
        model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert len(outs) == len(hooks)
    assert {dt for _, dt in outs} == {torch.bfloat16}, outs
