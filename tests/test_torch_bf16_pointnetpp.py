"""ShapeNet PointNet++ SSG and MSG with bf16 activations (dtype="bfloat16")
against the JAX package's PointNet2(dtype="bfloat16") and its fp32 self:
the eval forward, the train-mode gradients, a 3-step Adam trajectory and
the dtypes of what a step keeps, by tests/test_torch_bf16_pvcnn2.py's
checks and rule.

Model size as tests/test_torch_pointnet2.py: the shrunk blocks of
tests/test_model_parity.py (SSG_SA / MSG_SA, FP_BLOCKS) at width 0.5,
N = 128 ShapeNet-like clouds (SSG: xyz and normals; MSG: with the one-hot
shape id), dropout off, at B = 8: the group-all level's SharedMLP
normalizes one row a cloud, and over B = 2 rows a BatchNorm maps them to
+-1 whatever they hold, so a rounding that swaps their order moves its
output by its whole size (at B = 2 JAX's own bf16 train-mode logits lay
0.79 (rel-L2) from its fp32 ones in MSG). The float32 input reaches SA1 as float32
normals (no gradient), the last FP's skip as the float32 input; every
SharedMLP rounds its float32 concatenation to bf16.
"""

import pytest
import torch

from pvcnn_tpu.models.shapenet import PointNet2 as JPointNet2
from pvcnn_tpu_torch.models.shapenet import PointNet2
from test_model_parity import FP_BLOCKS, MSG_SA, SSG_SA, _pointnet2_mapping
from test_torch_bf16_pvcnn2 import (check_eval_forward,  # noqa: F401
                                    check_train_gradients, check_trajectory,
                                    few_threads, make_case)
from test_torch_pointnet2 import WIDTH, _shapenet_inputs
from test_torch_train import no_dropout  # noqa: F401 (fixture)

B = 8


@pytest.fixture(scope="module", params=["ssg", "msg"])
def case(request):
    msg = request.param == "msg"
    sa = MSG_SA if msg else SSG_SA
    inputs = _shapenet_inputs(slice(0, 22 if msg else 6))
    kw = dict(with_one_hot_shape_id=msg, extra_feature_channels=3,
              width_multiplier=WIDTH)
    return make_case(
        lambda dt: JPointNet2(num_classes=50, num_shapes=16, sa_blocks=sa,
                              fp_blocks=FP_BLOCKS, dtype=dt, **kw),
        lambda dt: PointNet2(50, 16, sa, FP_BLOCKS, dtype=dt, **kw),
        _pointnet2_mapping(sa), lambda seed: inputs(seed, B), 50)


def test_eval_forward(case):
    check_eval_forward(case, 5)


def test_train_gradients(case, no_dropout):
    check_train_gradients(case, 2)


def test_three_step_trajectory(case, no_dropout):
    check_trajectory(case, weight_decay=0.0)


def test_take_rows_backwards_run_in_bf16(case, monkeypatch):
    """The take_rows backwards of a training step (SA2's groupings of SA1's
    features and the three FP interpolations; SA1 groups the input
    normals, which take no gradient) all get a bf16 cotangent."""
    from pvcnn_tpu_torch.ops import gather_utils

    seen = []
    scatter_sum = gather_utils.scatter_sum
    monkeypatch.setattr(gather_utils, "scatter_sum", lambda g, i, m: (
        seen.append(g.dtype), scatter_sum(g, i, m))[1])
    x, y = case.inputs(7)
    model = case.port().train()
    out = model(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(out.float().reshape(-1, 50),
                                      torch.from_numpy(y).reshape(-1)
                                      ).backward()
    branches = len(model.sa_layers[1].groupers)
    assert seen == [torch.bfloat16] * (branches + 3)
