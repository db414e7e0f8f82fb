"""S3DIS PVCNN with bf16 activations on its switched branches, against the
JAX package's PVCNN(dtype="bfloat16") and its fp32 PVCNN: all three
switches on (the opt-in path: PVCNN_TPU_DENSE_BN_FUSED=auto,
PVCNN_TPU_CONV_ROWS=0, PVCNN_TPU_CUSTOM_CONV_WGRAD=1) and the unfused rows
branch (PVCNN_TPU_CONV_BN_FUSED=0): the eval forward, the train-mode
gradients, a 3-step Adam trajectory (the c1 recipe's weight decay) and
the dtypes of every layer's output, by tests/test_torch_bf16_pvcnn2.py's
checks and rule.

The JAX side runs its bf16 model under the same switches with its Pallas
kernels in interpret mode (its fused SharedMLP and its rows branch take
no other route on the CPU), one compile a function and setting: the
switches hold for the whole module, as the JAX models read them when
they trace. Its NDHWC weight gradient takes its XLA formulation
(PVCNN_TPU_XLA_CONV_WGRAD_ONLY=1: the same function, which
tests/test_torch_bf16_optin_ops.py holds the port's to by both routes;
interpreted, the Pallas kernel took 6 s a step here against 0.1). Its
fp32 reference is the fp32 model of its default path, one compile for
both settings (the
switches change the order of an fp32 step's sums, not its function: the
port's fp32 steps with and without them agree to 1e-4, tests/
test_torch_pvcnn_s3dis.py).

Model size: width 0.25, voxel resolution multiplier 0.25 (PVConv grids at
R = 8 and 4), dropout off, on B = 8 windows of N = 256 points (2,048 rows,
above the 1,024 the fused layers take). At B = 4 the cloud MLP's
BatchNorm normalizes over four samples and one batch's bf16 step-1
gradients are a noisy sample of bf16's: with all three switches on, over
batches 2-7 JAX bf16's lay 0.26-0.74 (rel-L2) from its fp32 ones and
the port's 0.26-0.50, 0.24-1.44 apart (the rule's sqrt(2) own + 1e-3
missed at 3 of 6), though the two fused SharedMLPs agree bit for bit alone;
at B = 8 JAX's lay 0.19-0.46, the port's 0.20-0.40, 0.20-0.32 apart,
within the rule at every batch.
"""

import jax
import numpy as np
import pytest
import torch

from pvcnn_tpu.models.s3dis import PVCNN as JPVCNN
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.models.s3dis import PVCNN
from pvcnn_tpu_torch.nn import BatchNorm, PVConv, Voxelization
from test_torch_bf16_pvcnn2 import (check_eval_forward,  # noqa: F401
                                    check_train_gradients, check_trajectory,
                                    few_threads, jax_grad_fn, make_case)
from test_torch_pvcnn2 import windows
from test_torch_train import no_dropout  # noqa: F401 (fixture)

B, N = 8, 256
SIZE = dict(width_multiplier=0.25, voxel_resolution_multiplier=0.25)
SWITCHES = {"PVCNN_TPU_DENSE_BN_FUSED": "auto", "PVCNN_TPU_CONV_ROWS": "0",
            "PVCNN_TPU_CUSTOM_CONV_WGRAD": "1"}
SETTINGS = {"switches": SWITCHES, "unfused": {"PVCNN_TPU_CONV_BN_FUSED": "0"}}


def build_case():
    """The S3DIS PVCNN case at this module's size (make_case)."""
    return make_case(
        lambda dt: JPVCNN(num_classes=13, extra_feature_channels=6,
                          dtype=dt, **SIZE),
        lambda dt: PVCNN(13, 6, dtype=dt, **SIZE),
        ci.pvcnn_s3dis_mapping(), lambda seed: windows(seed, B, N), 13)


@pytest.fixture(scope="module")
def fp32_step():
    """The JAX fp32 model's jitted step of the default path, traced (with
    the switches and interpret mode unset) at the module's batch shape."""
    case = build_case()
    x, y = case.inputs(0)
    with pytest.MonkeyPatch.context() as mp:
        for name in (*SWITCHES, "PVCNN_TPU_CONV_BN_FUSED",
                     "PVCNN_TPU_PALLAS_INTERPRET"):
            mp.delenv(name, raising=False)
        with jax.default_matmul_precision("float32"):
            jax_grad_fn(case, None)(case.variables["params"], x,
                                    y.astype(np.int32))
    return case.jitted[None]


def switched_case(env: dict, fp32_step, interpret: bool = True):
    """A generator fixture's body: the environment `env` (with the JAX
    package's Pallas kernels in interpret mode where `interpret`) for as
    long as the case lives, the case built under it, its fp32 step the
    shared default-path one."""
    with pytest.MonkeyPatch.context() as mp:
        for name in (*SWITCHES, "PVCNN_TPU_CONV_BN_FUSED"):
            mp.delenv(name, raising=False)
        for name, value in env.items():
            mp.setenv(name, value)
        mp.setenv("PVCNN_TPU_PALLAS_INTERPRET", "1" if interpret else "0")
        mp.setenv("PVCNN_TPU_XLA_CONV_WGRAD_ONLY", "1")
        case = build_case()
        case.jitted[None] = fp32_step
        yield case


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def case(request, fp32_step):
    yield from switched_case(SETTINGS[request.param], fp32_step)


def test_eval_forward(case):
    check_eval_forward(case, 5)


def test_train_gradients(case, no_dropout):
    check_train_gradients(case, 2)


def test_three_step_trajectory(case, no_dropout):
    check_trajectory(case, weight_decay=1e-5)


def test_bf16_through_every_layer(case):
    """In a training forward on the switched branches every module that
    runs, the voxel branches' BatchNorms and LeakyReLUs, the fused
    SharedMLPs' ReLUs, the cloud MLP and the classifier, gives bf16 (the
    first PVConv's voxelization excepted: it averages the float32 cloud,
    as in the JAX package)."""
    model = case.port().train()
    outs, hooks = [], []
    for name, mod in model.named_modules():
        if name and not isinstance(mod, Voxelization):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: outs.append(
                    (name, (o[0] if isinstance(o, tuple) else o).dtype))))
    x, _ = windows(9, B, N)
    with torch.no_grad():
        model(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    ran = {name for name, _ in outs}
    modules = dict(model.named_modules())
    assert any(".voxel_layers." in name for name in ran)
    assert any(isinstance(modules[n], BatchNorm) for n in ran)
    assert sum(isinstance(modules[n], PVConv) for n in ran) == 4
    assert {dt for _, dt in outs} == {torch.bfloat16}, outs
