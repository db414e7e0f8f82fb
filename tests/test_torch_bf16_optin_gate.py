"""Where the opt-in path's bf16 kernels run: the fused SharedMLP's gate and
the NDHWC weight gradient's route, against the JAX package's plans.

The fused dense layer (K9 / K10) runs where the JAX package's
dense_rows_plan(rows, ci, co, dtype) plans: the port's SharedMLP gate
(nn/shared_mlp.py:_fused_rows over ops/dense_rows.py:dense_rows_plan, the
plan restated) accepts the same layers, in bf16 and in fp32, at every
SharedMLP layer of the S3DIS PVCNN 1x and ShapeNet PointNet++ MSG 1x
training steps (the fused ones of chip_smoke.py's call tables, and those
whose input is a list or under 1,024 rows) and at edges of the plan: rows
under 1,024 or off its 256-row tiles, and layers wide enough that the
VMEM budget takes them in bf16 and not in fp32.

The NDHWC branch's weight gradient (PVCNN_TPU_CUSTOM_CONV_WGRAD=1): on a
TPU the JAX package runs its Pallas kernel where conv3d_wgrad_plan plans
(S3DIS PVCNN 1x: the two convs at R = 32 in bf16, the first only in
fp32) and its XLA formulation elsewhere (the grids under 18^3 = 5,832
voxels a cloud: R = 16), one function; the port runs K11 at every conv
(its bf16 mode here, on K4's bf16 plan), the same function, which
tests/test_torch_bf16_optin_ops.py holds to both JAX routes.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from pvcnn_tpu.ops.pallas import conv_wgrad as j_conv_wgrad
from pvcnn_tpu.ops.pallas.dense_rows import dense_rows_plan as j_plan
from pvcnn_tpu_torch.nn import shared_mlp
from pvcnn_tpu_torch.ops import conv3d

ROWS3 = chip_smoke.B * chip_smoke.N3


def _fused():
    """(rows, Ci, Co) of the fused layers of chip_smoke.py's opt-in call
    tables (S3DIS PVCNN 1x, MSG 1x)."""
    fused = {(ROWS3,) + c[:2] for (k, c), _ in chip_smoke.CALLS3_ON.items()
             if k == "dense_rows_fwd"}
    return fused | {c[:3] for (k, c), _ in chip_smoke.CALLS_MSG_ON.items()
                    if k == "dense_rows_fwd"}


def _layers():
    """(rows, Ci, Co) of every SharedMLP layer of the two steps, then the
    edges."""
    fused = _fused()
    # S3DIS PVCNN's cloud MLP on the B clouds' maxima (1024 -> 256 -> 128),
    # ShapeNet PointNet's 512 -> 2048 point block on 65,536 rows (fp32:
    # XLA's, bf16: fused); the edges: too few rows, rows off the tiles,
    # and wide layers that only bf16's half-size blocks fit into the VMEM
    # budget
    other = {(chip_smoke.B, 1024, 256), (chip_smoke.B, 256, 128),
             (chip_smoke.B * chip_smoke.N, 512, 2048),
             (1023, 64, 64), (1024, 64, 64), (1280, 64, 64), (1536, 9, 64),
             (4096, 1536, 1536), (4096, 1024, 2048), (131072, 512, 1024),
             (8192, 2048, 2048)}
    return sorted(fused | other)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("rows,ci,co", _layers())
def test_fused_gate_follows_the_jax_plan(monkeypatch, rows, ci, co, dtype):
    """The port's SharedMLP routes a layer to the fused path exactly where
    the JAX package's plan does, at the layer's activation dtype."""
    monkeypatch.setenv("PVCNN_TPU_DENSE_BN_FUSED", "auto")
    x = torch.empty((rows, ci), device="meta")
    want = j_plan(rows, ci, co, jnp.dtype(dtype)) is not None
    assert shared_mlp._fused_rows(x, co, getattr(torch, dtype)) == want
    monkeypatch.setenv("PVCNN_TPU_DENSE_BN_FUSED", "0")
    assert not shared_mlp._fused_rows(x, co, getattr(torch, dtype))


def test_fused_gate_takes_the_step_layers():
    """Every layer of chip_smoke.py's fused tables is fused in both
    dtypes (the launches each bf16 and fp32 opt-in step counts), the cloud
    MLP's are not, and two layers fuse in bf16 only (one of them ShapeNet
    PointNet's 512 -> 2048 block, which the port's old shape-only gate
    fused in fp32 too)."""
    for rows, ci, co in _fused():
        for dt in (jnp.bfloat16, jnp.float32):
            assert j_plan(rows, ci, co, dt) is not None, (rows, ci, co, dt)
    assert j_plan(chip_smoke.B, 1024, 256, jnp.bfloat16) is None
    assert j_plan(4096, 1536, 1536, jnp.bfloat16) is not None
    assert j_plan(4096, 1536, 1536, jnp.float32) is None
    rows = chip_smoke.B * chip_smoke.N           # ShapeNet PointNet's block
    assert j_plan(rows, 512, 2048, jnp.bfloat16) is not None
    assert j_plan(rows, 512, 2048, jnp.float32) is None


def _tpu_plan(monkeypatch, ci, co, r, dtype):
    """conv3d_wgrad_plan as it plans on a TPU (no interpret mode)."""
    monkeypatch.setattr(j_conv_wgrad, "_interpret", lambda: False)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return j_conv_wgrad.conv3d_wgrad_plan(chip_smoke.B, r, r, r, ci, co, 3,
                                          dtype)


@pytest.mark.parametrize("ci,co,r", sorted(
    c for (k, c), _ in chip_smoke.CALLS3_ON.items()
    if k == "conv3d_ndhwc_wgrad"))
def test_ndhwc_wgrad_route(monkeypatch, ci, co, r):
    """JAX's route at each conv of the opt-in step, in bf16 and fp32: its
    Pallas kernel at R = 32 where the plan fits (bf16 both convs, fp32 the
    first), XLA's 27 products at R = 16; the port's K11 at every conv,
    its bf16 mode on K4's bf16 plan, which covers each conv's columns and
    chunks (the wrapper reaches the kernel: a non-CUDA tensor raises in
    it)."""
    bf16_plans = _tpu_plan(monkeypatch, ci, co, r, jnp.bfloat16) is not None
    fp32_plans = _tpu_plan(monkeypatch, ci, co, r, jnp.float32) is not None
    assert bf16_plans == (r == 32)
    assert fp32_plans == (r == 32 and ci == 9)
    plan = conv3d._wgrad_bf16_plan(chip_smoke.B, ci, co, r, 132)
    assert plan.chunks == chip_smoke.B * conv3d._bf16_tiles(r)
    assert -(-ci // 16) * 16 % plan.cols == 0
    x = torch.empty((chip_smoke.B, r, r, r, ci), dtype=torch.bfloat16,
                    device="meta")
    g = torch.empty((chip_smoke.B, r, r, r, co), dtype=torch.bfloat16,
                    device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        conv3d._ndhwc_wgrad_cuda(x, g, 3)
