"""The port's point-voxel ops (pvcnn_tpu_torch/ops) against pvcnn_tpu.ops on
the same numpy-seeded inputs.

On the CPU the port runs each kernel's plain PyTorch version. The JAX side
runs its Pallas kernels in interpret mode (opted into per module, as
tests/test_conv_rows.py does), at shapes that take the Pallas branches:
avg_voxelize's one-hot slot scatter (bins % 128 == 0), the sorted devoxelize
gather (R^3 >= 4096) and the flat-rows conv (R^2 % 128 == 0). fp32 matmul
precision keeps the interpret-mode one-hot products exact.

Tolerances: 1e-5 for voxelize/devoxelize (sums of a few fp32 terms in
another order), 1e-4 for the conv (27 * Ci-term sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.ops.pallas.conv_rows import conv3d_rows_act as j_conv_act
from pvcnn_tpu.ops.pallas.conv_rows import conv_rows_supported
from pvcnn_tpu_torch import ops


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "1")


def _coords(rng, b, n):
    pts = rng.randn(b, n, 3).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=-1, keepdims=True).max() * 0.9


@pytest.mark.parametrize("normalize,eps", [(True, 0.0), (False, 0.0),
                                           (True, 1e-3)])
@pytest.mark.parametrize("r", [8, 16])
def test_normalize_coords(normalize, eps, r):
    coords = _coords(np.random.RandomState(r), 2, 300)
    jv, jn = jops.normalize_coords(jnp.asarray(coords), r,
                                   normalize=normalize, eps=eps)
    tv, tn = ops.normalize_coords(torch.from_numpy(coords), r,
                                  normalize=normalize, eps=eps)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5,
                               atol=1e-5)
    assert tv.dtype == torch.int32
    # a rounding tie may fall either side of a 1-ulp difference in norm
    assert (np.abs(tv.numpy() - np.asarray(jv)) <= 1).all()
    assert (tv.numpy() != np.asarray(jv)).mean() < 1e-3


@pytest.mark.parametrize("c", [6, 16])
@pytest.mark.parametrize("r", [8, 16])
def test_avg_voxelize(r, c):
    rng = np.random.RandomState(100 * r + c)
    b, n = 2, 512
    feats = rng.randn(b, n, c).astype(np.float32)
    vox, _ = jops.normalize_coords(jnp.asarray(_coords(rng, b, n)), r,
                                   normalize=False)
    vox = np.array(vox)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jops.avg_voxelize(jnp.asarray(feats),
                                            jnp.asarray(vox), r))
    got = ops.avg_voxelize(torch.from_numpy(feats), torch.from_numpy(vox), r)
    assert got.shape == (b, r, r, r, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the channel-major layout the conv consumes is the same grid
    flat = ops.flat_voxel_index(torch.from_numpy(vox), r)
    rows = ops.scatter_mean(torch.from_numpy(feats), flat, r ** 3,
                            channels_first=True)
    np.testing.assert_array_equal(
        rows.numpy(), got.reshape(b, r ** 3, c).transpose(1, 2).numpy())


@pytest.mark.parametrize("r", [8, 16])
def test_trilinear_devoxelize(r):
    rng = np.random.RandomState(r)
    b, n, c = 2, 512, 16
    grid = rng.randn(b, r, r, r, c).astype(np.float32)
    _, norm = jops.normalize_coords(jnp.asarray(_coords(rng, b, n)), r,
                                    normalize=True)
    norm = np.asarray(norm).copy()
    norm[:, :8] = np.floor(norm[:, :8])   # exact grid hits: collapsed corners
    norm[:, 8:12, 0] = r - 1              # the last x plane
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jops.trilinear_devoxelize(
            jnp.asarray(grid), jnp.asarray(norm), r))
    got = ops.trilinear_devoxelize(torch.from_numpy(grid),
                                   torch.from_numpy(norm), r)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the channel-major grid of the PVConv branch gives the same result
    rows = torch.from_numpy(grid).reshape(b, r ** 3, c).transpose(1, 2)
    got_cm = ops.devoxelize_rows(rows.contiguous(), torch.from_numpy(norm), r,
                                 channels_first=True)
    np.testing.assert_allclose(got_cm.numpy(), got.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_corner_base_bins_is_first_corner():
    rng = np.random.RandomState(3)
    norm = torch.from_numpy(rng.uniform(0, 7, (2, 64, 3)).astype(np.float32))
    want = np.asarray(jops.corner_base_bins(jnp.asarray(norm.numpy()), 8))
    np.testing.assert_array_equal(ops.corner_base_bins(norm, 8).numpy(), want)


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("ci,co", [(6, 16), (16, 16)])
def test_conv3d_rows_act(ci, co, has_prologue):
    r, b, k = 16, 2, 3
    assert conv_rows_supported(b, r, ci, co, k, jnp.float32)
    rng = np.random.RandomState(ci * co + has_prologue)
    x = rng.randn(b, ci, r ** 3).astype(np.float32)
    w = (rng.randn(k, k, k, ci, co) * 0.1).astype(np.float32)   # JAX layout
    bias = rng.randn(co).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, ci).astype(np.float32)
    shift = rng.randn(ci).astype(np.float32)
    want, _, _ = j_conv_act(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                            jnp.asarray(scale), jnp.asarray(shift), r,
                            has_prologue, False)
    weight = torch.from_numpy(np.ascontiguousarray(
        w.transpose(4, 3, 0, 1, 2)))                            # torch layout
    got = ops.conv3d_rows_act(torch.from_numpy(x), weight,
                              torch.from_numpy(bias), torch.from_numpy(scale),
                              torch.from_numpy(shift), r, has_prologue)
    assert got.shape == (b, co, r ** 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
