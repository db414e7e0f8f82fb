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
The gradients (VJPs against jax.vjp of the JAX op, the same cotangents on
both sides) keep those tolerances; a conv gradient is a sum over every
cloud and voxel, so its absolute tolerance is 1e-4 of the gradient's
largest entry (measured: at most 2e-7 of it).
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
    got, s1, s2 = ops.conv3d_rows_act(
        torch.from_numpy(x), weight, torch.from_numpy(bias),
        torch.from_numpy(scale), torch.from_numpy(shift), r, has_prologue)
    assert got.shape == (b, co, r ** 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert not s1.any() and not s2.any()       # no statistics asked for


def _grad_close(got, want, rtol):
    want = np.asarray(want)
    got = np.zeros_like(want) if got is None else got.detach().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("c,r", [(6, 8), (16, 16)])
def test_scatter_mean_vjp(c, r, channels_first):
    """d features of the scatter-mean: each point gets its bin's cotangent
    over the bin's count (empty bins and shared bins both occur)."""
    rng = np.random.RandomState(7 * r + c)
    b, n = 2, 512
    feats = rng.randn(b, n, c).astype(np.float32)
    vox, _ = jops.normalize_coords(jnp.asarray(_coords(rng, b, n)), r,
                                   normalize=False)
    vox = np.array(vox)
    g = rng.randn(b, r, r, r, c).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(lambda f: jops.avg_voxelize(f, jnp.asarray(vox), r),
                         jnp.asarray(feats))
        (want,) = vjp(jnp.asarray(g))
    tf = torch.from_numpy(feats).requires_grad_()
    flat = ops.flat_voxel_index(torch.from_numpy(vox), r)
    out = ops.scatter_mean(tf, flat, r ** 3, channels_first=channels_first)
    tg = torch.from_numpy(g).reshape(b, r ** 3, c)
    if channels_first:
        tg = tg.transpose(1, 2)
    (got,) = torch.autograd.grad(out, tf, tg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("r", [8, 16])
def test_devoxelize_vjp(r, channels_first):
    """d grid of the trilinear gather, collapsed corners and the last plane
    included; no gradient reaches the coordinates."""
    rng = np.random.RandomState(11 * r)
    b, n, c = 2, 512, 16
    grid = rng.randn(b, r, r, r, c).astype(np.float32)
    _, norm = jops.normalize_coords(jnp.asarray(_coords(rng, b, n)), r,
                                    normalize=True)
    norm = np.asarray(norm).copy()
    norm[:, :8] = np.floor(norm[:, :8])
    norm[:, 8:12, 0] = r - 1
    g = rng.randn(b, n, c).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        _, vjp = jax.vjp(lambda gr: jops.trilinear_devoxelize(
            gr, jnp.asarray(norm), r), jnp.asarray(grid))
        (want,) = vjp(jnp.asarray(g))
    rows = torch.from_numpy(grid).reshape(b, r ** 3, c)
    if channels_first:
        rows = rows.transpose(1, 2).contiguous()
    rows.requires_grad_()
    tn = torch.from_numpy(norm).requires_grad_()
    out = ops.devoxelize_rows(rows, tn, r, channels_first=channels_first)
    got, got_norm = torch.autograd.grad(out, (rows, tn), torch.from_numpy(g),
                                        allow_unused=True)
    assert got_norm is None
    if channels_first:
        got = got.transpose(1, 2)
    np.testing.assert_allclose(got.reshape(b, r, r, r, c).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ci,co,has_prologue,want_stats", [
    (6, 16, False, True),        # conv0 of a block: raw input, statistics
    (16, 16, True, True),        # conv1: prologue and statistics
    (16, 16, True, False),
    (16, 8, False, False),
])
def test_conv3d_rows_act_vjp(ci, co, has_prologue, want_stats):
    """dx, dW, dbias, dscale, dshift of the fused conv against jax.vjp with
    nonzero cotangents on y, s1 and s2 (R = 16: the JAX side runs its
    Pallas dgrad and wgrad kernels in interpret mode). The weights are
    asymmetric, so a wrong tap flip or channel swap in the dgrad shows."""
    r, b = 16, 2
    rng = np.random.RandomState(100 * ci + co + 2 * has_prologue + want_stats)
    x = rng.randn(b, ci, r ** 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, ci).astype(np.float32)
    shift = rng.randn(ci).astype(np.float32)
    gy = rng.randn(b, co, r ** 3).astype(np.float32)
    gs1 = (0.1 * rng.randn(co)).astype(np.float32)
    gs2 = (0.01 * rng.randn(co)).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        (jy, js1, js2), vjp = jax.vjp(
            lambda *a: j_conv_act(*a, r, has_prologue, want_stats),
            *map(jnp.asarray, (x, w, bias, scale, shift)))
        want = vjp(tuple(map(jnp.asarray, (gy, gs1, gs2))))
    args = [torch.from_numpy(a).requires_grad_() for a in (
        x, np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)), bias, scale,
        shift)]
    y, s1, s2 = ops.conv3d_rows_act(*args, r, has_prologue, want_stats)
    _grad_close(y, jy, 1e-4)
    if want_stats:
        _grad_close(s1, js1, 1e-4)
        _grad_close(s2, js2, 1e-4)
    got = torch.autograd.grad(
        (y, s1, s2), args, tuple(map(torch.from_numpy, (gy, gs1, gs2))),
        allow_unused=True)
    want = list(want)
    want[1] = np.asarray(want[1]).transpose(4, 3, 0, 1, 2)
    for name, g_got, g_want in zip(("dx", "dW", "dbias", "dscale", "dshift"),
                                   got, want):
        _grad_close(g_got, g_want, 1e-4)
