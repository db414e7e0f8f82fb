"""The port's PointNet++ ops (furthest point sampling, ball query, three-NN,
grouping, gather, interpolation, take_rows and scatter_sum) against
pvcnn_tpu.ops on the same numpy-seeded inputs.

On the CPU the port runs each kernel's plain PyTorch version. The JAX side
runs both of its formulations: its CPU (XLA) one, and its Pallas kernels in
interpret mode (`interpret` cases, at shapes the Pallas branches take: rows
and columns multiples of 16).

Tolerances: the indices equal JAX's exactly (both compute d² in fp32 as
(dx² + dy²) + dz², each operation rounded on its own); the three-NN weights
within 1e-6 relative (XLA fuses the weight arithmetic, the port does not);
forwards and VJPs of the gathers (against jax.vjp, the same cotangents on
both sides) within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.ops.voxelize import _scatter_sum as j_scatter_sum
from pvcnn_tpu_torch import ops


@pytest.fixture(params=["xla", "interpret"])
def jax_formulation(request, monkeypatch):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET",
                       "1" if request.param == "interpret" else "0")
    return request.param


def _room(seed, b, n, dup=True):
    """[b, n, 3] S3DIS-like block coordinates: x, y in [0, 1], z in [0, 3];
    with dup, points 16-31 repeat points 32-47 (exact ties)."""
    pts = np.random.RandomState(seed).rand(b, n, 3) * [1.0, 1.0, 3.0]
    pts = pts.astype(np.float32)
    if dup and n >= 48:
        pts[:, 16:32] = pts[:, 32:48]
    return pts


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("b,n,m", [(2, 256, 64), (3, 128, 128), (2, 48, 16)])
def test_fps_indices(jax_formulation, b, n, m):
    x = _room(b * n + m, b, n)
    want = np.asarray(jops.furthest_point_sample_indices(jnp.asarray(x), m))
    got = ops.furthest_point_sample_indices(_t(x), m)
    assert got.dtype == torch.int32 and got.shape == (b, m)
    np.testing.assert_array_equal(got.numpy(), want)
    # every cloud's first pick is the seed; with M = N every point is taken
    assert (got[:, 0] == 0).all()
    if m == n:
        assert len(set(got[0].tolist()) | set(range(n))) == n


def test_fps_selects_in_fp32():
    """fp64 coordinates select as their fp32 rounding does (the TPU
    kernel's rule), and M > N repeats the seed once every point is taken."""
    x = _room(7, 2, 64).astype(np.float64) + 1e-9
    got = ops.furthest_point_sample_indices(_t(x), 80)
    want = ops.furthest_point_sample_indices(_t(x.astype(np.float32)), 80)
    assert torch.equal(got, want)
    assert (got[:, 64:] == 0).all()


def test_fps_indices_large_cloud(monkeypatch):
    """20,000 points (above the 16,384 that K6 once refused): the port's
    indices equal the JAX package's XLA FPS, its path for such clouds."""
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "0")
    x = _room(20000, 2, 20000)
    want = np.asarray(jops.furthest_point_sample_indices(jnp.asarray(x), 8))
    got = ops.furthest_point_sample_indices(_t(x), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def _fps_sizes():
    """chip_smoke.py's FPS cases (PVCNN2's four levels) and cloud sizes up
    to 100,000 points, on both sides of the plans' capacities."""
    import chip_smoke

    sizes = {c[0] for k, c in chip_smoke.CALLS2 if k == "fps"}
    return sorted(sizes | {1, 31, 33, 65, 257, 1023, 1025, 8193, 16384,
                           16385, 40000, 65537, 100000})


@pytest.mark.parametrize("n", _fps_sizes())
def test_fps_plan(n):
    """K6's plan for n points is a launch the kernel takes (pvcnn_fps'
    checks): a cluster of 1-8 blocks, whole warps, and registers that hold
    the cloud, or streaming (ppt = 0)."""
    from pvcnn_tpu_torch.ops import sampling

    cluster, threads, ppt = sampling._fps_plan(n)
    assert cluster in (1, 2, 4, 8)
    assert threads % 32 == 0 and threads <= (512 if ppt == 16 else 1024)
    assert ppt in (0, 1, 2, 4, 8, 16)
    if ppt:
        assert cluster * threads * ppt >= n
    else:
        assert n > 16384


@pytest.mark.parametrize("radius,u", [(0.1, 32), (0.25, 8), (0.6, 32)])
@pytest.mark.parametrize("m,n", [(64, 256), (32, 16)])
def test_ball_query(jax_formulation, m, n, radius, u):
    """The first U in-radius ids in index order, misses filled with the
    first hit (or 0 without one); u > n included."""
    x = _room(m + n, 2, n)
    c = _room(m + n + 1, 2, m, dup=False)
    c[:, :4] = x[:, 40 % n:40 % n + 4]            # centers on points
    c[:, 4] += 10.0                               # a center with no hit
    want = np.asarray(jops.ball_query(jnp.asarray(c), jnp.asarray(x), radius,
                                      u))
    got = ops.ball_query(_t(c), _t(x), radius, u)
    assert got.dtype == torch.int32 and got.shape == (2, m, u)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[:, 4] == 0).all()
    counts = (ops.neighbors.sq_dist(_t(c), _t(x))
              < np.float32(radius ** 2)).sum(-1)
    assert ((counts > 0) & (counts < u)).any()    # the fill path ran


def test_ball_query_radius_edge():
    """A point at exactly the fp32 radius is out (strict <), one ulp inside
    is in: r² is the fp32 rounding of float(radius) ** 2."""
    r = 0.3
    r2 = np.float32(r * r)
    inside = np.nextafter(r2, np.float32(0))
    pts = np.zeros((1, 3, 3), np.float32)
    pts[0, 1, 0] = np.sqrt(np.float64(r2))
    pts[0, 2, 0] = np.sqrt(np.float64(inside))
    d2 = ops.neighbors.sq_dist(_t(np.zeros((1, 1, 3), np.float32)),
                               _t(pts))[0, 0]
    got = ops.ball_query(_t(np.zeros((1, 1, 3), np.float32)), _t(pts), r, 3)
    want = [i for i in range(3) if d2[i] < torch.tensor(r2)]
    assert got[0, 0, :len(want)].tolist() == want
    want_j = np.asarray(jops.ball_query(jnp.zeros((1, 1, 3)),
                                        jnp.asarray(pts), r, 3))
    np.testing.assert_array_equal(got.numpy(), want_j)


@pytest.mark.parametrize("n,m", [(256, 64), (64, 16), (32, 2), (32, 1)])
def test_three_nn(jax_formulation, n, m):
    """Indices exactly, weights within 1e-6 relative; duplicated centers
    (ties to the lower index) and M < 3 (idx 0, d² = inf, weight from the
    1e10 clamp) included."""
    x = _room(n + m, 2, n)
    c = _room(n + m + 1, 2, m, dup=False)
    if m >= 16:
        c[:, 8:12] = c[:, 2:6]                    # tied centers
        x[:, :4] = c[:, 2:6]                      # queries on them
    jidx, jw = jops.three_nn(jnp.asarray(x), jnp.asarray(c))
    idx, w = ops.three_nn(_t(x), _t(c))
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jw)).max())
    if m < 3:
        assert (idx[..., m:] == 0).all()
        assert torch.isfinite(w).all()
    else:
        assert (idx[:, :4, 0] < idx[:, :4, 1]).all()


def test_three_nn_plain_returns_inf_for_missing_centers():
    x = _room(3, 1, 8)
    idx, d2 = ops.interpolate._three_nn_plain(_t(x), _t(x[:, :1]))
    assert torch.isinf(d2[..., 1:]).all() and (idx[..., 1:] == 0).all()


def _vjp_close(jfn, tfn, primal, cot, tol=1e-5):
    want, vjp = jax.vjp(jfn, jnp.asarray(primal))
    (want_g,) = vjp(jnp.asarray(cot))
    p = _t(primal).requires_grad_()
    got = tfn(p)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    (got_g,) = torch.autograd.grad(got, p, _t(cot))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=tol,
                               atol=tol)


def test_grouping_forward_and_vjp(jax_formulation):
    rng = np.random.RandomState(11)
    x = _room(12, 2, 128)
    c = x[:, ::4].copy()
    idx = ops.ball_query(_t(c), _t(x), 0.3, 16)
    feats = rng.randn(2, 128, 16).astype(np.float32)
    cot = rng.randn(2, 32, 16, 16).astype(np.float32)
    jidx = jnp.asarray(idx.numpy())
    with jax.default_matmul_precision("float32"):
        _vjp_close(lambda f: jops.grouping(f, jidx),
                   lambda f: ops.grouping(f, idx), feats, cot)


def test_gather_and_fps_centers_vjp(jax_formulation):
    rng = np.random.RandomState(12)
    x = _room(13, 2, 128)
    cot = rng.randn(2, 32, 3).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        _vjp_close(lambda p: jops.furthest_point_sample(p, 32),
                   lambda p: ops.furthest_point_sample(p, 32), x, cot)
        idx = ops.furthest_point_sample_indices(_t(x), 32)
        feats = rng.randn(2, 128, 24).astype(np.float32)
        _vjp_close(lambda f: jops.gather(f, jnp.asarray(idx.numpy())),
                   lambda f: ops.gather(f, idx), feats,
                   rng.randn(2, 32, 24).astype(np.float32))


@pytest.mark.parametrize("m", [64, 2])
def test_nearest_neighbor_interpolate_vjp(jax_formulation, m):
    rng = np.random.RandomState(14 + m)
    x = _room(15, 2, 256)
    c = x[:, :m].copy()
    feats = rng.randn(2, m, 32).astype(np.float32)
    cot = rng.randn(2, 256, 32).astype(np.float32)
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    with jax.default_matmul_precision("float32"):
        _vjp_close(lambda f: jops.nearest_neighbor_interpolate(jx, jc, f),
                   lambda f: ops.nearest_neighbor_interpolate(_t(x), _t(c),
                                                              f),
                   feats, cot)


@pytest.mark.parametrize("k,bins,c,skewed", [
    pytest.param(512, 64, 16, False, id="512-64-16"),
    pytest.param(96, 300, 5, False, id="96-300-5"),
    pytest.param(300, 200, 9, True, id="300-200-9-skewed")])
def test_scatter_sum(k, bins, c, skewed):
    """The take_rows backward's scatter against the JAX package's
    _scatter_sum (empty bins are 0, repeated ids sum); skewed: one bin holds
    every row, all others are empty."""
    rng = np.random.RandomState(k + bins)
    values = rng.randn(2, k, c).astype(np.float32)
    idx = rng.randint(0, bins // 2, (2, k)).astype(np.int32)
    if skewed:
        idx[:] = [[7], [bins // 2 - 1]]
    with jax.default_matmul_precision("float32"):
        want = np.asarray(j_scatter_sum(jnp.asarray(values), jnp.asarray(idx),
                                        bins))
    got = ops.scatter_sum(_t(values), _t(idx), bins)
    assert got.shape == (2, bins, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got[:, bins // 2:] == 0).all()
    if skewed:
        assert ((got != 0).any(-1).sum(-1) == 1).all()


def test_take_rows_backward_is_scatter_sum():
    rng = np.random.RandomState(3)
    table = _t(rng.randn(2, 40, 8).astype(np.float32)).requires_grad_()
    idx = _t(rng.randint(0, 40, (2, 100)).astype(np.int32))
    g = _t(rng.randn(2, 100, 8).astype(np.float32))
    (got,) = torch.autograd.grad(ops.take_rows(table, idx), table, g)
    assert torch.equal(got, ops.scatter_sum(g, idx, 40))
