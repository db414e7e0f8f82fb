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
from pvcnn_tpu.ops.devoxelize import _corners as j_corners
from pvcnn_tpu.ops.pallas.conv_rows import conv3d_rows_act as j_conv_act
from pvcnn_tpu.ops.pallas.conv_rows import conv_rows_supported
from pvcnn_tpu_torch import ops
from pvcnn_tpu_torch.ops import devoxelize


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


def _edge_coords(rng, b, n, r):
    """[b, n, 3] float32 in [0, R-1] with exact-integer points and points on
    the R-1 plane of each axis and of all three."""
    norm = rng.uniform(0, r - 1, (b, n, 3)).astype(np.float32)
    norm[:, :16] = np.floor(norm[:, :16])
    for axis in range(3):
        norm[:, 16 + 8 * axis:24 + 8 * axis, axis] = r - 1
    norm[:, 40:48] = r - 1
    return norm


@pytest.mark.parametrize("impl", ["jax", "torch"])
@pytest.mark.parametrize("r", [8, 16, 32])
def test_corners_off_the_base_walk_weigh_zero(impl, r):
    """What K5's base-bin walk (and the TPU's sorted scatter) relies on:
    corner k of a point lies at base + bx R^2 + by R + bz (k's bits), or its
    weight is exactly 0 (a collapsed corner: exact integers, the R-1
    plane)."""
    norm = _edge_coords(np.random.RandomState(r), 2, 256, r)
    if impl == "jax":
        idx8, w8 = (np.asarray(a) for a in j_corners(jnp.asarray(norm), r))
    else:
        idx8, w8 = (t.numpy() for t in devoxelize._corners(
            torch.from_numpy(norm), r))
    offsets = np.array([bx * r * r + by * r + bz for bx in (0, 1)
                        for by in (0, 1) for bz in (0, 1)])
    stray = idx8 != idx8[..., :1] + offsets
    assert stray[:, :48].any(axis=-1).all()   # every edge point collapses
    np.testing.assert_array_equal(w8[stray], 0.0)
    assert ((idx8 >= 0) & (idx8 < r ** 3)).all()


@pytest.mark.parametrize("r", [8, 16])
def test_sort_points_plain(r):
    """K5's glue in plain torch (the sort kernel's oracle on the card)
    against numpy: points in stable base-bin order with their indices, and
    each bin's run bounds."""
    rng = np.random.RandomState(5 + r)
    norm = _edge_coords(rng, 2, 300, r)
    norm[1, 100:200] = norm[1, 100]           # one long run
    points, bounds = devoxelize._sort_points_plain(torch.from_numpy(norm), r)
    lo = np.clip(np.floor(norm).astype(np.int64), 0, r - 1)
    base = (lo[..., 0] * r + lo[..., 1]) * r + lo[..., 2]
    for b in range(2):
        order = np.argsort(base[b], kind="stable")
        np.testing.assert_array_equal(
            points.view(torch.int32)[b, :, 3].numpy(), order)
        np.testing.assert_array_equal(points[b, :, :3].numpy(), norm[b, order])
        want = np.concatenate([[0], np.cumsum(np.bincount(
            base[b], minlength=r ** 3))])
        np.testing.assert_array_equal(bounds[b].numpy(), want)


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


@pytest.mark.parametrize("b,ci,co,r,want", [
    (32, 32, 32, 32, (2, 1)),      # Co <= 32: the 32 x 256 tile
    (32, 9, 32, 32, (2, 1)),
    (32, 64, 33, 32, (4, 1)),
    (32, 64, 64, 16, (4, 1)),      # 1024 blocks: 2.6 waves, not split
    (32, 128, 128, 8, (4, 3)),     # 256 blocks: 3 splits, 2 full waves
    (32, 256, 256, 8, (4, 3)),     # 512 blocks: 4 waves of 1536
    (2, 6, 16, 8, (2, 8)),         # 4 blocks: the most splits
    (1, 6, 64, 2, (4, 8)),         # 11 slices: 8 splits of 2 or fewer
])
def test_conv3d_fwd_plan(b, ci, co, r, want):
    """K3's tile and split of the reduction on a card of 132 SMs."""
    from pvcnn_tpu_torch.ops import conv3d

    assert conv3d._fwd_plan(b, ci, co, r, 132) == want


def _k4_cases():
    """K4's (B, Ci, Co, R) on the three default training paths
    (chip_smoke.py's CALLS, CALLS2, CALLS3, B = 32) and a few edges: one
    voxel, R = 5 (zero-filled segment ends), R = 40 (two segments per
    z-row), one input channel, Co = 33 and 130."""
    import chip_smoke

    cases = {(chip_smoke.B,) + c[:3]
             for calls in (chip_smoke.CALLS, chip_smoke.CALLS2,
                           chip_smoke.CALLS3)
             for (k, c), n in calls.items() if k == "conv3d_wgrad" and n}
    return sorted(cases) + [(1, 1, 1, 1), (3, 9, 33, 5), (2, 257, 130, 40),
                            (3, 6, 16, 8), (1, 1, 64, 16)]


@pytest.mark.parametrize("b,ci,co,r", _k4_cases())
def test_wgrad_plan_covers_voxels_once(b, ci, co, r):
    """K4's plan on a card of 132 SMs: the splits' runs of slices, walked
    segment by segment as the kernel's cursors walk them (a segment's
    cloud, x, y and z from its flat index), cover each of the B * R^3
    voxels exactly once, and no run is empty."""
    from pvcnn_tpu_torch.ops import conv3d

    plan = conv3d._wgrad_plan(b, ci, co, r, 132)
    seg, per = plan.seg, plan.per_split
    zsegs = -(-r // seg)
    total = b * r * r * zsegs
    counts = np.zeros(b * r ** 3, dtype=np.int64)
    for split in range(plan.splits):
        lo, hi = split * per, min(plan.slices, (split + 1) * per)
        assert hi > lo
        gs = np.arange(lo * 32 // seg, hi * 32 // seg)
        gs = gs[gs < total]
        zs, rest = gs % zsegs, gs // zsegs
        y, rest = rest % r, rest // r
        x, cloud = rest % r, rest // r
        z = zs[:, None] * seg + np.arange(seg)[None]
        flat = ((cloud[:, None] * r + x[:, None]) * r + y[:, None]) * r + z
        np.add.at(counts, flat[z < r], 1)
    assert (counts == 1).all()
    assert plan.slices == -(-total * seg // 32)


@pytest.mark.parametrize("b,ci,co,r", _k4_cases())
def test_wgrad_plan_bounds(b, ci, co, r):
    """K4's plan keeps its promises: the 32-column tile exactly where
    Co <= 32; at most 192 threads; row tiles of cb channels that cover Ci
    without an empty tile; splits within two waves of resident blocks and
    runs of at least 8 slices (or one split); the partial buffer
    [splits, Co, Ci, 27] only where it splits, and under 28 MiB at the
    three default paths' cases."""
    from pvcnn_tpu_torch.ops import conv3d

    plan = conv3d._wgrad_plan(b, ci, co, r, 132)
    assert plan.cols == (32 if co <= 32 else 64)
    assert plan.tile == f"{27 * plan.cb}x{plan.cols}"
    assert 3 * plan.cb * plan.cols // 8 <= 192
    row_tiles = -(-ci // plan.cb)
    assert (row_tiles - 1) * plan.cb < ci <= row_tiles * plan.cb
    assert plan.tiles == row_tiles * -(-co // plan.cols)
    assert plan.seg == (8 if r <= 8 else 16 if r <= 16 else 32)
    warps = -(-3 * plan.cb * plan.cols // 8 // 32)
    slots = max(1, 12 // warps) * 132
    if plan.splits > 1:
        assert plan.tiles * plan.splits <= 2 * slots
        assert plan.per_split >= 8
        assert plan.partial_bytes == 4 * plan.splits * 27 * ci * co
    else:
        assert plan.partial_bytes == 0
    if b == 32:
        assert plan.partial_bytes < 28 * 2 ** 20


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
