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
    # a dense cluster: every center has every point within the radius, so
    # the scan stops at the U-th hit (all n where u > n)
    xd, cd = _cluster(m + n, 2, n, m, radius)
    want = np.asarray(jops.ball_query(jnp.asarray(cd), jnp.asarray(xd),
                                      radius, u))
    got = ops.ball_query(_t(cd), _t(xd), radius, u)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[..., :min(u, n)].numpy() == np.arange(min(u, n))).all()


def _cluster(seed, b, n, m, radius):
    """[b, n, 3] points and [b, m, 3] centers within radius / 4 of one
    point: every center has every point within the radius."""
    rng = np.random.RandomState(seed)
    pts = 0.5 + rng.rand(b, n, 3) * (radius / 8)
    ctr = 0.5 + rng.rand(b, m, 3) * (radius / 8)
    return pts.astype(np.float32), ctr.astype(np.float32)


def _bq_sizes():
    """chip_smoke.py's ball-query cases (PVCNN2's four levels) and cloud
    sizes up to 100,000 points, about the tiles and the splits."""
    import chip_smoke

    cases = {(c[0], c[1], c[3]) for (k, c) in chip_smoke.CALLS2
             if k == "ball_query"}
    more = {(m, n, u) for m in (1, 100, 1024)
            for u in (1, 64, 256, 512, 1751, 4096)
            for n in (1, 255, 256, 257, 1023, 1025, 2049, 8193, 20000,
                      65537, 100000)}
    return sorted(cases | more)


@pytest.mark.parametrize("m,n,u", _bq_sizes())
def test_ball_query_plan(m, n, u):
    """K7's plan for 32 clouds on a card of 132 SMs is a launch the kernel
    takes (pvcnn_ball_query's checks): whole warps of centers, at most 256
    a block and as many as a block's shared memory holds within the card's
    227 KB (2 tiles of 256 float4 points, then U + 2 ints a center; where
    not even 32 centers fit, above U = 1,750, the hits go to device memory
    and a block holds 256 centers' counts), splits of whole 256-point tiles
    that cover the N points once with none empty; it splits only where the
    centers fill under 12 warps an SM, into runs of at least one tile."""
    from pvcnn_tpu_torch.ops import neighbors

    plan = neighbors._ball_query_plan(32, m, n, u, 132)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    smem = lambda threads: 2 * 256 * 16 + 4 * threads * (u + 2)
    assert plan.device_hits == (smem(32) > 227 * 1024) == (u > 1750)
    if plan.device_hits:
        assert 2 * 256 * 16 + 4 * plan.threads <= 227 * 1024
        assert plan.threads == min(256, 32 * -(-m // 32))
    else:
        assert smem(plan.threads) <= 227 * 1024
        assert (plan.threads >= min(256, m)
                or smem(plan.threads + 32) > 227 * 1024)
    assert plan.per_split % 256 == 0 and plan.splits >= 1
    starts = np.arange(plan.splits) * plan.per_split
    ends = np.minimum(starts + plan.per_split, n)
    assert starts[0] == 0 and ends[-1] == n
    assert (ends > starts).all() or n == 0
    assert (starts[1:] == ends[:-1]).all()
    warps = 32 * -(-m // plan.threads) * plan.threads // 32
    if plan.splits > 1:
        assert warps < 12 * 132 and plan.per_split >= 256
        assert plan.scratch_ints(32, m, u) == plan.splits * 32 * m * (u + 1)
    else:
        assert plan.scratch_ints(32, m, u) == 0


def test_ball_query_plan_most_neighbors():
    """U = 1,750 hits a center still fit a block of 32 centers in shared
    memory, and keep that plan; from U = 1,751 they do not, and the plan
    takes the device-memory path (the hits in the output rows or the
    splits' rows, 256 centers a block) instead of refusing."""
    from pvcnn_tpu_torch.ops import neighbors

    plan = neighbors._ball_query_plan(1, 5, 100, 1750, 132)
    assert plan == neighbors.BallQueryPlan(32, 1, 256, False)
    assert neighbors._ball_query_plan(32, 1024, 8192, 1750, 132) == \
        neighbors.BallQueryPlan(32, 2, 4096, False)
    for u in (1751, 2048, 4096):
        assert neighbors._ball_query_plan(1, 5, 100, u, 132) == \
            neighbors.BallQueryPlan(32, 1, 256, True)
        plan = neighbors._ball_query_plan(32, 1024, 8192, u, 132)
        assert plan.device_hits and plan.threads == 256
        assert plan.scratch_ints(32, 1024, u) == \
            plan.splits * 32 * 1024 * (u + 1)
    # PVCNN2's four calls keep their shared-memory plans
    for (m, n) in ((1024, 8192), (256, 1024), (64, 256), (16, 64)):
        assert not neighbors._ball_query_plan(32, m, n, 32, 132).device_hits


def _ball_query_splits(ctr, pts, r2, u, per_split):
    """K7's split and merge in numpy: each run of per_split points keeps its
    count and its first U hits; slot s takes the hit of the split whose
    counts, in split order, cover it, else the first hit, else 0."""
    b, m, _ = ctr.shape
    n = pts.shape[1]
    d = pts[:, None, :, :] - ctr[:, :, None, :]
    hit = ((d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
           + d[..., 2] * d[..., 2]) < r2
    parts = []
    for lo in range(0, max(n, 1), per_split):
        part = hit[..., lo:lo + per_split]
        ids = [[lo + np.flatnonzero(part[i, j])[:u] for j in range(m)]
               for i in range(b)]
        parts.append((part.sum(-1), ids))
    out = np.zeros((b, m, u), np.int32)
    for i in range(b):
        for j in range(m):
            taken = [h for _, ids in parts for h in ids[i][j]][:u]
            first = taken[0] if taken else 0
            out[i, j] = taken + [first] * (u - len(taken))
    return out


@pytest.mark.parametrize("per_split", [256, 512])
@pytest.mark.parametrize("cloud", ["random", "cluster"])
@pytest.mark.parametrize("u", [1, 8, 32, 64])
def test_ball_query_split_merge(cloud, u, per_split):
    """K7's split-and-merge (in numpy) equals `_ball_query_plain` on random
    clouds (centers with and without hits) and on a dense cluster where
    every center has at least U hits, with N = 1,000 not a multiple of the
    split."""
    from pvcnn_tpu_torch.ops import neighbors

    n, m, radius = 1000, 24, 0.15
    if cloud == "random":
        x = _room(u + per_split, 2, n)
        c = _room(u + per_split + 1, 2, m, dup=False)
        c[:, 4] += 10.0                            # no hit
    else:
        x, c = _cluster(u + per_split, 2, n, m, radius)
    r2 = neighbors._fp32(radius ** 2)
    want = neighbors._ball_query_plain(_t(c), _t(x), r2, u).numpy()
    got = _ball_query_splits(c, x, np.float32(r2), u, per_split)
    np.testing.assert_array_equal(got, want)
    hits = (neighbors.sq_dist(_t(c), _t(x)) < r2).sum(-1)
    if cloud == "cluster":
        assert (hits >= u).all()
    else:
        assert (hits < u).any() and (hits >= 1).any()


@pytest.mark.parametrize("per_split", [1024, 2560])
@pytest.mark.parametrize("cloud", ["random", "cluster"])
def test_ball_query_split_merge_many_neighbors(cloud, per_split):
    """K7's split-and-merge (in numpy) at U = 2,048, the device-memory
    path's, equals `_ball_query_plain`: N = 5,000 points, so that a dense
    cluster's centers reach their U-th hit in the second or third split
    and random clouds take the fill."""
    from pvcnn_tpu_torch.ops import neighbors

    n, m, u = 5000, 6, 2048
    if cloud == "random":
        x = _room(per_split, 2, n)
        c = _room(per_split + 1, 2, m, dup=False)
        c[:, 4] += 10.0                            # no hit
        radius = 0.5
    else:
        radius = 0.15
        x, c = _cluster(per_split, 2, n, m, radius)
    r2 = neighbors._fp32(radius ** 2)
    want = neighbors._ball_query_plain(_t(c), _t(x), r2, u).numpy()
    got = _ball_query_splits(c, x, np.float32(r2), u, per_split)
    np.testing.assert_array_equal(got, want)
    hits = (neighbors.sq_dist(_t(c), _t(x)) < r2).sum(-1)
    if cloud == "cluster":
        assert (hits >= u).all()
    else:
        assert (hits < u).all() and (hits >= 1).any() and (hits == 0).any()


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


_NN_EDGES = (1, 2, 3, 31, 32, 33, 255, 257, 1025, 8193, 20000)


def _nn_sizes():
    """chip_smoke.py's three-NN cases (PVCNN2's four levels, then the
    PointNet++ paths' feature propagation: ShapeNet PointNet2 and Frustum
    PointNet2), and every pair of the edge sizes."""
    import chip_smoke

    cases = {c for (k, c) in chip_smoke.CALLS2 if k == "three_nn"}
    cases |= set(chip_smoke.NN_MORE)
    return sorted(cases | {(n, m) for n in _NN_EDGES for m in _NN_EDGES})


@pytest.mark.parametrize("n,m", _nn_sizes())
def test_three_nn_plan(n, m):
    """K8's plan for 32 clouds on a card of 132 SMs is a launch the kernel
    takes (pvcnn_three_nn's checks): 1 to 8 runs of centers that cover the
    M centers once, in order, none empty, threads a block in `runs` groups
    of whole warps, at most 256, and the shared memory (the ring, 2 x 512
    float4 centers, reused for the runs' best threes) within 48 KB; it
    splits the centers only where one query a thread fills under 12 warps
    an SM, into runs of at least 16. Runs and threads are powers of two
    (the kernel divides by shifts); runs of 256 centers or more scan into
    hit masks."""
    from pvcnn_tpu_torch.ops import interpolate

    plan = interpolate._three_nn_plan(32, n, m, 132)
    assert plan.runs in (1, 2, 4, 8)
    assert plan.threads in (32, 64, 128, 256)
    assert plan.threads >= 32 * plan.runs
    starts = np.arange(plan.runs) * plan.per_run
    ends = np.minimum(starts + plan.per_run, m)
    assert plan.per_run >= 1 and starts[0] == 0 and ends[-1] == m
    assert (ends > starts).all() or m == 0
    assert (starts[1:] == ends[:-1]).all()
    group = plan.threads // plan.runs
    merge = (plan.runs - 1) * 3 * group * 8
    assert max(2 * 512 * 16, merge) <= 48 * 1024
    want = 12 * 32 * 132
    if plan.runs > 1:
        assert 32 * n * plan.runs // 2 < want
        assert plan.per_run >= 16
    assert plan.hit_masks == (plan.per_run >= 256)


def _three_nn_runs(x, c, per_run):
    """K8's runs and merge in numpy: each run of per_run centers keeps the
    best three of an in-order scan with a strict `<` (so a tie keeps the
    lower index); the runs' best threes are then inserted, run by run, in
    the same way into the first run's. -> (idx [B, N, 3] int32, d² [B, N,
    3] float32)."""
    b, n, _ = x.shape
    m = c.shape[1]
    d = x[:, :, None, :] - c[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]

    def insert(best, dist, i):
        for slot in range(3):
            if dist < best[slot][0]:
                best.insert(slot, (dist, i))
                del best[3]
                return

    idx = np.zeros((b, n, 3), np.int32)
    val = np.full((b, n, 3), np.inf, np.float32)
    for i in range(b):
        for q in range(n):
            runs = []
            for lo in range(0, max(m, 1), per_run):
                best = [(np.float32(np.inf), 0)] * 3
                for j in range(lo, min(lo + per_run, m)):
                    insert(best, d2[i, q, j], j)
                runs.append(best)
            merged = list(runs[0])
            for best in runs[1:]:
                for dist, j in best:
                    insert(merged, dist, j)
            idx[i, q] = [j for _, j in merged]
            val[i, q] = [dist for dist, _ in merged]
    return idx, val


@pytest.mark.parametrize("m,per_run", [(1, 1), (2, 1), (2, 2), (3, 2),
                                       (40, 16), (64, 16), (100, 13),
                                       (128, 32), (37, 37)])
@pytest.mark.parametrize("cloud", ["random", "ties"])
def test_three_nn_split_merge(jax_formulation, cloud, m, per_run):
    """K8's runs and merge (in numpy) equal `_three_nn_plain` (indices and
    d² exactly) and the JAX `three_nn` (indices exactly, weights within
    1e-6 relative): random clouds, M < 3, M not a multiple of the run, and
    duplicated centers whose ties straddle a run boundary, with queries on
    them."""
    from pvcnn_tpu_torch.ops import interpolate

    n = 48
    x = _room(m * 7 + per_run, 2, n, dup=False)
    c = _room(m * 7 + per_run + 1, 2, m, dup=False)
    if cloud == "ties" and m >= 4:
        at = min(per_run, m - 2)                  # a run boundary, or inside
        c[:, at + 1] = c[:, at - 1]               # equal d² for every query
        c[:, at] = c[:, 0]
        x[:, :3] = c[:, [0, at - 1, at]]          # queries on tied centers
        x[:, 3:6] = (c[:, [0, at - 1, 1]] + c[:, [at, at + 1, 2]]) / 2
    idx, d2 = _three_nn_runs(x, c, per_run)
    want_idx, want_d2 = interpolate._three_nn_plain(_t(x), _t(c))
    np.testing.assert_array_equal(idx, want_idx.numpy())
    np.testing.assert_array_equal(d2, want_d2.numpy())
    jidx, jw = jops.three_nn(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    w = interpolate._weights_from_d2(_t(d2)).numpy()
    np.testing.assert_allclose(w, np.asarray(jw), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(jw)).max())
    if m < 3:
        assert (idx[..., m:] == 0).all() and np.isinf(d2[..., m:]).all()
    if cloud == "ties" and m >= 4:
        # a query on center 0 ties with its copy `at`: the lower index first
        assert (idx[:, 0, :2] == [0, at]).all()


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
