"""The port's PointNet++ ops and modules on bf16 features against the JAX
package in bf16: the row gathers (take_rows, grouping, the FPS gather, the
three-NN interpolation) forward and VJP, K1's bf16 sum mode (their
backward), Dense2d / SharedMLP(dim=2), and the set-abstraction,
group-all and feature-propagation modules.

The ops run JAX with PVCNN_TPU_PALLAS_INTERPRET=1, so that the take_rows
backward's `_scatter_sum` runs the Pallas one-hot kernel (f32 sums of the
bf16 values, pvcnn_tpu/ops/pallas/scatter.py) at fp32 matmul precision;
the tables hold a multiple of 128 rows, which that kernel takes. A gather
of bf16 rows is exact on both sides. The port's plain bf16 sum (f32 sums,
rounded once) is held within one bf16 rounding of JAX's f32 sums: 2^-8 of
each sum plus 1e-6 of its sum of |terms| (the f32 sums' order). Where both
sides round (the VJPs), a rounded sum may land one bf16 ulp apart: 2^-7
of each element plus the same order term.

The modules (JAX on its CPU formulations) are held to JAX bf16 and fp32
by tests/test_torch_bf16_model.py's rule (`own` is JAX bf16's rel-L2 distance from JAX fp32): the port within
[own / 2, 2 own + 1e-3] of JAX fp32 and within sqrt(2) own + 1e-3 of JAX
bf16. The inputs are float32, as a model hands them: the concatenation of
the float32 relative coordinates (or skip features) with bf16 features is
float32 on both sides, and the next Dense rounds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import nn as jnn
from pvcnn_tpu import ops as jops
from pvcnn_tpu.ops.pallas.scatter import pallas_scatter_supported
from pvcnn_tpu.ops.voxelize import _scatter_sum as j_scatter_sum
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch import nn as tnn
from pvcnn_tpu_torch import ops
from pvcnn_tpu_torch.ops import gather_utils, voxelize
from test_torch_bf16_model import _within_rule
from test_torch_modules import _flat, _move
from test_torch_pointnet_modules import _features
from test_torch_pointnet_ops import _room, _t

BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads (tests/test_torch_cli.py: six workers' full thread
    pools oversubscribe the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch, request):
    """The ops' JAX side in interpret mode; the modules' (named *_module_*)
    on its CPU formulations, whose eager Pallas interpretation would take
    most of this file's time."""
    module = "_module_" in request.node.name
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "0" if module else "1")


def _bf16(a):
    """numpy f32 -> (the values rounded to bf16 as numpy f32, a torch bf16
    tensor, a jax bf16 array)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(BF)
    return t.float().numpy(), t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _sum_abs(values, idx, bins):
    """Each bin's sum of |terms| (f64) for values [B, K, C], idx [B, K]."""
    return voxelize._scatter_sum_plain(
        torch.from_numpy(np.abs(values).astype(np.float64)),
        torch.from_numpy(idx), bins).numpy()


@pytest.mark.parametrize("k,bins,c,skewed", [
    pytest.param(4096, 256, 32, False, id="4096-256-32"),
    pytest.param(768, 128, 130, False, id="768-128-130"),
    pytest.param(384, 128, 9, True, id="384-128-9-one-bin")])
def test_scatter_sum_bf16_against_pallas(k, bins, c, skewed):
    """K1's bf16 sum mode, plain version: bf16 out, within one bf16
    rounding of the JAX package's Pallas one-hot f32 sums of the same bf16
    values; skewed: every row of a cloud in one bin (the FP module after a
    group-all level)."""
    rng = np.random.RandomState(k + c)
    vals, tv, jv = _bf16(rng.randn(2, k, c).astype(np.float32))
    idx = rng.randint(0, bins, (2, k)).astype(np.int32)
    if skewed:
        idx[:] = [[5], [bins - 1]]
    assert pallas_scatter_supported(bins, k, c, jnp.float32)
    with jax.default_matmul_precision("float32"):
        want = _f32(j_scatter_sum(jv, jnp.asarray(idx), bins))
    got = ops.scatter_sum(tv, _t(idx), bins)
    assert got.dtype == BF and got.shape == (2, bins, c)
    exact = voxelize._scatter_sum_plain(
        torch.from_numpy(vals.astype(np.float64)), _t(idx), bins).numpy()
    mag = _sum_abs(vals, idx, bins)
    np.testing.assert_allclose(want, exact, rtol=0, atol=1e-6 * mag.max())
    bad = np.abs(_f32(got) - want) > 2.0 ** -8 * np.abs(want) + 1e-6 * mag
    assert not bad.any(), int(bad.sum())
    assert (_f32(got) == 0).all(-1).sum() == (mag == 0).all(-1).sum()


def _vjp_close(jfn, tfn, primal, cot, bins_of):
    """Forward and VJP of the JAX op (bf16) and the port's (bf16): the
    forward gathers exactly; the VJP, a rounded f32 sum on both sides,
    within one bf16 ulp of each element plus 1e-6 of its sum of |terms|
    (bins_of(cot) -> each row's sum of |cotangent terms|)."""
    _, tp, jp = _bf16(primal)
    _, tc, jc = _bf16(cot)
    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(jfn, jp)
        (want_g,) = vjp(jc)
    p = tp.clone().requires_grad_()
    got = tfn(p)
    assert got.dtype == BF and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(got), _f32(want))
    (got_g,) = torch.autograd.grad(got, p, tc)
    assert got_g.dtype == BF and want_g.dtype == jnp.bfloat16
    want_g, mag = _f32(want_g), bins_of(np.abs(_f32(tc)))
    bad = np.abs(_f32(got_g) - want_g) > 2.0 ** -7 * np.abs(want_g) \
        + 1e-6 * mag
    assert not bad.any(), int(bad.sum())


def test_grouping_bf16_forward_and_vjp():
    """Ball-query neighborhoods of bf16 features (fp32 coordinates): 128
    centers x 16 neighbors of a 256-point table."""
    rng = np.random.RandomState(21)
    x = _room(22, 2, 256)
    c = x[:, ::2].copy()
    idx = ops.ball_query(_t(c), _t(x), 0.3, 16)
    feats = rng.randn(2, 256, 24).astype(np.float32)
    cot = rng.randn(2, 128, 16, 24).astype(np.float32)
    jidx, flat = jnp.asarray(idx.numpy()), idx.reshape(2, -1).numpy()
    _vjp_close(lambda f: jops.grouping(f, jidx),
               lambda f: ops.grouping(f, idx), feats, cot,
               lambda a: _sum_abs(a.reshape(2, -1, 24), flat, 256))


def test_gather_bf16_forward_and_vjp():
    """The FPS gather of bf16 features: 128 centers of 256 points."""
    rng = np.random.RandomState(23)
    x = _room(24, 2, 256)
    idx = ops.furthest_point_sample_indices(_t(x), 128)
    feats = rng.randn(2, 256, 40).astype(np.float32)
    cot = rng.randn(2, 128, 40).astype(np.float32)
    _vjp_close(lambda f: jops.gather(f, jnp.asarray(idx.numpy())),
               lambda f: ops.gather(f, idx), feats, cot,
               lambda a: _sum_abs(a, idx.numpy(), 256))


@pytest.mark.parametrize("m", [128, 256])
def test_nearest_neighbor_interpolate_bf16(m):
    """Three-NN interpolation of bf16 center features onto 512 points: the
    fp32 weights cast to bf16, the 3 products summed in bf16 (as
    pvcnn_tpu/ops/interpolate.py:86); the VJP through take_rows in K1's
    bf16 sum mode. The products and the sum of 3 round on both sides, in
    their own orders: the forward is held to 2^-6 of each output's sum
    of |terms| (the products' roundings and the sum's)."""
    rng = np.random.RandomState(25 + m)
    x = _room(26, 2, 512)
    c = x[:, :m].copy()
    _, tf, jf = _bf16(rng.randn(2, m, 32).astype(np.float32))
    _, tc, jc = _bf16(rng.randn(2, 512, 32).astype(np.float32))
    jx, jcc = jnp.asarray(x), jnp.asarray(c)
    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(
            lambda f: jops.nearest_neighbor_interpolate(jx, jcc, f), jf)
        (want_g,) = vjp(jc)
    p = tf.clone().requires_grad_()
    got = ops.nearest_neighbor_interpolate(_t(x), _t(c), p)
    assert got.dtype == BF
    idx, w = ops.three_nn(_t(x), _t(c))
    rows = np.abs(_f32(ops.grouping(tf, idx)))     # [B, N, 3, C]
    fwd_mag = (rows * w.to(BF).float().numpy()[..., None]).sum(2)
    bad = np.abs(_f32(got) - _f32(want)) > 2.0 ** -6 * fwd_mag
    assert not bad.any(), int(bad.sum())
    (got_g,) = torch.autograd.grad(got, p, tc)
    assert got_g.dtype == BF
    terms = (np.abs(_f32(tc))[:, :, None, :]
             * w.to(BF).float().numpy()[..., None]).reshape(2, -1, 32)
    mag = _sum_abs(terms, idx.reshape(2, -1).numpy(), m)
    want_g = _f32(want_g)
    bad = np.abs(_f32(got_g) - want_g) > 2.0 ** -7 * np.abs(want_g) \
        + 1e-6 * mag
    assert not bad.any(), int(bad.sum())


@pytest.mark.parametrize("train", [False, True])
def test_shared_mlp_dim2_bf16(train):
    """SharedMLP(dim=2) on float32 neighborhoods [B, M, U, C] with bf16
    activations against flax SharedMLP(dtype=bfloat16) and its fp32 self:
    Dense2d casts its input, weight and bias to bf16 at use, BatchNorm
    normalizes the 4-D bf16 rows in f32 and rounds; the output is bf16
    (train: the batch statistics, and the gradients of every parameter,
    which stay float32)."""
    x = _features(30, 2 * 32, 16, 11).reshape(2, 32, 16, 11)
    mods = {dt: jnn.SharedMLP([24, 16], dtype=dt) for dt in (None,
                                                             "bfloat16")}
    port = tnn.SharedMLP(11, [24, 16], dim=2, dtype="bfloat16")
    entries = ci.shared_mlp_entries("m", "m", 2)
    v = _move(mods[None].init(jax.random.PRNGKey(0), x), port, entries,
              seed=31)
    assert isinstance(port.layers[0], tnn.Dense2d)
    g = _features(32, 2 * 32, 16, 16).reshape(2, 32, 16, 16)
    want, grads = {}, {}
    for dt, mod in mods.items():
        def loss(params, m=mod):
            out, _ = m.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, x,
                             train=train, mutable=["batch_stats"])
            return jnp.sum(out.astype(jnp.float32) * g), out

        with jax.default_matmul_precision("float32"):
            (_, out), gr = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                v["params"])
        want[dt] = _f32(out)
        grads[dt] = _flat(gr)
    port.train(train)
    got = port(torch.from_numpy(x))
    assert got.dtype == BF and got.shape == (2, 32, 16, 16)
    _within_rule(_f32(got), want["bfloat16"], want[None])
    if not train:
        return
    (got * torch.from_numpy(g)).float().sum().backward()
    assert {p.grad.dtype for p in port.parameters()} == {torch.float32}
    holder = torch.nn.ModuleDict({"m": port})
    named = dict(holder.named_parameters())
    tree, _ = ci.import_state_dict(
        {k: (named[k].grad if k in named else torch.zeros_like(t)).numpy()
         for k, t in holder.state_dict().items()},
        {"m": v["params"]}, {"m": v["batch_stats"]}, entries)
    _within_rule(_flat(tree["m"]), grads["bfloat16"], grads[None])


def _jax_train(mod, v, args, g):
    """JAX train-mode output and parameter gradients of sum(out * g)."""
    def loss(params):
        out, _ = mod.apply({"params": params,
                            "batch_stats": v["batch_stats"]}, *args,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(out[0].astype(jnp.float32) * g), out[0]

    with jax.default_matmul_precision("float32"):
        (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v["params"])
    return _f32(out), _flat(grads)


def _module_rule(make_flax, port, entries, args, seed, g_shape):
    """A module's eval output and its train-mode output and parameter
    gradients of sum(out * g), the port in bf16 against flax in bf16 and
    fp32, by the rule; the port's parameters and their gradients stay
    float32."""
    flax = {dt: make_flax(dt) for dt in (None, "bfloat16")}
    v = _move(flax[None].init(jax.random.PRNGKey(0), *args), port, entries,
              seed=seed)
    port.zero_grad(set_to_none=True)
    targs = [None if a is None else torch.from_numpy(a) for a in args]
    want = {}
    for dt, mod in flax.items():
        fn = jax.jit(lambda vv, *a, m=mod: m.apply(vv, *a, train=False)[0])
        with jax.default_matmul_precision("float32"):
            want[dt] = _f32(fn(v, *args))
    with torch.no_grad():
        got = port.eval()(*targs)[0]
    assert got.dtype == BF
    _within_rule(_f32(got), want["bfloat16"], want[None])
    g = _features(seed + 1, 1, int(np.prod(g_shape[:-1])),
                  g_shape[-1]).reshape(g_shape)
    runs = {dt: _jax_train(mod, v, args, g) for dt, mod in flax.items()}
    got = port.train()(*targs)[0]
    assert got.dtype == BF
    (got.float() * torch.from_numpy(g)).sum().backward()
    assert {p.grad.dtype for p in port.parameters()} == {torch.float32}
    holder = torch.nn.ModuleDict({"m": port})
    named = dict(holder.named_parameters())
    tree, _ = ci.import_state_dict(
        {k: (named[k].grad if k in named else torch.zeros_like(t)).numpy()
         for k, t in holder.state_dict().items()},
        {"m": v["params"]}, {"m": v["batch_stats"]}, entries)
    _within_rule(_f32(got), runs["bfloat16"][0], runs[None][0])
    _within_rule(_flat(tree["m"]), runs["bfloat16"][1], runs[None][1])


@pytest.mark.parametrize("radius,num_neighbors,mlps", [
    (0.3, 16, (16, 32)),
    ([0.2, 0.4], [8, 16], [(16, 16), (16, 24)]),          # multi-scale
])
def test_sa_module_bf16(radius, num_neighbors, mlps):
    """PointNetSAModule(dtype=bfloat16) on bf16 features of 256 points,
    128 centers: the SharedMLP(dim=2) branches in bf16 on the float32
    concatenation of relative coordinates and bf16 features; the grouping's
    backward in K1's bf16 sum mode."""
    x = _room(33, 2, 256)
    feats = _features(34, 2, 256, 8)
    radii = radius if isinstance(radius, list) else [radius]
    nbrs = (num_neighbors if isinstance(num_neighbors, list)
            else [num_neighbors])
    branches = mlps if isinstance(mlps[0], tuple) else [mlps]
    port = tnn.PointNetSAModule(128, radius, num_neighbors, 8, mlps,
                                dtype="bfloat16")
    entries = ci._sa_module_entries((128, radius, num_neighbors, mlps), "m",
                                    "m")
    calls = []

    def counted(values, idx, bins):
        calls.append(values.dtype)
        return voxelize.scatter_sum(values, idx, bins)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gather_utils, "scatter_sum", counted)
        feats16 = torch.from_numpy(feats).to(BF).requires_grad_()
        out, _ = port.train()(feats16, torch.from_numpy(x))
        out.float().sum().backward()
    assert calls and set(calls) == {BF}
    _module_rule(
        lambda dt: jnn.PointNetSAModule(num_centers=128, radius=radii,
                                        num_neighbors=nbrs, mlps=branches,
                                        dtype=dt),
        port, entries, (feats, x), 35, (2, 128, port.out_channels))


def test_a_module_bf16():
    """PointNetAModule(dtype=bfloat16): the bf16 features and the float32
    coordinates concatenated (float32), the SharedMLP in bf16, the max over
    the points in bf16; the zero center stays float32. 512 points a
    cloud: the gradient reaches one point a channel through the max, whose
    winner a rounding may move (at 128 points JAX's own bf16 gradients
    lay 0.08-0.11 from its fp32 ones, eager or jitted)."""
    x = _room(36, 2, 512)
    feats = _features(37, 2, 512, 8)
    port = tnn.PointNetAModule(8, (16, 32), dtype="bfloat16")
    entries = ci._sa_module_entries((None, None, None, (16, 32)), "m", "m")
    _, center = port(torch.from_numpy(feats), torch.from_numpy(x))
    assert center.dtype == torch.float32
    _module_rule(lambda dt: jnn.PointNetAModule(mlps=[(16, 32)], dtype=dt),
                 port, entries, (feats, x), 38, (2, 1, 32))


@pytest.mark.parametrize("with_skip", [True, False])
def test_fp_module_bf16(with_skip):
    """PointNetFPModule(dtype=bfloat16): three-NN interpolation of the
    centers' features (128 of 256 points) in bf16, the float32 skip
    features concatenated, the SharedMLP in bf16."""
    x = _room(39, 2, 256)
    c = x[:, :128].copy()
    cf = _features(40, 2, 128, 16)
    pf = _features(41, 2, 256, 4) if with_skip else None
    port = tnn.PointNetFPModule(16 + (4 if with_skip else 0), (24, 16),
                                dtype="bfloat16")
    entries = ci.shared_mlp_entries("m.mlp", "m/SharedMLP_0", 2)
    _module_rule(lambda dt: jnn.PointNetFPModule(mlp=(24, 16), dtype=dt),
                 port, entries, (x, c, cf, pf), 42, (2, 256, 16))
