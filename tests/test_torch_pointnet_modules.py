"""The port's PointNet++ modules (BallQuery, PointNetAModule,
PointNetSAModule, PointNetFPModule, the dim=2 SharedMLP) and component
constructors against their flax counterparts, with the flax variables moved
into the port by pvcnn_tpu_torch/utils/weights.py through the
checkpoint-import mapping entries (BatchNorm statistics randomized, so every
moved tensor takes part).

JAX runs its CPU formulations, or its Pallas kernels in interpret mode
where a case says so. Tolerance 1e-4 (matmul sums in another order ahead of
the max over the neighbors), eval mode, and for the SA and FP modules also
train mode with every parameter gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import nn as jnn
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch import nn as tnn
from pvcnn_tpu_torch.utils.weights import init_random_
from test_torch_modules import _flat, _move
from test_torch_pointnet_ops import _room


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _features(seed, b, n, c):
    return np.random.RandomState(seed).randn(b, n, c).astype(np.float32)


def test_ball_query_module():
    x = _room(1, 2, 128)
    c = x[:, ::4].copy()
    feats = _features(2, 2, 128, 8)
    mod = jnn.BallQuery(radius=0.3, num_neighbors=16)
    port = tnn.BallQuery(0.3, 16)
    want = mod.apply({}, x, c, feats)
    got = port(torch.from_numpy(x), torch.from_numpy(c),
               torch.from_numpy(feats))
    assert got.shape == (2, 32, 16, 11)
    _close(got, want, tol=1e-6)
    _close(port(torch.from_numpy(x), torch.from_numpy(c)),
           mod.apply({}, x, c), tol=1e-6)
    bare = tnn.BallQuery(0.3, 16, include_coordinates=False)
    _close(bare(torch.from_numpy(x), torch.from_numpy(c),
                torch.from_numpy(feats)),
           jnn.BallQuery(0.3, 16, include_coordinates=False).apply(
               {}, x, c, feats), tol=1e-6)


def _train_grads(flax_mod, v, port, entries, args_j, args_t, g):
    """Train-mode output and parameter gradients of sum(out * g), JAX and
    the port -> (want, got, want_grads, got_grads) flat."""
    def loss(params):
        out, _ = flax_mod.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, *args_j,
                                train=True, mutable=["batch_stats"])
        return jnp.sum(out[0] * g), out[0]

    with jax.default_matmul_precision("float32"):
        (_, want), want_grads = jax.value_and_grad(loss, has_aux=True)(
            v["params"])
    port.train()
    got = port(*args_t)[0]
    (got * torch.from_numpy(g)).sum().backward()
    holder = torch.nn.ModuleDict({"m": port})
    named = dict(holder.named_parameters())
    grads = {k: (named[k].grad if k in named else torch.zeros_like(t))
             .numpy() for k, t in holder.state_dict().items()}
    got_grads, _ = ci.import_state_dict(
        grads, {"m": v["params"]}, {"m": v["batch_stats"]}, entries)
    return want, got, _flat(want_grads), _flat(got_grads["m"])


@pytest.mark.parametrize("radius,num_neighbors,mlps,interpret", [
    (0.3, 16, (16, 32), False),
    (0.3, 16, (16, 32), True),
    ([0.2, 0.4], [8, 16], [(16, 16), (16, 24)], False),   # multi-scale
])
def test_sa_module(monkeypatch, radius, num_neighbors, mlps, interpret):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", str(int(interpret)))
    x = _room(3, 2, 128)
    feats = _features(4, 2, 128, 8)
    radii = radius if isinstance(radius, list) else [radius]
    nbrs = (num_neighbors if isinstance(num_neighbors, list)
            else [num_neighbors])
    branches = mlps if isinstance(mlps[0], tuple) else [mlps]
    flax_mod = jnn.PointNetSAModule(num_centers=32, radius=radii,
                                    num_neighbors=nbrs, mlps=branches)
    port = tnn.PointNetSAModule(32, radius, num_neighbors, 8, mlps)
    entries = ci._sa_module_entries((32, radius, num_neighbors, mlps), "m",
                                    "m")
    v = _move(flax_mod.init(jax.random.PRNGKey(0), feats, x), port, entries,
              seed=5)
    assert port.mlps[0].layers[0].weight.dim() == 4     # Conv2d [o, i, 1, 1]
    with jax.default_matmul_precision("float32"):
        want, want_c = flax_mod.apply(v, feats, x, train=False)
    with torch.no_grad():
        got, got_c = port(torch.from_numpy(feats), torch.from_numpy(x))
    assert got.shape == (2, 32, port.out_channels)
    _close(got, want)
    _close(got_c, want_c, tol=0)
    g = _features(6, 2, 32, port.out_channels)
    want, got, wg, gg = _train_grads(flax_mod, v, port, entries,
                                     (feats, x), (torch.from_numpy(feats),
                                                  torch.from_numpy(x)), g)
    _close(got, want)
    np.testing.assert_allclose(gg, wg, rtol=1e-4,
                               atol=1e-4 * np.abs(wg).max())


def test_a_module():
    x = _room(7, 2, 64)
    feats = _features(8, 2, 64, 8)
    flax_mod = jnn.PointNetAModule(mlps=[(16, 32)])
    port = tnn.PointNetAModule(8, (16, 32))
    entries = ci._sa_module_entries((None, None, None, (16, 32)), "m", "m")
    v = _move(flax_mod.init(jax.random.PRNGKey(0), feats, x), port, entries,
              seed=9)
    with jax.default_matmul_precision("float32"):
        want, want_c = flax_mod.apply(v, feats, x, train=False)
    with torch.no_grad():
        got, got_c = port(torch.from_numpy(feats), torch.from_numpy(x))
    assert got.shape == (2, 1, 32) and got_c.shape == (2, 1, 3)
    _close(got, want)
    _close(got_c, want_c, tol=0)


@pytest.mark.parametrize("with_skip,interpret", [(True, False),
                                                 (True, True),
                                                 (False, False)])
def test_fp_module(monkeypatch, with_skip, interpret):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", str(int(interpret)))
    x = _room(10, 2, 128)
    c = x[:, :32].copy()
    cf = _features(11, 2, 32, 16)
    pf = _features(12, 2, 128, 4) if with_skip else None
    flax_mod = jnn.PointNetFPModule(mlp=(24, 16))
    port = tnn.PointNetFPModule(16 + (4 if with_skip else 0), (24, 16))
    entries = ci.shared_mlp_entries("m.mlp", "m/SharedMLP_0", 2)
    v = _move(flax_mod.init(jax.random.PRNGKey(0), x, c, cf, pf), port,
              entries, seed=13)
    t = [torch.from_numpy(a) if a is not None else None
         for a in (x, c, cf, pf)]
    with jax.default_matmul_precision("float32"):
        want, _ = flax_mod.apply(v, x, c, cf, pf, train=False)
    with torch.no_grad():
        got, got_c = port(*t)
    _close(got, want)
    assert got_c is t[0]
    g = _features(14, 2, 128, 16)
    want, got, wg, gg = _train_grads(flax_mod, v, port, entries,
                                     (x, c, cf, pf), t, g)
    _close(got, want)
    np.testing.assert_allclose(gg, wg, rtol=1e-4,
                               atol=1e-4 * np.abs(wg).max())


def test_shared_mlp_dim2_holds_conv2d_weights():
    port = tnn.SharedMLP(5, [8, 4], dim=2)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert shapes["layers.0.weight"] == (8, 5, 1, 1)
    assert shapes["layers.3.weight"] == (4, 8, 1, 1)
    x = torch.randn(2, 3, 7, 5)
    assert port.eval()(x).shape == (2, 3, 7, 4)
    with pytest.raises(ValueError, match="dim"):
        tnn.SharedMLP(5, 8, dim=3)


def test_init_random_draws_conv2d_weights():
    """Two models built from one seed have equal state dicts, the SA
    modules' Conv2d weights included (torch's global generator is not
    read)."""
    from pvcnn_tpu_torch.models.s3dis import PVCNN2

    a = init_random_(PVCNN2(13, width_multiplier=0.25), seed=3)
    torch.manual_seed(123)
    torch.rand(7)
    b = init_random_(PVCNN2(13, width_multiplier=0.25), seed=3)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    conv2d = [k for k, v in sa.items() if v.dim() == 4]
    assert conv2d
    c = init_random_(PVCNN2(13, width_multiplier=0.25), seed=4).state_dict()
    assert not torch.equal(sa[conv2d[0]], c[conv2d[0]])


def _pointnet2_blocks():
    from pvcnn_tpu.models.s3dis import PVCNN2 as JPVCNN2
    from pvcnn_tpu.models.shapenet import pointnetpp as jpp

    return {"pvcnn2": (JPVCNN2.sa_blocks, JPVCNN2.fp_blocks, 6, True),
            "ssg": (jpp.SSG_SA_BLOCKS, jpp.SSG_FP_BLOCKS, 3, False),
            "msg": (jpp.MSG_SA_BLOCKS, jpp.MSG_FP_BLOCKS, 3, False)}


@pytest.mark.parametrize("blocks", ["pvcnn2", "ssg", "msg"])
def test_pointnet2_components_match_jax(blocks):
    """create_pointnet2_{sa,fp} build the groups the JAX functions build:
    the same module kinds, centers, radii and widths, and the same channel
    bookkeeping; and each layer's weight has the shape the reference
    gives it (torch_twins' twin_sa_components / twin_fp_modules),
    input widths included: a set abstraction without conv blocks before it
    reads the extra features and the 3 relative coordinates (SSG's and
    MSG's SA1: 3 normals + 3)."""
    import torch_twins as tw
    from pvcnn_tpu.models import utils as jutils
    from pvcnn_tpu_torch.models import utils as tutils

    sa, fp, extra, with_se = _pointnet2_blocks()[blocks]
    jsa, jin, jch, jm = jutils.create_pointnet2_sa_components(
        sa, extra, with_se=with_se, width_multiplier=0.5)
    tsa, tin, tch, tm = tutils.create_pointnet2_sa_components(
        sa, extra, with_se=with_se, width_multiplier=0.5)
    wsa, win, wch, wm = tw.twin_sa_components(
        sa, extra, with_se=with_se, width_multiplier=0.5)
    assert (tin, tch, tm) == (jin, jch, jm) == (win, wch, wm)
    for jg, tg in zip(jsa, tsa):
        members = list(tg) if isinstance(tg, torch.nn.Sequential) else [tg]
        assert [type(m).__name__ for m in members] == \
            [type(m).__name__ for m in jg]
        jsam, tsam = jg[-1], members[-1]
        assert getattr(tsam, "num_centers", None) == \
            getattr(jsam, "num_centers", None)
        assert [g.radius for g in getattr(tsam, "groupers", [])] == \
            list(getattr(jsam, "radius", None) or [])
        assert [[l.out_channels for l in m.layers[0::3]]
                for m in tsam.mlps] == [list(b) for b in jsam.mlps]
    shapes = lambda layers: {k: tuple(v.shape) for k, v in
                             torch.nn.ModuleList(layers).state_dict().items()}
    assert shapes(tsa) == shapes(wsa)
    if blocks == "pvcnn2":          # only the raw extra features skip
        jin[0] = tin[0] = win[0] = extra
    jfp, jout = jutils.create_pointnet2_fp_modules(
        fp, jch, jin, with_se=with_se, width_multiplier=0.5)
    tfp, tout = tutils.create_pointnet2_fp_modules(
        fp, tch, tin, with_se=with_se, width_multiplier=0.5)
    wfp, wout = tw.twin_fp_modules(fp, wch, win, with_se=with_se,
                                   width_multiplier=0.5)
    assert tout == jout == wout
    for jg, tg in zip(jfp, tfp):
        members = list(tg) if isinstance(tg, torch.nn.Sequential) else [tg]
        assert [type(m).__name__ for m in members] == \
            [type(m).__name__ for m in jg]
        assert [l.out_channels for l in members[0].mlp.layers[0::3]] == \
            list(jg[0].mlp)
    assert shapes(tfp) == shapes(wfp)
