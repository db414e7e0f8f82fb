"""The port's nn modules (pvcnn_tpu_torch/nn) against their flax counterparts
in pvcnn_tpu/nn, in eval mode (and PVConv in train mode, gradients included), with the flax variables moved into the port
by pvcnn_tpu_torch/utils/weights.py through the checkpoint-import mapping
entries.

The flax variables are randomized first (BatchNorm scale/bias and running
statistics included), so every tensor the mapping moves takes part in the
comparison. JAX runs its CPU formulations here, and in interpret mode where
a case says so (the fused flat-rows PVConv branch, R^2 % 128 == 0).
Tolerance 1e-5 for single layers, 1e-4 for the PVConv block (conv sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import nn as jnn
from pvcnn_tpu.nn.shared_mlp import SplitDense as JSplitDense
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch import nn as tnn
from pvcnn_tpu_torch.utils.weights import state_dict_from_jax


def _randomize(tree, seed):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.2, x.shape).astype(np.float32)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _move(variables, port, entries, seed):
    """Randomize flax `variables`, load them into `port` under the name `m`
    of the mapping entries; -> the randomized flax variables."""
    params = _randomize(variables["params"], seed)
    stats = _randomize(variables.get("batch_stats", {}), seed + 1)
    holder = torch.nn.ModuleDict({"m": port})
    holder.load_state_dict(state_dict_from_jax(
        {"m": params}, {"m": stats}, entries, holder.state_dict()))
    port.eval()
    return {"params": params, "batch_stats": stats}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("out_channels", [[16], [16, 32]])
def test_shared_mlp(out_channels):
    x = np.random.RandomState(0).randn(2, 64, 6).astype(np.float32)
    flax_mod = jnn.SharedMLP(out_channels)
    port = tnn.SharedMLP(6, out_channels)
    v = _move(flax_mod.init(jax.random.PRNGKey(0), x), port,
              ci.shared_mlp_entries("m", "m", len(out_channels)), seed=1)
    _close(port(torch.from_numpy(x)), flax_mod.apply(v, x, train=False))


@pytest.mark.parametrize("eps", [1e-5, 1e-4])
def test_batchnorm_eval_and_fold(eps):
    x = np.random.RandomState(2).randn(2, 64, 16).astype(np.float32)
    flax_mod = jnn.BatchNorm(epsilon=eps)
    port = tnn.BatchNorm(16, eps=eps)
    v = _move(flax_mod.init(jax.random.PRNGKey(0), x), port,
              [("m", "m", "bn")], seed=3)
    _close(port(torch.from_numpy(x)), flax_mod.apply(v, x, train=False))
    want_scale, want_shift = flax_mod.apply(v, train=False, affine=True,
                                            features=16)
    got_scale, got_shift = port.fold()
    _close(got_scale, want_scale)
    _close(got_shift, want_shift)
    # the fold is the normalize pass as an affine map
    _close(torch.from_numpy(x) * got_scale + got_shift,
           flax_mod.apply(v, x, train=False))


def test_batchnorm_fold_needs_eval_mode():
    with pytest.raises(RuntimeError, match="eval mode"):
        tnn.BatchNorm(8).train().fold()


def test_split_dense():
    rng = np.random.RandomState(4)
    xs = [rng.randn(2, 64, 5).astype(np.float32),
          rng.randn(2, 64, 7).astype(np.float32),
          rng.randn(2, 1, 4).astype(np.float32)]   # broadcast global feature
    flax_mod = JSplitDense(12)
    port = tnn.SplitDense(16, 12)
    v = _move(flax_mod.init(jax.random.PRNGKey(0), xs), port,
              [("m", "m", "dense")], seed=5)
    got = port([torch.from_numpy(x) for x in xs])
    _close(got, flax_mod.apply(v, xs))
    # == the plain layer on the materialized concat
    cat = torch.cat([torch.from_numpy(xs[0]), torch.from_numpy(xs[1]),
                     torch.from_numpy(xs[2]).expand(-1, 64, -1)], dim=-1)
    _close(got, port(cat).detach().numpy())
    with pytest.raises(ValueError, match="channels"):
        port([torch.from_numpy(xs[0])])


def test_se3d():
    x = np.random.RandomState(6).randn(2, 16, 512).astype(np.float32)
    flax_mod = jnn.pvconv.SE3d(16)
    port = tnn.SE3d(16)
    v = _move(flax_mod.init(jax.random.PRNGKey(0), x), port,
              [("m.fc.0", "m/Dense_0", "dense"),
               ("m.fc.2", "m/Dense_1", "dense")], seed=7)
    _close(port(torch.from_numpy(x)), flax_mod.apply(v, x))


def test_conv3d_same_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        tnn.Conv3dSame(4, 4, kernel_size=2)


@pytest.mark.parametrize("r,cin,cout,with_se,normalize,interpret", [
    (16, 6, 16, True, False, False),
    (16, 6, 16, True, False, True),       # JAX: fused flat-rows branch
    (8, 16, 16, False, True, False),
])
def test_pvconv(monkeypatch, r, cin, cout, with_se, normalize, interpret):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", str(int(interpret)))
    rng = np.random.RandomState(r + cin)
    feats = rng.randn(2, 256, cin).astype(np.float32)
    coords = (rng.uniform(-1, 1, (2, 256, 3)) * [1.0, 0.6, 0.4]).astype(
        np.float32)
    flax_mod = jnn.PVConv(cout, 3, r, with_se=with_se, normalize=normalize,
                          eps=1e-4 if normalize else 0.0)
    port = tnn.PVConv(cin, cout, 3, r, with_se=with_se, normalize=normalize,
                      eps=1e-4 if normalize else 0.0)
    v = _move(flax_mod.init(jax.random.PRNGKey(0), feats, coords), port,
              ci.pvconv_entries("m", "m", with_se), seed=8)
    with jax.default_matmul_precision("float32"):
        want, _ = flax_mod.apply(v, feats, coords, train=False)
    with torch.no_grad():
        got, got_coords = port(torch.from_numpy(feats),
                               torch.from_numpy(coords))
    _close(got, want, tol=1e-4)
    assert torch.equal(got_coords, torch.from_numpy(coords))


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x, np.float64))
                           for x in jax.tree.leaves(tree)])


def _assert_train_state(port, v, entries, want_grads, want_stats):
    """The port module's parameter gradients and running statistics, moved
    into the flax tree through the mapping `entries` (under the name `m`),
    against flax's: within 1e-4 (statistics) and 1e-4 of the largest
    gradient."""
    holder = torch.nn.ModuleDict({"m": port})
    named = dict(holder.named_parameters())
    grads = {k: (named[k].grad if k in named else torch.zeros_like(t))
             .numpy() for k, t in holder.state_dict().items()}
    templates = ({"m": v["params"]}, {"m": v["batch_stats"]})
    got_grads, _ = ci.import_state_dict(grads, *templates, entries)
    state = {k: t.numpy() for k, t in holder.state_dict().items()}
    _, got_stats = ci.import_state_dict(state, *templates, entries)
    np.testing.assert_allclose(_flat(got_stats["m"]), _flat(want_stats),
                               rtol=1e-4, atol=1e-4)
    want_flat, got_flat = _flat(want_grads), _flat(got_grads["m"])
    assert np.abs(want_flat).max() > 0
    np.testing.assert_allclose(got_flat, want_flat, rtol=1e-4,
                               atol=1e-4 * np.abs(want_flat).max())


@pytest.mark.parametrize("r,cin,cout,with_se,normalize,interpret", [
    (16, 6, 16, True, False, True),       # JAX: fused rows branch, Pallas
    (8, 16, 16, False, True, False),      # JAX: NDHWC branch, XLA
])
def test_pvconv_train(monkeypatch, r, cin, cout, with_se, normalize,
                      interpret):
    """Train mode: the output (batch-statistic BatchNorms folded from the
    convs' sums), the updated running statistics, and every parameter
    gradient of sum(out * g) against the flax PVConv with train=True."""
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", str(int(interpret)))
    rng = np.random.RandomState(3 * r + cin)
    feats = rng.randn(2, 256, cin).astype(np.float32)
    coords = (rng.uniform(-1, 1, (2, 256, 3)) * [1.0, 0.6, 0.4]).astype(
        np.float32)
    g = rng.randn(2, 256, cout).astype(np.float32)
    kw = dict(with_se=with_se, normalize=normalize,
              eps=1e-4 if normalize else 0.0)
    flax_mod = jnn.PVConv(cout, 3, r, **kw)
    port = tnn.PVConv(cin, cout, 3, r, **kw)
    entries = ci.pvconv_entries("m", "m", with_se)
    v = _move(flax_mod.init(jax.random.PRNGKey(0), feats, coords), port,
              entries, seed=9)

    def loss(params):
        (out, _), mutated = flax_mod.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, feats,
            coords, train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mutated["batch_stats"])

    with jax.default_matmul_precision("float32"):
        (_, (want, want_stats)), want_grads = jax.value_and_grad(
            loss, has_aux=True)(v["params"])
    port.train()
    got, _ = port(torch.from_numpy(feats), torch.from_numpy(coords))
    _close(got, want, tol=1e-4)
    (got * torch.from_numpy(g)).sum().backward()
    _assert_train_state(port, v, entries, want_grads, want_stats)


def test_batchnorm_fold_from_sums_needs_train_mode():
    with pytest.raises(RuntimeError, match="train mode"):
        tnn.BatchNorm(8).eval().fold_from_sums(torch.zeros(8), torch.ones(8),
                                               4)


def test_batchnorm_apply_from_sums_matches_batch_norm():
    """apply_from_sums on a batch's sums is train-mode BatchNorm: the same
    output and the same running statistics (fp64, atol 1e-10)."""
    rng = np.random.RandomState(3)
    y = torch.from_numpy(rng.randn(4, 64, 8) * 2 + 1)
    a, b = tnn.BatchNorm(8).double(), tnn.BatchNorm(8).double()
    weight, bias = rng.rand(8) + 0.5, rng.randn(8)
    with torch.no_grad():
        for bn in (a, b):
            bn.weight.copy_(torch.from_numpy(weight))
            bn.bias.copy_(torch.from_numpy(bias))
    rows = y.reshape(-1, 8)
    got = a.apply_from_sums(y, rows.sum(0), (rows * rows).sum(0), 256)
    want = b(y)
    for g, w in ((got, want), (a.running_mean, b.running_mean),
                 (a.running_var, b.running_var)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.parametrize("spec,classifier", [
    ([16, 0.5, 32], False), ([256, 0.2, 256, 0.2, 128, 50], True)])
def test_mlp_builder_matches_jax(spec, classifier):
    """The port's create_mlp_components builds the layers the JAX builder
    does (widths, dropout slots) and reports the same output width."""
    from pvcnn_tpu.models.utils import create_mlp_components as jbuild
    from pvcnn_tpu_torch.models.utils import create_mlp_components as tbuild

    jlayers, jout = jbuild(8, spec, classifier=classifier,
                           width_multiplier=0.5)
    tlayers, tout = tbuild(8, spec, classifier=classifier,
                           width_multiplier=0.5)
    assert tout == jout and len(tlayers) == len(jlayers)
    for t, j in zip(tlayers, jlayers):
        if isinstance(t, torch.nn.Dropout):
            assert t.p == j.rate
        elif isinstance(t, tnn.SharedMLP):
            assert [t.layers[0].out_channels] == list(j.out_channels)
        else:
            assert t.out_channels == j.features
