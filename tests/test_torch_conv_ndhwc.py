"""The port's NDHWC voxel branch against the JAX package: the plain version
of K11 (the NDHWC conv weight gradient) against the Pallas kernel in
interpret mode, conv3d_same's VJP against jax.vjp of
pvcnn_tpu.nn.conv3d.conv3d_same, and the NDHWC PVConv (PVCNN_TPU_CONV_ROWS=0,
with and without PVCNN_TPU_CUSTOM_CONV_WGRAD) against the flax PVConv under
the same switches: train-mode output, gradients, batch statistics, and the
eval output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import nn as jnn
from pvcnn_tpu.nn.conv3d import conv3d_same as jconv3d_same
from pvcnn_tpu.ops.pallas.conv_wgrad import conv3d_wgrad as jconv3d_wgrad
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch import nn as tnn
from pvcnn_tpu_torch import ops
from pvcnn_tpu_torch.ops import conv3d
from test_torch_modules import _assert_train_state, _move


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "1")


def _to_torch_weight(kernel):
    """JAX [k, k, k, Ci, Co] -> torch Conv3d [Co, Ci, k, k, k]."""
    return np.ascontiguousarray(np.transpose(kernel, (4, 3, 0, 1, 2)))


@pytest.mark.parametrize("b,r,ci,co", [(2, 8, 5, 7), (1, 16, 4, 3)])
def test_ndhwc_wgrad_plain_matches_pallas(interpret, b, r, ci, co):
    """The 27 shifted-slice products (K11's plain version) against the
    Pallas offset-window kernel in interpret mode, at fp32 matmul
    precision: within 1e-5 of the largest entry (sums of B * R^3
    products in another order)."""
    rng = np.random.RandomState(r + ci)
    x = rng.randn(b, r, r, r, ci).astype(np.float32)
    g = rng.randn(b, r, r, r, co).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want = jconv3d_wgrad(jnp.asarray(x), jnp.asarray(g), 3)
    assert want is not None                       # the kernel planned
    want = _to_torch_weight(np.asarray(want))
    got = conv3d._ndhwc_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g),
                                    3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("r,ci,co", [(8, 6, 16), (4, 16, 12)])
def test_conv3d_same_vjp_matches_jax(interpret, r, ci, co):
    """Output, input gradient and weight gradient of the port's conv3d_same
    against jax.vjp of the JAX custom-VJP conv (its weight gradient the
    Pallas kernel in interpret mode): within 1e-5 (data) and 1e-5 of the
    largest entry (weights)."""
    rng = np.random.RandomState(3 * r + ci)
    x = rng.randn(2, r, r, r, ci).astype(np.float32)
    kernel = (rng.randn(3, 3, 3, ci, co) / np.sqrt(27 * ci)).astype(
        np.float32)
    g = rng.randn(2, r, r, r, co).astype(np.float32)
    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(jconv3d_same, jnp.asarray(x), jnp.asarray(kernel))
        want_dx, want_dk = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(_to_torch_weight(kernel)).requires_grad_()
    got = ops.conv3d_same(xt, wt)
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=1e-5, atol=1e-5)
    want_dw = _to_torch_weight(np.asarray(want_dk))
    np.testing.assert_allclose(dw.numpy(), want_dw, rtol=1e-5,
                               atol=1e-5 * np.abs(want_dw).max())


def test_conv3d_same_computes_only_what_is_asked(monkeypatch):
    calls = []
    real = conv3d._ndhwc_wgrad_plain
    monkeypatch.setattr(conv3d, "_ndhwc_wgrad_plain",
                        lambda *a: calls.append(1) or real(*a))
    x = torch.randn(1, 4, 4, 4, 3)
    w = torch.randn(5, 3, 3, 3, 3)
    ops.conv3d_same(x, w.requires_grad_()).sum().backward()
    assert len(calls) == 1 and w.grad is not None
    xg = x.clone().requires_grad_()
    ops.conv3d_same(xg, w.detach()).sum().backward()
    assert len(calls) == 1 and xg.grad is not None


def _set_branch(monkeypatch, custom_wgrad: bool):
    monkeypatch.setenv("PVCNN_TPU_CONV_ROWS", "0")
    monkeypatch.setenv("PVCNN_TPU_CUSTOM_CONV_WGRAD", str(int(custom_wgrad)))


@pytest.mark.parametrize("r,cin,cout,with_se,normalize,custom_wgrad", [
    (8, 6, 16, False, True, True),
    (8, 16, 16, True, False, True),       # SE on the NDHWC grid
    (8, 6, 16, False, True, False),       # F.conv3d's own weight gradient
])
def test_ndhwc_pvconv_matches_jax(monkeypatch, interpret, r, cin, cout,
                                  with_se, normalize, custom_wgrad):
    """The NDHWC PVConv against the flax PVConv with the same switches (its
    custom weight gradient the Pallas kernel in interpret mode): train-mode
    output, every parameter gradient of sum(out * g) and the updated
    running statistics within 1e-4, then the eval output within 1e-4."""
    _set_branch(monkeypatch, custom_wgrad)
    rng = np.random.RandomState(5 * r + cin)
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
              entries, seed=11)

    def loss(params):
        (out, _), mutated = flax_mod.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, feats,
            coords, train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mutated["batch_stats"])

    with jax.default_matmul_precision("float32"):
        (_, (want, want_stats)), want_grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"])
    calls = []
    real = conv3d._ndhwc_wgrad_plain
    monkeypatch.setattr(conv3d, "_ndhwc_wgrad_plain",
                        lambda *a: calls.append(1) or real(*a))
    port.train()
    got, _ = port(torch.from_numpy(feats), torch.from_numpy(coords))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    (got * torch.from_numpy(g)).sum().backward()
    assert len(calls) == (2 if custom_wgrad else 0)
    _assert_train_state(port, v, entries, want_grads, want_stats)

    port.eval()
    with torch.no_grad():
        got, _ = port(torch.from_numpy(feats), torch.from_numpy(coords))
    with jax.default_matmul_precision("float32"):
        want, _ = flax_mod.apply({"params": v["params"],
                                  "batch_stats": want_stats}, feats, coords,
                                 train=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_ndhwc_and_rows_branches_agree(monkeypatch):
    """Inside the port, one PVConv on its two branches: the same function
    in another layout (eval within 1e-5; train output and gradients within
    1e-4), with the same state_dict keys."""
    rng = np.random.RandomState(2)
    feats = torch.from_numpy(rng.randn(2, 256, 6).astype(np.float32))
    coords = torch.from_numpy(rng.uniform(-1, 1, (2, 256, 3)).astype(
        np.float32))
    from pvcnn_tpu_torch.utils.weights import init_random_

    port = init_random_(tnn.PVConv(6, 16, 3, 8, with_se=True), 3)
    start = {k: t.clone() for k, t in port.state_dict().items()}
    out = {}
    for rows in (True, False):
        if rows:
            monkeypatch.delenv("PVCNN_TPU_CONV_ROWS", raising=False)
        else:
            _set_branch(monkeypatch, True)
        port.load_state_dict(start)     # the train step moved the statistics
        port.zero_grad()
        port.eval()
        with torch.no_grad():
            ev, _ = port(feats, coords)
        port.train()
        tr, _ = port(feats, coords)
        tr.square().sum().backward()
        grads = torch.cat([p.grad.reshape(-1) for p in port.parameters()])
        out[rows] = (ev, tr.detach(), grads)
    (e0, t0, g0), (e1, t1, g1) = out[True], out[False]
    torch.testing.assert_close(e1, e0, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(t1, t0, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(g1, g0, rtol=1e-4,
                               atol=1e-4 * g0.abs().max().item())
