"""The port's fused dense layer (pvcnn_tpu_torch/ops/dense_rows.py, kernels
K9/K10 on the card, their plain versions here) and the modules built on it,
against the JAX package: dense_rows_act forward and VJP against the Pallas
kernel in interpret mode, the fused train-mode SharedMLP against the flax
SharedMLP under PVCNN_TPU_DENSE_BN_FUSED=auto, DenseBNReLU against flax,
and the port's knob registry against the JAX package's.

Sizes: 1024 and 2048 rows (the fused path needs rows >= 1024 and rows % 256
== 0), channel counts that are not multiples of the kernels' tiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import nn as jnn
from pvcnn_tpu.ops.pallas.dense_rows import dense_rows_act as jdense_rows_act
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu.utils import knobs as jknobs
from pvcnn_tpu_torch import nn as tnn
from pvcnn_tpu_torch.ops import dense_rows_act
from pvcnn_tpu_torch.utils import knobs
from test_torch_modules import _assert_train_state, _move


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "1")


def _jax_op(slope, has_prologue, want_stats):
    """jit of (forward, VJP) of the JAX op at one static configuration."""
    def f(*args):
        return jdense_rows_act(*args, slope, has_prologue, want_stats)

    def run(args, cot):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cot)

    return jax.jit(run)


@pytest.mark.parametrize("lead,ci,co", [((2, 512), 9, 70), ((4, 512), 33, 20)])
@pytest.mark.parametrize("has_prologue,slope", [(False, 0.0), (True, 0.0),
                                                (True, 0.1)])
@pytest.mark.parametrize("want_stats", [False, True])
def test_dense_rows_act_matches_jax(interpret, lead, ci, co, has_prologue,
                                    slope, want_stats):
    """y, s1, s2 and the VJP in every input (cotangents on all three
    outputs) against the JAX op, the Pallas kernel run in interpret mode at
    fp32 matmul precision. Tolerance: 1e-5 relative and absolute for y and
    the data gradients (sums of at most 70 products); the statistics and
    the weight, bias, scale and shift gradients sum over all rows, so their
    absolute tolerance is 1e-5 of their largest entry."""
    rng = np.random.RandomState(ci + co + int(has_prologue) + int(10 * slope))
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    args = (f32(*lead, ci), f32(ci, co) / np.float32(np.sqrt(ci)), f32(co),
            rng.uniform(0.5, 1.5, ci).astype(np.float32), f32(ci) * 0.5)
    cot = (f32(*lead, co), f32(co) * 0.1, f32(co) * 0.01)
    with jax.default_matmul_precision("float32"):
        want, want_grads = _jax_op(slope, has_prologue, want_stats)(args,
                                                                    cot)
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    got = dense_rows_act(*t, slope, has_prologue, want_stats)
    grads = torch.autograd.grad(got, t, [torch.from_numpy(c) for c in cot],
                                allow_unused=True)
    np.testing.assert_allclose(got[0].detach().numpy(), want[0], rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5 * scale)
    if not want_stats:
        assert not np.any(np.asarray(want[1])) and not got[1].any()
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        tol = 1e-5 if i == 0 else 1e-5 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=tol)


def test_dense_rows_act_computes_only_what_is_asked():
    """No gradient for an input that does not ask for one (the input cloud
    of a first layer): dx and the prologue's are None."""
    x = torch.randn(1024, 9)
    w = torch.randn(9, 16, requires_grad=True)
    b = torch.zeros(16, requires_grad=True)
    y, s1, s2 = dense_rows_act(x, w, b, None, None, 0.0, False, True)
    (y.sum() + s1.sum() + s2.sum()).backward()
    assert w.grad is not None and b.grad is not None
    # d(sum y + sum s1 + sum s2)/dy = 2 + 2y, so db = sum over rows
    torch.testing.assert_close(b.grad, (2.0 + 2.0 * y.detach()).sum(0))


def _fused_env(monkeypatch, fused: bool):
    monkeypatch.setenv("PVCNN_TPU_DENSE_BN_FUSED", "auto" if fused else "0")


@pytest.mark.parametrize("out_channels", [[16], [24, 40]])
def test_fused_shared_mlp_matches_jax(monkeypatch, interpret, out_channels):
    """Train mode under PVCNN_TPU_DENSE_BN_FUSED=auto on both sides (the
    flax SharedMLP runs its fused DenseStats path, the Pallas kernel in
    interpret mode): output, every parameter gradient of sum(out * g) and
    the updated running statistics within 1e-4 (the statistics sum 1024
    rows), then the eval output within 1e-5."""
    _fused_env(monkeypatch, True)
    rng = np.random.RandomState(len(out_channels))
    x = rng.randn(2, 512, 6).astype(np.float32)
    g = rng.randn(2, 512, out_channels[-1]).astype(np.float32)
    flax_mod = jnn.SharedMLP(out_channels)
    port = tnn.SharedMLP(6, out_channels)
    entries = ci.shared_mlp_entries("m", "m", len(out_channels))
    v = _move(flax_mod.init(jax.random.PRNGKey(0), x), port, entries, seed=2)

    def loss(params):
        out, mutated = flax_mod.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mutated["batch_stats"])

    with jax.default_matmul_precision("float32"):
        (_, (want, want_stats)), want_grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"])
    port.train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    (got * torch.from_numpy(g)).sum().backward()
    _assert_train_state(port, v, entries, want_grads, want_stats)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = flax_mod.apply({"params": v["params"], "batch_stats": want_stats},
                          x, train=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_shared_mlp_matches_unfused(monkeypatch):
    """Inside the port, the fused train path against the unfused one (both
    compute var = E[y^2] - E[y]^2 or torch's two-pass variance, and their
    relu gates split at t = 0 the same way): output and gradients within
    1e-4, running statistics within 1e-5; a [B, N, C] list input and
    fewer than 1024 rows take the unfused path."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(4, 256, 12).astype(np.float32))
    g = torch.from_numpy(rng.randn(4, 256, 20).astype(np.float32))
    base = tnn.SharedMLP(12, [32, 20])
    results = {}
    for fused in (False, True):
        _fused_env(monkeypatch, fused)
        mlp = tnn.SharedMLP(12, [32, 20])
        mlp.load_state_dict(base.state_dict())
        mlp.train()
        xx = x.clone().requires_grad_()
        out = mlp(xx)
        (out * g).sum().backward()
        grads = [p.grad for p in mlp.parameters()] + [xx.grad]
        results[fused] = (out.detach(), grads, mlp.state_dict())
    (o0, g0, s0), (o1, g1, s1) = results[False], results[True]
    torch.testing.assert_close(o1, o0, rtol=1e-4, atol=1e-4)
    # the dense biases' gradients are 0 up to rounding (BatchNorm removes
    # the mean): every gradient is held to 1e-4 of the largest
    g0, g1 = (torch.cat([g.reshape(-1) for g in gs]) for gs in (g0, g1))
    torch.testing.assert_close(g1, g0, rtol=1e-4,
                               atol=1e-4 * g0.abs().max().item())
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-5, atol=1e-5)

    from pvcnn_tpu_torch.ops import dense_rows

    calls = []
    real = dense_rows._forward_plain
    monkeypatch.setattr(dense_rows, "_forward_plain",
                        lambda *a: calls.append(1) or real(*a))
    _fused_env(monkeypatch, True)
    base.train()
    base(x)
    assert len(calls) == 2
    base(x[:, :200])                    # 800 rows
    base([x[..., :5], x[..., 5:]])      # a list: only the second layer
    assert len(calls) == 3
    base.eval()
    base(x)
    assert len(calls) == 3


@pytest.mark.parametrize("train", [False, True])
def test_dense_bn_relu_matches_flax(train):
    """Linear + BatchNorm + ReLU on per-cloud features [B, C] (the S3DIS
    PVCNN cloud MLP) against flax DenseBNReLU, in eval and train mode
    (running statistics too), within 1e-5."""
    x = np.random.RandomState(3).randn(8, 20).astype(np.float32)
    flax_mod = jnn.DenseBNReLU(16)
    port = tnn.DenseBNReLU(20, 16)
    v = _move(flax_mod.init(jax.random.PRNGKey(0), x), port,
              ci.linear_bn_relu_entries("m", "m"), seed=4)
    port.train(train)
    if train:
        want, mutated = flax_mod.apply(v, x, train=True,
                                       mutable=["batch_stats"])
    else:
        want = flax_mod.apply(v, x, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if train:
        bn = mutated["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(port[1].running_mean.numpy(), bn["mean"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(port[1].running_var.numpy(), bn["var"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(knobs.KNOBS))
def test_knobs_match_the_jax_registry(monkeypatch, name):
    """Each of the port's switches has the JAX package's name, default and
    choices: one environment variable switches both packages, and a value
    outside the choices raises in both."""
    monkeypatch.delenv(name, raising=False)
    assert knobs.get(name) == jknobs.get(name)
    choices, _ = knobs.KNOBS[name]
    for value in choices:
        monkeypatch.setenv(name, value)
        assert knobs.get(name) == jknobs.get(name)
    monkeypatch.setenv(name, "2")
    with pytest.raises(ValueError, match=name):
        knobs.get(name)
    with pytest.raises(ValueError, match=name):
        jknobs.get(name)


def test_bad_knob_raises_at_forward(monkeypatch):
    """Knobs are read at forward time: an invalid value set after the
    module was built raises when a train-mode forward reads it."""
    mlp = tnn.SharedMLP(4, 8).train()
    monkeypatch.setenv("PVCNN_TPU_DENSE_BN_FUSED", "1")
    with pytest.raises(ValueError, match="PVCNN_TPU_DENSE_BN_FUSED"):
        mlp(torch.randn(4, 256, 4))
