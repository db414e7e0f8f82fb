"""PVConv's unfused rows branch (PVCNN_TPU_CONV_BN_FUSED=0): K3 without its
prologue and statistics, then BatchNorm and LeakyReLU as passes of their
own over [B, C, R^3], twice.

Held to three things: the JAX package's own unfused rows branch (its
Pallas conv_rows kernels in interpret mode, which on the CPU only plan at a
power-of-two R with R^2 % 128 == 0: R = 16), the JAX package's NDHWC branch
(what JAX runs on the CPU without interpret mode; the same math), and the
port's fused rows branch. Forward, running statistics and parameter
gradients, in train and eval mode. And PVCNN_TPU_CONV_ROWS=0 still takes
precedence. The helpers and tolerances are tests/test_torch_modules.py's:
1e-4 for the block (conv sums in another order), its gradients within 1e-4
of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import nn as jnn
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu.utils import knobs as jknobs
from pvcnn_tpu_torch import nn as tnn
from pvcnn_tpu_torch.nn import pvconv as tpvconv
from pvcnn_tpu_torch.utils import knobs
from test_torch_modules import _assert_train_state, _close, _move

KNOB = "PVCNN_TPU_CONV_BN_FUSED"


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module, as tests/test_torch_frustum.py
    (the parallel run's workers share the machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_knob_is_the_jax_packages():
    """Name, choices and default of the JAX registry's knob."""
    want = jknobs.KNOBS[KNOB]
    choices, default = knobs.KNOBS[KNOB]
    assert (choices, default) == (want.choices, want.default) == \
        (("auto", "0"), "auto")
    assert KNOB in knobs.__doc__


def _inputs(seed, b, n, cin, cout):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b, n, cin).astype(np.float32)
    coords = (rng.uniform(-1, 1, (b, n, 3)) * [1.0, 0.6, 0.4]).astype(
        np.float32)
    return feats, coords, rng.randn(b, n, cout).astype(np.float32)


def _spy(monkeypatch):
    """Record which voxel branch each port forward takes."""
    taken = []
    for name in ("_rows_unfused", "_voxel_ndhwc"):
        real = getattr(tpvconv.PVConv, name)

        def spy(self, *args, real=real, name=name):
            taken.append(name)
            return real(self, *args)
        monkeypatch.setattr(tpvconv.PVConv, name, spy)
    return taken


@pytest.mark.parametrize("r,cin,cout,with_se,normalize,interpret,train", [
    (16, 4, 8, True, False, True, False),   # JAX: unfused rows, Pallas
    (16, 4, 8, False, True, True, False),
    (8, 4, 16, False, True, False, True),   # JAX: NDHWC branch, XLA
    (8, 16, 16, True, True, False, False),
])
def test_unfused_rows_branch_matches_jax(monkeypatch, r, cin, cout, with_se,
                                         normalize, interpret, train):
    """The port's unfused rows branch against the flax PVConv with
    PVCNN_TPU_CONV_BN_FUSED=0: at R = 16 in interpret mode JAX runs its
    unfused rows branch (eval mode: compiling its training step in
    interpret mode took 20 s alone and 100 s in the suite's parallel run),
    at R = 8 its NDHWC one, the same math. Train mode: output, running
    statistics and every parameter gradient of sum(out * g); eval mode:
    the output."""
    monkeypatch.setenv(KNOB, "0")
    taken = _spy(monkeypatch)
    feats, coords, g = _inputs(5 * r + cin, 2, 128, cin, cout)
    kw = dict(with_se=with_se, normalize=normalize,
              eps=1e-4 if normalize else 0.0)
    flax_mod = jnn.PVConv(cout, 3, r, **kw)
    port = tnn.PVConv(cin, cout, 3, r, **kw)
    entries = ci.pvconv_entries("m", "m", with_se)
    # both JAX branches hold the same parameters: init on the NDHWC one
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "0")
    v = _move(jax.jit(flax_mod.init)(jax.random.PRNGKey(0), feats, coords),
              port, entries, seed=r + cin)
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", str(int(interpret)))
    if not train:
        with jax.default_matmul_precision("float32"):
            want, _ = jax.jit(lambda v: flax_mod.apply(
                v, feats, coords, train=False))(v)
        with torch.no_grad():
            got, _ = port(torch.from_numpy(feats), torch.from_numpy(coords))
        _close(got, want, tol=1e-4)
        assert taken == ["_rows_unfused"]
        return

    def loss(params):
        (out, _), mutated = flax_mod.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, feats,
            coords, train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), (out, mutated["batch_stats"])

    with jax.default_matmul_precision("float32"):
        (_, (want, want_stats)), want_grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v["params"])
    port.train()
    got, _ = port(torch.from_numpy(feats), torch.from_numpy(coords))
    _close(got, want, tol=1e-4)
    (got * torch.from_numpy(g)).sum().backward()
    _assert_train_state(port, v, entries, want_grads, want_stats)
    assert taken == ["_rows_unfused"]


def _run(port, feats, coords, g, train):
    """-> (output, running statistics, parameter gradients) of one pass."""
    port.zero_grad(set_to_none=True)
    port.train(train)
    out, _ = port(feats, coords)
    if train:
        (out * g).sum().backward()
    stats = [b.clone() for n, b in port.named_buffers()
             if "running" in n]
    grads = [p.grad.clone() for p in port.parameters()] if train else []
    return out.detach(), stats, grads


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("r,with_se", [(12, True), (8, False)])
def test_unfused_rows_branch_matches_fused(monkeypatch, train, r, with_se):
    """The unfused and the fused rows branch compute the same function on
    the same weights: output and running statistics within 1e-5, the
    parameter gradients within 1e-5 of their largest entry (the convs'
    biases, which the BatchNorms cancel, get gradients of rounding size
    only). R = 12 is FrustumPVCNNE's grid."""
    feats, coords, g = (torch.from_numpy(a) for a in _inputs(r, 2, 160, 4,
                                                             16))
    port = tnn.PVConv(4, 16, 3, r, with_se=with_se)
    for bn in (port.voxel_layers[1], port.voxel_layers[4]):
        bn.running_mean.uniform_(-0.2, 0.2)
        bn.running_var.uniform_(0.6, 1.4)
    start = {k: t.clone() for k, t in port.state_dict().items()}
    monkeypatch.setenv(KNOB, "auto")
    fused = _run(port, feats, coords, g, train)
    port.load_state_dict(start)
    monkeypatch.setenv(KNOB, "0")
    taken = _spy(monkeypatch)
    unfused = _run(port, feats, coords, g, train)
    assert taken == ["_rows_unfused"]
    for a, b in zip([unfused[0]] + unfused[1], [fused[0]] + fused[1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if train:
        got, want = (torch.cat([t.reshape(-1) for t in run[2]])
                     for run in (unfused, fused))
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * want.abs().max().item())


def test_conv_rows_0_takes_precedence(monkeypatch):
    """With PVCNN_TPU_CONV_ROWS=0 the voxel branch is the NDHWC one whatever
    PVCNN_TPU_CONV_BN_FUSED says, as in the JAX package, where the knob
    acts only on the rows branch."""
    feats, coords, g = (torch.from_numpy(a) for a in _inputs(3, 2, 96, 4, 8))
    port = tnn.PVConv(4, 8, 3, 8)
    start = {k: t.clone() for k, t in port.state_dict().items()}
    monkeypatch.setenv("PVCNN_TPU_CONV_ROWS", "0")
    taken = _spy(monkeypatch)
    runs = []
    for value in ("0", "auto"):
        monkeypatch.setenv(KNOB, value)
        port.load_state_dict(start)
        runs.append(_run(port, feats, coords, g, True))
    assert taken == ["_voxel_ndhwc", "_voxel_ndhwc"]
    (out0, stats0, grads0), (out1, stats1, grads1) = runs
    assert torch.equal(out0, out1)
    assert all(torch.equal(a, b) for a, b in zip(stats0 + grads0,
                                                 stats1 + grads1))
