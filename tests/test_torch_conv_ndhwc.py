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


def _k11_cases():
    """K11's (B, Ci, Co, R) on the S3DIS PVCNN and FrustumPVCNNE opt-in
    steps (chip_smoke.py's CALLS3_ON and CALLS_PVCNNE_ON, B = 32: Ci = 4,
    R = 12) and five edge shapes: Ci = 1 and 257, Co = 1 and 130, R = 1
    and 5 (zero-filled segment ends), one cloud."""
    import chip_smoke

    cases = sorted({(chip_smoke.B,) + c
                    for calls in (chip_smoke.CALLS3_ON,
                                  chip_smoke.CALLS_PVCNNE_ON)
                    for (k, c) in calls if k == "conv3d_ndhwc_wgrad"})
    return cases + [(1, 1, 130, 5), (3, 257, 1, 1), (1, 257, 130, 16),
                    (3, 1, 1, 32), (1, 64, 64, 5)]


@pytest.mark.parametrize("b,ci,co,r", _k11_cases())
def test_ndhwc_wgrad_plan(b, ci, co, r):
    """K11's launch (K4's plan on a card of 132 SMs, channel-last copies):
    the splits' runs of slices, walked segment by segment as the kernel's
    cursors walk them, cover each of the B * R^3 voxels once, no run empty;
    in z-slots (Ci and cb multiples of 4), each thread's copies of x
    (channel quad w % lanes at the z-slots w / lanes + i * step of the 9
    rows) cover a segment's slots once, else x goes to K4's rows; the
    partial buffer [splits, Co, Ci, 27] only where it splits, under 28 MiB
    at the opt-in step's cases; a split grid within two waves of the
    blocks the card holds at once (12 warps an SM), give or take one
    round of row and column tiles."""
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

    tn, segs = plan.cols // 8, 32 // seg
    threads = 3 * plan.cb * tn
    assert threads <= 192 and threads % segs == 0
    per_seg = threads // segs
    quads = conv3d._ndhwc_layout(ci, plan) == "last_slots"
    assert quads == (ci % 4 == 0 and plan.cb % 4 == 0)
    assert plan.cb <= 192 // (3 * tn)             # a z-slot holds cb floats
    if quads:
        lanes, step = plan.cb // 4, 12 * tn // segs
        assert step * lanes == per_seg
        slots = np.zeros((9 * (seg + 2), lanes), dtype=np.int64)
        for w in range(per_seg):
            np.add.at(slots, (np.arange(w // lanes, 9 * (seg + 2), step),
                              w % lanes), 1)
        assert (slots == 1).all()

    if plan.splits > 1:
        assert plan.partial_bytes == 4 * plan.splits * 27 * ci * co
    else:
        assert plan.partial_bytes == 0
    resident = max(1, 12 // -(-threads // 32)) * 132
    assert plan.splits == 1 or (plan.tiles * plan.splits
                                < 2 * resident + plan.tiles)
    if b == 32:
        assert plan.partial_bytes < 28 * 2 ** 20
