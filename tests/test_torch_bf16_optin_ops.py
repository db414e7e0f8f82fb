"""The bf16 modes of the opt-in path's ops against the JAX package on the
same numpy-seeded inputs rounded to bf16 once: the fused dense layer (K9
forward and dgrad, K10) against JAX's Pallas dense_rows_act in interpret
mode, the NDHWC conv's weight gradient (K11) against JAX's conv3d_same
VJP (its Pallas wgrad in interpret mode, and its XLA formulation), and
the channel-last scatter-mean, gather and gather backward (K1, K2, K5)
against JAX's avg_voxelize / trilinear_devoxelize on channel-last bf16
grids.

On the CPU the port runs each kernel's plain version on the bf16
operands widened to f32, rounding where the bf16 kernels round. JAX runs
at fp32 matmul precision, so the products of bf16 values are exact on
both sides.

Tolerance: two bf16 roundings of each output's scale, atol = 2^-7 *
max|want| (the two sides sum the same bf16 products in f32 in other
orders, so a rounded output may land one bf16 ulp apart; two where a
cotangent was rounded once more before its product, as the dense
layer's folded cotangent and the conv's dY are on both sides). The f32
statistics are held to 2^-7 of their sum of |terms|, the f32 gradients
(dW of the dense layer, d(bias), dscale, dshift) to 2^-7 of their
largest entry.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.nn.conv3d import conv3d_same as j_conv3d_same
from pvcnn_tpu.ops.pallas.conv_wgrad import conv3d_wgrad_plan
from pvcnn_tpu.ops.pallas.dense_rows import dense_rows_act as j_dense_act
from pvcnn_tpu.ops.pallas.dense_rows import dense_rows_plan as j_dense_plan
from pvcnn_tpu_torch import kernels, ops
from pvcnn_tpu_torch.ops import conv3d, dense_rows
from test_torch_bf16_ops import _bf16, _close, _f32
from test_torch_ops import _coords


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "1")


def _dense_inputs(rows, ci, co, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, ci).astype(np.float32)
    w = (rng.randn(ci, co) / np.sqrt(ci)).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, ci).astype(np.float32)
    shift = rng.randn(ci).astype(np.float32)
    gy = rng.randn(rows, co).astype(np.float32)
    gs1 = (0.1 * rng.randn(co)).astype(np.float32)
    gs2 = (0.01 * rng.randn(co)).astype(np.float32)
    return x, w, bias, scale, shift, gy, gs1, gs2


@pytest.mark.parametrize("ci,co,has_prologue", [
    (9, 16, False),            # the first point branch: the cloud's columns
    (16, 32, False),
    (32, 16, True),            # the prologue (the JAX op's, unused by
    (24, 40, True),            # DenseStats)
])
def test_dense_rows_act_bf16(ci, co, has_prologue):
    """K9 / K10's bf16 plain version against JAX's Pallas dense_rows_act
    on bf16 x at 1,024 rows: y bf16, the f32 statistics, and the VJP with
    nonzero cotangents on y, s1 and s2 (dx bf16; dW f32, the weight's
    dtype, not rounded; d(bias), dscale, dshift f32)."""
    rows, slope = 1024, 0.1
    x, w, bias, scale, shift, gy, gs1, gs2 = _dense_inputs(
        rows, ci, co, 7 * ci + co + has_prologue)
    assert j_dense_plan(rows, ci, co, jnp.bfloat16) is not None
    _, tx, jx = _bf16(x)
    _, tgy, jgy = _bf16(gy)
    with jax.default_matmul_precision("float32"):
        (jy, js1, js2), vjp = jax.vjp(
            lambda xx, *a: j_dense_act(xx, *a, slope, has_prologue, True),
            jx, *map(jnp.asarray, (w, bias, scale, shift)))
        want = vjp((jgy, jnp.asarray(gs1), jnp.asarray(gs2)))
    assert jy.dtype == jnp.bfloat16 and want[1].dtype == jnp.float32
    args = [tx.requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in (w, bias, scale,
                                                       shift)]
    y, s1, s2 = ops.dense_rows_act(*args, slope, has_prologue, True)
    assert y.dtype == torch.bfloat16 and s1.dtype == s2.dtype == torch.float32
    _close(y, jy)
    yf = _f32(jy)
    _close(s1, js1, np.abs(yf).sum(axis=0).max())
    _close(s2, js2, (yf * yf).sum(axis=0).max())
    got = torch.autograd.grad((y, s1, s2), args,
                              (tgy, torch.from_numpy(gs1),
                               torch.from_numpy(gs2)), allow_unused=True)
    assert got[0].dtype == torch.bfloat16
    assert {g.dtype for g in got[1:] if g is not None} == {torch.float32}
    for i in range(3):
        _close(got[i], want[i])
    if has_prologue:
        _close(got[3], want[3])
        _close(got[4], want[4])


def test_dense_rows_act_bf16_rounds_the_weight_only_for_the_product():
    """The weight is cast to bf16 for the product (JAX's w.astype(x.dtype))
    and its gradient comes back f32, unrounded: the port's dW equals the
    plain f32 product a(x)^T ge2 of the bf16 operands, whatever the f32
    weight's low bits."""
    rows, ci, co = 1024, 16, 8
    x, w, bias, _, _, gy, _, _ = _dense_inputs(rows, ci, co, 3)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).requires_grad_()
    tgy = torch.from_numpy(gy).to(torch.bfloat16)
    y, _, _ = ops.dense_rows_act(tx, tw, torch.from_numpy(bias), None, None,
                                 0.0, False, False)
    y.backward(tgy)
    assert torch.equal(tw.grad, tx.float().t() @ tgy.float())
    assert torch.equal(y, (tx.float() @ tw.detach().to(torch.bfloat16)
                           .float() + torch.from_numpy(bias))
                       .to(torch.bfloat16))


def _ndhwc_inputs(ci, co, r, seed):
    rng = np.random.RandomState(seed)
    b = 2
    x = rng.randn(b, r, r, r, ci).astype(np.float32)
    w = (rng.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32)  # JAX layout
    g = rng.randn(b, r, r, r, co).astype(np.float32)
    return x, w, g


@pytest.mark.parametrize("route", ["pallas", "xla"])
@pytest.mark.parametrize("ci,co,r", [(9, 16, 8), (16, 32, 4), (32, 16, 8)])
def test_conv3d_same_bf16(ci, co, r, route, monkeypatch):
    """conv3d_same on bf16 x and a bf16 weight (the NDHWC branch's conv
    under PVCNN_TPU_CUSTOM_CONV_WGRAD=1) against JAX's: y and dx (XLA convs
    in bf16; the port's f32 convs of the widened operands, rounded) and
    dW, the f32 sums rounded to bf16 once (dw.astype(kernel.dtype)),
    with JAX's weight gradient by its Pallas kernel (interpret mode) or by
    its XLA formulation (PVCNN_TPU_XLA_CONV_WGRAD_ONLY=1): one function,
    which the port computes by K11's bf16 plain version either way."""
    if route == "xla":
        monkeypatch.setenv("PVCNN_TPU_XLA_CONV_WGRAD_ONLY", "1")
    else:
        assert conv3d_wgrad_plan(2, r, r, r, ci, co, 3,
                                 jnp.bfloat16) is not None
    x, w, g = _ndhwc_inputs(ci, co, r, 5 * ci + co + r)
    _, tx, jx = _bf16(x)
    _, tw, jw = _bf16(w)
    _, tg, jg = _bf16(g)
    with jax.default_matmul_precision("float32"):
        jy, vjp = jax.vjp(j_conv3d_same, jx, jw)
        jdx, jdw = vjp(jg)
    assert jdw.dtype == jnp.bfloat16
    tw = tw.permute(4, 3, 0, 1, 2).contiguous().requires_grad_()
    tx.requires_grad_()
    y = conv3d.conv3d_same(tx, tw)
    assert y.dtype == torch.bfloat16
    _close(y, jy)
    dx, dw = torch.autograd.grad(y, (tx, tw), tg)
    assert dx.dtype == dw.dtype == torch.bfloat16
    _close(dx, jdx)
    _close(dw, _f32(jdw).transpose(4, 3, 0, 1, 2))


@pytest.mark.parametrize("c,r", [(16, 8), (9, 4)])
def test_scatter_mean_channel_last_bf16(c, r):
    """The channel-last scatter-mean of bf16 values (the NDHWC branch's
    voxelization) against JAX's bf16 avg_voxelize (f32 sums, one
    rounding), and its VJP."""
    rng = np.random.RandomState(2 * c + r)
    b, n = 2, 512
    _, tf, jf = _bf16(rng.randn(b, n, c).astype(np.float32))
    vox, _ = jops.normalize_coords(jnp.asarray(_coords(rng, b, n)), r,
                                   normalize=False)
    vox = np.array(vox)
    vox[:, :200] = vox[:, :1]            # one bin of 200 points
    _, tg, jg = _bf16(rng.randn(b, r, r, r, c).astype(np.float32))
    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(lambda f: jops.avg_voxelize(f, jnp.asarray(vox),
                                                        r), jf)
        (want_g,) = vjp(jg)
    assert want.dtype == jnp.bfloat16
    flat = ops.flat_voxel_index(torch.from_numpy(vox), r)
    tf.requires_grad_()
    got = ops.scatter_mean(tf, flat, r ** 3, channels_first=False)
    assert got.dtype == torch.bfloat16 and got.shape == (b, r ** 3, c)
    _close(got, _f32(want).reshape(b, r ** 3, c))
    (got_g,) = torch.autograd.grad(got, tf, tg.reshape(b, r ** 3, c))
    assert got_g.dtype == torch.bfloat16
    _close(got_g, want_g)


def _devoxelize_case(c, r):
    """A bf16 channel-last grid, coordinates with collapsed corners and
    points on the last plane, a bf16 cotangent; JAX's gather and VJP."""
    rng = np.random.RandomState(5 * c + r)
    b, n = 2, 512
    _, tgrid, jgrid = _bf16(rng.randn(b, r, r, r, c).astype(np.float32))
    _, norm = jops.normalize_coords(jnp.asarray(_coords(rng, b, n)), r,
                                    normalize=True)
    norm = np.asarray(norm).copy()
    norm[:, :8] = np.floor(norm[:, :8])
    norm[:, 8:12, 0] = r - 1
    _, tg, jg = _bf16(rng.randn(b, n, c).astype(np.float32))
    with jax.default_matmul_precision("float32"):
        want, vjp = jax.vjp(lambda gr: jops.trilinear_devoxelize(
            gr, jnp.asarray(norm), r), jgrid)
        (want_g,) = vjp(jg)
    assert want.dtype == want_g.dtype == jnp.bfloat16
    rows = tgrid.reshape(b, r ** 3, c).clone().requires_grad_()
    got = ops.devoxelize_rows(rows, torch.from_numpy(norm), r,
                              channels_first=False)
    assert got.dtype == torch.bfloat16
    (got_g,) = torch.autograd.grad(got, rows, tg)
    assert got_g.dtype == torch.bfloat16
    return (got, want), (got_g.reshape(b, r, r, r, c), want_g), tg, norm


@pytest.mark.parametrize("c,r", [(16, 8), (9, 4)])
def test_devoxelize_channel_last_bf16(c, r):
    """The trilinear gather from a bf16 channel-last grid against JAX's
    bf16 trilinear_devoxelize, and its VJP. JAX's backward of a bf16
    cotangent leaves its sorted Pallas scatter at depth 0
    (pvcnn_tpu/ops/devoxelize.py:366-373); at C <= 64 the bf16 terms
    w8.astype(g.dtype) * g go to its corner-packed Pallas scatter, f32 sums
    rounded once, as the port's K5 sums them."""
    fwd, bwd, _, _ = _devoxelize_case(c, r)
    _close(*fwd)
    _close(*bwd)


def test_devoxelize_channel_last_bf16_xla_fallback():
    """At C = 72 over R^3 = 64 bins no Pallas scatter of JAX's plans the
    backward: _scatter_sum (pvcnn_tpu/ops/voxelize.py:66) ends in XLA's
    segment_sum on the bf16 terms, which adds them in bf16, rounding every
    partial sum. The port sums the same bf16 terms in f32 and rounds once:
    its grid gradient lies within one bf16 rounding (2^-8) of the fp64
    sum of the terms, and JAX's within its running sum's roundings, each
    2^-8 of at most the bin's sum of |terms|, one a term. The forward is
    held as at C <= 64."""
    from pvcnn_tpu_torch.ops import devoxelize

    c, r = 72, 4
    fwd, (got, want), tg, norm = _devoxelize_case(c, r)
    _close(*fwd)
    b, n = tg.shape[:2]
    idx8, w8 = devoxelize._corners(torch.from_numpy(norm), r)
    exact = torch.zeros(b, r ** 3, c, dtype=torch.float64)
    mag, terms = torch.zeros_like(exact), torch.zeros(b, r ** 3, 1)
    for k in range(8):
        # JAX's term: the weight rounded to bf16, the product rounded
        term = (w8[..., k, None].to(torch.bfloat16) * tg).double()
        at = idx8[..., k, None].expand(-1, -1, c)
        exact.scatter_add_(1, at, term)
        mag.scatter_add_(1, at, term.abs())
        terms.scatter_add_(1, idx8[..., k, None],
                           (w8[..., k, None] > 0).float())
    exact, mag = (t.reshape(b, r, r, r, c).numpy() for t in (exact, mag))
    terms = terms.reshape(b, r, r, r, 1).numpy()
    port, jx = _f32(got), _f32(want)
    assert (np.abs(port - exact) <= 2 ** -8 * np.abs(exact)
            + 1e-6 * mag).all()
    assert (np.abs(jx - exact) <= 2 ** -8 * terms * mag + 1e-6 * mag).all()
    # the difference that remains: JAX's bf16 running sums, beyond the
    # port's one rounding on some bins
    assert np.abs(jx - exact).max() > 2 * np.abs(port - exact).max()

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _dense_backward(needs):
    ctx = types.SimpleNamespace(
        saved_tensors=(_meta(2, 512, 9), _meta(9, 16, dtype=torch.float32),
                       None, None, None),
        needs_input_grad=needs, slope=0.0, has_prologue=False,
        want_stats=False)
    return dense_rows._DenseRowsAct.backward(
        ctx, _meta(2, 512, 16), _meta(16, dtype=torch.float32),
        _meta(16, dtype=torch.float32))


OPT_IN_BF16_CALLS = {
    "dense_rows_fwd_bf16": (dense_rows, "_forward_plain", lambda:
                            dense_rows.dense_rows_act(
                                _meta(2, 512, 9),
                                _meta(9, 16, dtype=torch.float32),
                                _meta(16, dtype=torch.float32), None, None,
                                0.0, False, True)),
    "dense_rows_dgrad_bf16": (dense_rows, "_dgrad_plain",
                              lambda: _dense_backward(
                                  (True, False, False, False, False))),
    "dense_rows_wgrad_bf16": (dense_rows, "_wgrad_plain",
                              lambda: _dense_backward(
                                  (False, True, True, False, False))),
    "conv3d_ndhwc_wgrad_bf16": (conv3d, "_ndhwc_wgrad_plain", lambda:
                                conv3d._Conv3dSame.backward(
                                    types.SimpleNamespace(
                                        saved_tensors=(
                                            _meta(2, 8, 8, 8, 6),
                                            _meta(16, 6, 3, 3, 3)),
                                        needs_input_grad=(False, True)),
                                    _meta(2, 8, 8, 8, 16))),
}


@pytest.mark.parametrize("name", sorted(OPT_IN_BF16_CALLS))
def test_bf16_tensors_off_the_cpu_never_take_the_plain_version(
        monkeypatch, name):
    """A bf16 tensor that is not on the CPU goes to its kernel's wrapper,
    which raises here (no card): no plain version, no launch counted."""
    assert name in kernels.KERNELS
    module, plain, call = OPT_IN_BF16_CALLS[name]

    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached by a non-CPU tensor")

    def broken_loader():
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(module, plain, refuse)
    monkeypatch.setattr(kernels, "library", broken_loader)
    before = kernels.launch_counts()
    with pytest.raises((ValueError, RuntimeError)):
        call()
    assert kernels.launch_counts() == before
