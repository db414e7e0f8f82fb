"""The port's bf16 modes of the point-voxel ops against the JAX package's
Pallas kernels run in bf16, in interpret mode (as tests/test_conv_rows.py
runs them), on the same numpy-seeded inputs rounded to bf16 once.

On the CPU the port runs each kernel's plain version on the bf16 operands
widened to f32, rounding where the bf16 kernels round. JAX runs at fp32
matmul precision, so its one-hot products of bf16 values are exact, as
the port's are.

Tolerance: two bf16 roundings of the output's scale, atol = 2^-7 *
max|want| (one rounding to bf16 moves a value by at most 2^-8 of its
magnitude). The two sides sum the same bf16 products in f32 in other
orders, so a rounded output may land one bf16 ulp apart. The conv's f32
statistics are held to 2^-7 of their sum of |terms|; its f32 bias, scale
and shift gradients to 2^-7 of their largest entry.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.ops.pallas.conv_rows import conv3d_rows_act as j_conv_act
from pvcnn_tpu.ops.pallas.conv_rows import conv_rows_supported
from pvcnn_tpu_torch import kernels, ops
from pvcnn_tpu_torch.ops import conv3d, devoxelize, gather_utils, voxelize
from test_torch_ops import _coords

BF16 = 2.0 ** -7          # two bf16 roundings, relative to the scale


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "1")


def _bf16(a):
    """numpy f32 -> (the same values rounded to bf16 as numpy f32, a torch
    bf16 tensor, a jax bf16 array)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
    return t.float().numpy(), t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    """torch or jax array -> numpy f32."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, scale=None):
    """got within two bf16 roundings of want's scale (max|want| unless
    given)."""
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16 * scale)


def _conv_inputs(ci, co, seed):
    r, b = 16, 2
    rng = np.random.RandomState(seed)
    x = rng.randn(b, ci, r ** 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32)   # JAX layout
    bias = rng.randn(co).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, ci).astype(np.float32)
    shift = rng.randn(ci).astype(np.float32)
    gy = rng.randn(b, co, r ** 3).astype(np.float32)
    gs1 = (0.1 * rng.randn(co)).astype(np.float32)
    gs2 = (0.01 * rng.randn(co)).astype(np.float32)
    return r, x, w, bias, scale, shift, gy, gs1, gs2


@pytest.mark.parametrize("ci,co,has_prologue,want_stats", [
    (6, 16, False, True),        # conv0 of the first block: statistics
    (16, 16, True, True),        # conv1: prologue and statistics
    (16, 32, True, False),
    (32, 16, False, False),
])
def test_conv3d_rows_act_bf16(ci, co, has_prologue, want_stats):
    """The fused conv in bf16: y against JAX's bf16 Pallas forward, the
    f32 statistics, and the VJP (dx, dW bf16; dbias, dscale, dshift f32)
    with nonzero cotangents on y, s1 and s2."""
    r, x, w, bias, scale, shift, gy, gs1, gs2 = _conv_inputs(
        ci, co, 10 * ci + co + 2 * has_prologue + want_stats)
    assert conv_rows_supported(2, r, ci, co, 3, jnp.bfloat16)
    _, tx, jx = _bf16(x)
    _, tw, jw = _bf16(w)
    _, tgy, jgy = _bf16(gy)
    with jax.default_matmul_precision("float32"):
        (jy, js1, js2), vjp = jax.vjp(
            lambda xx, ww, *a: j_conv_act(xx, ww, *a, r, has_prologue,
                                          want_stats),
            jx, jw, *map(jnp.asarray, (bias, scale, shift)))
        want = vjp((jgy, jnp.asarray(gs1), jnp.asarray(gs2)))
    assert jy.dtype == jnp.bfloat16
    tw = tw.permute(4, 3, 0, 1, 2).contiguous()                 # torch layout
    args = [tx.requires_grad_(), tw.requires_grad_()] + [
        torch.from_numpy(a).requires_grad_() for a in (bias, scale, shift)]
    y, s1, s2 = ops.conv3d_rows_act(*args, r, has_prologue, want_stats)
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    _close(y, jy)
    if want_stats:
        yf = _f32(jy)
        _close(s1, js1, np.abs(yf).sum(axis=(0, 2)).max())
        _close(s2, js2, (yf * yf).sum(axis=(0, 2)).max())
    else:
        assert not s1.any() and not s2.any()
    got = torch.autograd.grad((y, s1, s2), args,
                              (tgy, torch.from_numpy(gs1),
                               torch.from_numpy(gs2)), allow_unused=True)
    assert got[0].dtype == got[1].dtype == torch.bfloat16
    assert {g.dtype for g in got[2:] if g is not None} == {torch.float32}
    want = list(want)
    want[1] = _f32(want[1]).transpose(4, 3, 0, 1, 2)
    for g_got, g_want in zip(got[:3], want[:3]):
        _close(g_got, g_want)
    if has_prologue:
        _close(got[3], want[3])
        _close(got[4], want[4])


@pytest.mark.parametrize("c,r", [(16, 8), (32, 16)])
def test_scatter_mean_bf16(c, r):
    """The channel-major scatter-mean of bf16 values against JAX's bf16
    avg_voxelize (f32 sums, one rounding), and its VJP (the cotangent over
    the count rounded to bf16)."""
    rng = np.random.RandomState(c + r)
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
    got = ops.scatter_mean(tf, flat, r ** 3, channels_first=True)
    assert got.dtype == torch.bfloat16
    _close(got, _f32(want).reshape(b, r ** 3, c).transpose(0, 2, 1))
    (got_g,) = torch.autograd.grad(
        got, tf, tg.reshape(b, r ** 3, c).transpose(1, 2))
    assert got_g.dtype == torch.bfloat16
    _close(got_g, want_g)


@pytest.mark.parametrize("c,r", [(16, 8), (32, 16)])
def test_devoxelize_rows_bf16(c, r):
    """The trilinear gather from a bf16 channel-major grid (f32 weights and
    sum, one rounding) against JAX's bf16 trilinear_devoxelize, and its
    VJP (weights and terms rounded to bf16, f32 sums), collapsed corners
    and the last plane included; no gradient reaches the coordinates."""
    rng = np.random.RandomState(3 * c + r)
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
    rows = tgrid.reshape(b, r ** 3, c).transpose(1, 2).contiguous()
    rows.requires_grad_()
    tn = torch.from_numpy(norm).requires_grad_()
    got = ops.devoxelize_rows(rows, tn, r, channels_first=True)
    assert got.dtype == torch.bfloat16
    _close(got, want)
    got_g, got_n = torch.autograd.grad(got, (rows, tn), tg,
                                       allow_unused=True)
    assert got_n is None and got_g.dtype == torch.bfloat16
    _close(got_g.transpose(1, 2).reshape(b, r, r, r, c), want_g)


def test_leaky_affine_bf16():
    """The last BatchNorm and LeakyReLU of a PVConv: f32 on the bf16 grid,
    rounded to bf16 (pvcnn_tpu/nn/pvconv.py:142-145), and its gradient."""
    rng = np.random.RandomState(4)
    _, tx, jx = _bf16(rng.randn(2, 16, 512).astype(np.float32))
    sc = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    sh = rng.randn(16).astype(np.float32)
    _, tg, jg = _bf16(rng.randn(2, 16, 512).astype(np.float32))

    def j_act(x, s, t):
        u = x.astype(jnp.float32) * s[:, None] + t[:, None]
        return jnp.where(u > 0, u, 0.1 * u).astype(x.dtype)

    want, vjp = jax.vjp(j_act, jx, jnp.asarray(sc), jnp.asarray(sh))
    want_g = vjp(jg)
    args = [tx.requires_grad_(), torch.from_numpy(sc).requires_grad_(),
            torch.from_numpy(sh).requires_grad_()]
    got = ops.leaky_affine(*args)
    assert got.dtype == torch.bfloat16
    _close(got, want)
    got_g = torch.autograd.grad(got, args, tg)
    assert got_g[0].dtype == torch.bfloat16
    for g_got, g_want in zip(got_g, want_g):
        _close(g_got, g_want)


@pytest.mark.parametrize("b,ci,co,r", [
    (32, 6, 64, 32), (32, 64, 64, 32), (32, 64, 128, 16),
    (32, 128, 128, 16), (64, 6, 16, 32), (64, 16, 16, 32), (64, 16, 32, 16),
    (64, 32, 32, 16), (2, 16, 16, 8), (1, 1, 1, 1), (3, 5, 33, 5),
    (1, 20, 70, 12), (2, 48, 130, 4)])
def test_wgrad_bf16_plan(b, ci, co, r):
    """K4's bf16 plan on a card of 132 SMs: the columns (27 x Cp) covered
    by whole column blocks, runs of chunks that cover the B * tiles chunks
    once, none empty, and at most one wave of one block an SM where the
    chunks allow."""
    plan = conv3d._wgrad_bf16_plan(b, ci, co, r, 132)
    cp = -(-ci // 16) * 16                   # Ci rounded up to 16
    assert cp % plan.cols == 0
    taps = 27 if plan.cols == 16 else 9      # taps a column block
    assert plan.col_blocks * plan.cols * taps == 27 * cp
    assert plan.co_tiles * 64 >= co > (plan.co_tiles - 1) * 64
    tiles = -(-r // 2) * (-(-r // 8)) ** 2    # 2 x 8 x 8 voxels (x, y, z)
    assert plan.chunks == b * tiles
    runs = [range(s * plan.per_split,
                  min(plan.chunks, (s + 1) * plan.per_split))
            for s in range(plan.splits)]
    assert all(len(run) > 0 for run in runs)
    assert sorted(k for run in runs for k in run) == list(range(plan.chunks))
    blocks = plan.splits * plan.col_blocks * plan.co_tiles
    assert blocks <= max(132, plan.col_blocks * plan.co_tiles)


@pytest.mark.parametrize("r", [1, 4, 5, 8, 12, 16, 32])
def test_bf16_tiles(r):
    """K3's statistics slots per cloud (and K4's chunks): one per 2 x 8 x 8
    tile (x, y, z) that covers the grid, ragged tiles included."""
    origins = {(x // 2, y // 8, z // 8) for x, y, z in
               itertools.product(range(r), repeat=3)}
    assert conv3d._bf16_tiles(r) == len(origins)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _conv_backward(needs):
    ctx = types.SimpleNamespace(
        saved_tensors=(_meta(2, 16, 512), _meta(16, 16, 3, 3, 3), None, None,
                       None),
        needs_input_grad=needs, resolution=8, has_prologue=False,
        want_stats=False)
    return conv3d._Conv3dRowsAct.backward(ctx, _meta(2, 16, 512),
                                          _meta(16, dtype=torch.float32),
                                          _meta(16, dtype=torch.float32))


BF16_CALLS = {
    "avg_voxelize_bf16": (voxelize, "_scatter_mean_plain", lambda: voxelize
                          .scatter_mean(_meta(2, 64, 16),
                                        _meta(2, 64, dtype=torch.int32), 512,
                                        channels_first=True)),
    "trilinear_devoxelize_bf16": (
        devoxelize, "_devoxelize_plain", lambda: devoxelize.devoxelize_rows(
            _meta(2, 16, 512), _meta(2, 64, 3, dtype=torch.float32), 8,
            channels_first=True)),
    "conv3d_fwd_bf16": (conv3d, "_forward_plain", lambda:
                        conv3d.conv3d_rows_act(
                            _meta(2, 16, 512), _meta(16, 16, 3, 3, 3),
                            _meta(16, dtype=torch.float32), None, None, 8,
                            False, True)),
    "conv3d_dgrad_bf16": (conv3d, "_dgrad_plain", lambda: _conv_backward(
        (True, False, False, False, False))),
    "conv3d_wgrad_bf16": (conv3d, "_wgrad_plain", lambda: _conv_backward(
        (False, True, False, False, False))),
    "devoxelize_bwd_bf16": (devoxelize, "_devoxelize_bwd_plain", lambda:
                            devoxelize._DevoxelizeRows.backward(
                                types.SimpleNamespace(
                                    saved_tensors=(_meta(
                                        2, 64, 3, dtype=torch.float32),),
                                    needs_input_grad=(True, False, False,
                                                      False),
                                    resolution=8, channels_first=True),
                                _meta(2, 64, 16))),
    # the take_rows backward dispatches on the bf16 cotangent's device
    "scatter_sum_bf16": (voxelize, "_scatter_sum_plain", lambda:
                         gather_utils._TakeRows.backward(
                             types.SimpleNamespace(
                                 saved_tensors=(_meta(
                                     2, 40, dtype=torch.int32),),
                                 needs_input_grad=(True, False),
                                 num_rows=16),
                             _meta(2, 40, 8))),
}


@pytest.mark.parametrize("name", sorted(BF16_CALLS))
def test_bf16_tensors_off_the_cpu_never_take_the_plain_version(
        monkeypatch, name):
    """A bf16 tensor that is not on the CPU goes to its kernel's wrapper,
    which raises here (no card): no plain version, no launch counted."""
    assert name in kernels.KERNELS
    module, plain, call = BF16_CALLS[name]

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
