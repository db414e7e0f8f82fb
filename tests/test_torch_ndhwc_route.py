"""The route of K11's bf16 mode (pvcnn_tpu_torch/ops/conv3d.py:
_ndhwc_wgrad_cuda_bf16) on the CPU: which operands its kernel reads in
place by its 5-d tensor maps and which the channel-last staging pass
copies first, and what it hands the launcher. No kernel runs: the launcher,
the staging pass, the stream and the SM count are stand-ins that record
their calls."""

import contextlib

import pytest
import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops import conv3d


def _grid(b, r, c, offset=0):
    n = b * r ** 3 * c
    base = torch.zeros(n + 16, dtype=torch.bfloat16)
    start = (-base.data_ptr() // 2) % 8 + offset      # aligned, then offset
    return base[start:start + n].view(b, r, r, r, c)


@pytest.fixture
def recorded(monkeypatch):
    calls = {"staged": [], "launch": []}

    def stage(t):
        calls["staged"].append(t.shape[-1])
        return torch.zeros((t.shape[0], -(-t.shape[-1] // 16) * 2,
                            t.shape[1] ** 3, 8), dtype=torch.bfloat16)

    monkeypatch.setattr(conv3d, "_stage_last_bf16", stage)
    monkeypatch.setattr(conv3d, "_sm_count", lambda index: 132)
    monkeypatch.setattr(kernels, "launch_on",
                        lambda device: (contextlib.nullcontext(), 0))
    monkeypatch.setattr(kernels, "launch",
                        lambda kernel, fn, *args: calls["launch"].append(
                            (kernel, fn, args)))
    return calls


@pytest.mark.parametrize("ci,co,x_offset,last", [
    (9, 64, 0, 2), (64, 64, 0, 3), (64, 128, 0, 3), (128, 128, 0, 3),
    (16, 16, 0, 3), (24, 40, 0, 3), (64, 64, 1, 2), (70, 33, 0, 0),
    (9, 70, 0, 0)])
def test_k11_bf16_route(recorded, ci, co, x_offset, last):
    """Each grid is read in place where its rows of C channels are whole
    16-byte pieces and it starts on a 16-byte boundary, else staged: x at
    Ci = 9 (the first PVConv at R = 32), a view off the boundary, C = 33
    or 70; the launcher learns which (bit 0 x, bit 1 dY) and gets the
    in-place grid's own pointer, one launch counted as K11's bf16 mode."""
    b, r = 2, 8
    x, g = _grid(b, r, ci, x_offset), _grid(b, r, co)
    dw = conv3d._ndhwc_wgrad_cuda_bf16(x, g, r)
    assert dw.shape == (co, ci, 3, 3, 3) and dw.dtype == torch.bfloat16
    staged = [c for c, bit in ((ci, 1), (co, 2)) if not last & bit]
    assert recorded["staged"] == staged
    (kernel, fn, args), = recorded["launch"]
    assert (kernel, fn) == ("conv3d_ndhwc_wgrad_bf16",
                            "pvcnn_conv3d_bf16_wgrad_last")
    assert args[2] == last
    assert (args[0] == x.data_ptr()) == bool(last & 1)
    assert (args[1] == g.data_ptr()) == bool(last & 2)
    plan = conv3d._wgrad_bf16_plan(b, ci, co, r, 132)
    assert args[5:] == (b, ci, co, r, plan.cols, plan.splits,
                        plan.per_split, 0)


def test_k11_bf16_staged_route(recorded):
    """staged=True (the route before the in-place maps, kept for the
    tests): both grids staged and K4's own launcher, as its rows branch
    runs it."""
    x, g = _grid(1, 8, 64), _grid(1, 8, 64)
    conv3d._ndhwc_wgrad_cuda_bf16(x, g, 8, staged=True)
    assert recorded["staged"] == [64, 64]
    (kernel, fn, args), = recorded["launch"]
    assert (kernel, fn) == ("conv3d_ndhwc_wgrad_bf16",
                            "pvcnn_conv3d_bf16_wgrad")
    assert len(args) == 12


@pytest.mark.parametrize("c,offset,contiguous,in_place", [
    (9, 0, True, False), (16, 0, True, True), (24, 0, True, True),
    (64, 0, True, True), (64, 4, True, False), (64, 0, False, False),
    (33, 0, True, False)])
def test_k11_in_place(c, offset, contiguous, in_place):
    t = _grid(2, 4, c, offset)
    if not contiguous:
        t = t.transpose(1, 2)
    assert conv3d._in_place(t) == in_place
