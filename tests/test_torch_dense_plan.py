"""The launch plan of K9 and K10 (pvcnn_tpu_torch/ops/dense_rows.py:_plan)
and the weight layouts their wrappers hand the kernels (`_layout`), on the
CPU: no kernel runs here, so these hold the Python side of each launch to
what csrc/dense_gemm.cuh and csrc/dense_rows.cu take.

The cases are chip_smoke.py's CALLS3_ON (the S3DIS PVCNN 1x opt-in step,
131,072 rows) and CALLS_PVCNNE_ON (the FrustumPVCNNE 1x opt-in step,
32,768 and 16,384 rows, Ci down to 3) on a card of 132 SMs, and a few
edges: one row, rows that fill no tile, Ci = 130 and Co = 70."""

import math

import pytest
import torch

import chip_smoke
from pvcnn_tpu_torch.ops import dense_rows

SMS = 132
ROWS = chip_smoke.B * chip_smoke.N3


def _cases():
    """(kind, M, N, K) of every K9 forward, dgrad and K10 call of the
    opt-in step, then the edges."""
    cases = set()
    for (k, c), _ in chip_smoke.CALLS3_ON.items():
        if k == "dense_rows_fwd":
            cases.add(("fwd", ROWS, c[1], c[0]))
        elif k == "dense_rows_dgrad":
            cases.add(("dgrad", ROWS, c[1], c[0]))
        elif k == "dense_rows_wgrad":
            cases.add(("wgrad", c[0], c[1], ROWS))
    # the Frustum cases lead with their rows: (rows, Ci, Co, prologue) and
    # (rows, Co, Ci)
    for (k, c), _ in chip_smoke.CALLS_PVCNNE_ON.items():
        if k in ("dense_rows_fwd", "dense_rows_dgrad"):
            cases.add((k[11:], c[0], c[2], c[1]))
        elif k == "dense_rows_wgrad":
            cases.add(("wgrad", c[1], c[2], c[0]))
    edges = [("fwd", 1, 70, 130), ("fwd", 100, 64, 9), ("dgrad", 129, 130, 70),
             ("wgrad", 130, 70, 1000), ("wgrad", 9, 64, 37),
             ("wgrad", 1, 1, 1)]
    return sorted(cases) + edges


@pytest.mark.parametrize("kind,m,n,k", _cases())
def test_dense_plan(kind, m, n, k):
    """The tile: 64 columns exactly where N <= 64, else 128, on 2 * BN
    threads; a 4-slot ring of 16-deep slices whose shared memory (the
    epilogue reuses it) is what the kernel asks for, under 227 KiB, with
    the blocks its __launch_bounds__ promise (2 of 256 threads, 3 of 128)
    on an SM. K9 runs one chunk; K10 splits the rows into equal chunks of
    whole slices that cover them with none empty, within two waves of
    resident blocks, none under 8 slices where it splits, and its partial
    buffer holds [splits][M][N] and [splits][N] floats."""
    wgrad = kind == "wgrad"
    plan = dense_rows._plan(m, n, k, wgrad, SMS)
    assert plan.bn == (64 if n <= 64 else 128)
    assert plan.threads == 2 * plan.bn
    assert (plan.bk, plan.stages) == (16, 4)
    assert plan.smem_bytes == 4 * 4 * 16 * (128 + 4 + plan.bn + 4)
    per_sm = 2 if plan.bn == 128 else 3
    assert per_sm * (plan.smem_bytes + 1024) <= 233472
    assert plan.tiles == math.ceil(m / 128) * math.ceil(n / plan.bn)
    if not wgrad:
        assert (plan.splits, plan.chunk, plan.partial_bytes) == (1, k, 0)
        return
    assert plan.chunk % 16 == 0
    assert (plan.splits - 1) * plan.chunk < k <= plan.splits * plan.chunk
    if plan.splits > 1:
        assert plan.tiles * plan.splits <= 2 * per_sm * SMS
        assert plan.chunk >= 8 * 16
        assert plan.partial_bytes == 4 * plan.splits * (m * n + n)
    else:
        assert plan.partial_bytes == 0
        assert k < 2 * 8 * 16 or plan.tiles >= 2 * per_sm * SMS


@pytest.mark.parametrize("ci,co,splits,chunk,partial_bytes", [
    (128, 1024, 33, 3984, 17436672), (512, 256, 33, 3984, 17335296),
    (64, 128, 256, 512, 8519680), (64, 64, 391, 336, 6506240),
    (9, 64, 391, 336, 1000960)])
def test_dense_wgrad_plan_at_the_opt_in_step(ci, co, splits, chunk,
                                             partial_bytes):
    """K10's split at the opt-in step's cases on 132 SMs: the two large
    cases fill one wave of 264 resident blocks with 8 tiles x 33 chunks,
    half the partial bytes of the fixed 1,024-block split they replace."""
    plan = dense_rows._plan(ci, co, ROWS, True, SMS)
    assert (plan.splits, plan.chunk, plan.partial_bytes) == (
        splits, chunk, partial_bytes)


@pytest.mark.parametrize("layout", ["rows", "columns", "strided"])
def test_dense_layout(layout):
    """`_layout` reads a contiguous weight by rows and the SharedMLP's
    transposed view of its Conv1d weight by columns, in place (the same
    storage, no copy); anything else is copied to rows first."""
    base = torch.arange(6 * 10, dtype=torch.float32)
    w = {"rows": base.reshape(6, 10),
         "columns": base.reshape(10, 6).t(),
         "strided": base.reshape(6, 10)[:, ::2]}[layout]
    t, ld, kmajor = dense_rows._layout(w)
    assert torch.equal(t, w)
    if layout == "rows":
        assert (ld, kmajor) == (10, 0) and t.data_ptr() == w.data_ptr()
    elif layout == "columns":
        assert (ld, kmajor) == (6, 1) and t.data_ptr() == w.data_ptr()
    else:
        assert (ld, kmajor) == (5, 0) and t.is_contiguous()
    # element (k, n) where the kernel reads it
    flat = t.reshape(-1) if not kmajor else t.t().reshape(-1)
    for k in range(t.shape[0]):
        for n in range(t.shape[1]):
            at = n * ld + k if kmajor else k * ld + n
            assert flat[at] == w[k, n]
