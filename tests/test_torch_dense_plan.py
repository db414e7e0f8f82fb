"""The launch plan of K9 and K10 (pvcnn_tpu_torch/ops/dense_rows.py:_plan)
and the weight layouts their wrappers hand the kernels (`_layout`), on the
CPU: no kernel runs here, so these hold the Python side of each launch to
what csrc/dense_gemm.cuh and csrc/dense_rows.cu take.

The cases are chip_smoke.py's CALLS3_ON (the S3DIS PVCNN 1x opt-in step,
131,072 rows) and CALLS_PVCNNE_ON (the FrustumPVCNNE 1x opt-in step,
32,768 and 16,384 rows, Ci down to 3) on a card of 132 SMs, and a few
edges: one row, rows that fill no tile, Ci = 130 and Co = 70. K9's bf16
mode (`_wgmma_plan`, `_tma_rows`, `_weight16`) and K10's (`_wgrad_plan`,
`_wgrad_walk`) are held at those cases, at PointNet++ MSG's fused layers
(CALLS_MSG_ON) and at the edges."""

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


def _wgmma_cases():
    """(kind, M, N, K, prologue) of every K9 forward and dgrad call of the
    opt-in steps and MSG's fused layers, then the edges (ragged rows, Ci =
    9, 130 and 512)."""
    cases = {(kind, m, n, k) for kind, m, n, k in _cases() if kind != "wgrad"}
    for (k, c), _ in chip_smoke.CALLS_MSG_ON.items():
        if k == "dense_rows_fwd":
            cases.add(("fwd", c[0], c[2], c[1]))
        elif k == "dense_rows_dgrad":
            cases.add(("dgrad", c[0], c[2], c[1]))
    for rows in (1, 127, 129, 131073):
        for ci, co in ((9, 64), (130, 70), (512, 256)):
            cases.update({("fwd", rows, co, ci), ("dgrad", rows, ci, co)})
    # the forward with and without the prologue; the dgrad has none
    return sorted((kind, m, n, k, pro) for kind, m, n, k in cases
                  for pro in ((False, True) if kind == "fwd" else (False,)))


@pytest.mark.parametrize("kind,m,n,k,prologue", _wgmma_cases())
def test_wgmma_plan(kind, m, n, k, prologue):
    """K9's bf16 launch, A by TMA exactly where a contiguous operand's rows
    are whole 16-byte pieces: the column tile 64 where N <= 64, else 128,
    2 blocks an SM, 1 at 128 with A in registers (staged by the consumers,
    or with the prologue), whose shared memory (w9::Layout, restated:
    with a slice's 128 rows in 16-byte pieces where TMA cannot read them)
    fits 227 KB at that count; the weight's column slice resident where it
    fits, else streamed through a ring of 2 to 4 slots; persistent blocks,
    at most the SMs' slots across the column tiles and none without a row
    tile, whose walks (block b: tiles b, b + grid, ...) cover every row
    tile once, each in increasing order; statistics slots and a ticket per
    column tile."""
    tma = dense_rows._tma_rows(torch.empty((max(m, 1), k),
                                           dtype=torch.bfloat16))
    assert tma == (k % 8 == 0)
    plan = dense_rows._wgmma_plan(m, n, k, tma, prologue, SMS)
    bn = 64 if n <= 64 else 128
    assert (plan.bn, plan.per_sm) == (
        bn, 1 if bn == 128 and (prologue or not tma) else 2)
    assert plan.slices == math.ceil(k / 64)
    direct = 0 if tma else 2 * 128 * 9 * 16
    assert plan.direct_bytes == direct
    smem = lambda stages, resident: dense_rows._wgmma_smem(
        bn, tma, stages, plan.slices, resident, direct)
    assert plan.smem_bytes == smem(plan.stages, plan.resident)
    assert plan.smem_bytes <= 232448
    budget = 233472 // plan.per_sm - 1024
    assert plan.smem_bytes <= budget
    if plan.resident:
        assert plan.stages == (4 if tma else 1) or (
            tma and plan.stages >= 2 and smem(plan.stages + 1, True) > budget)
    else:
        assert 2 <= plan.stages <= 4
        # it would not fit resident at 2 slots (1 without a ring of A)
        assert smem(2 if tma else 1, True) > budget
    assert plan.col_tiles == math.ceil(n / bn)
    assert plan.row_tiles == math.ceil(m / 128)
    assert 1 <= plan.grid <= max(1, plan.row_tiles)
    assert plan.grid * plan.col_tiles <= max(plan.per_sm * SMS,
                                             plan.col_tiles)
    walks = [list(range(b, plan.row_tiles, plan.grid))
             for b in range(plan.grid)]
    assert all(w == sorted(w) for w in walks)
    assert sorted(t for w in walks for t in w) == list(range(plan.row_tiles))
    assert plan.work_floats == plan.col_tiles * (plan.grid * 2 * bn + 1)
    # the weight's copy holds whole column tiles and slices
    assert dense_rows._padded(n) % bn == 0
    assert dense_rows._padded(k) % 64 == 0


@pytest.mark.parametrize("ci,offset,tma", [(9, 0, False), (64, 0, True),
                                           (64, 1, False), (196, 0, False),
                                           (512, 0, True), (130, 0, False),
                                           (8, 8, True), (8, 4, False)])
def test_wgmma_tma_rows(ci, offset, tma):
    """TMA reads A's rows exactly where their stride is a multiple of 16
    bytes and the base 16-byte aligned: not at Ci = 9, 130 or 196 (MSG's
    dgrad), nor for a view off a 16-byte boundary; the consumers read those
    in place (no padded copy)."""
    base = torch.zeros(100 * ci + 16, dtype=torch.bfloat16)
    start = (-base.data_ptr() // 2) % 8 + offset      # aligned, then offset
    t2 = base[start:start + 10 * ci].view(10, ci)
    assert dense_rows._tma_rows(t2) == tma
    assert dense_rows._rows_of(t2) is t2


@pytest.mark.parametrize("ci,co", [(9, 64), (64, 64), (130, 70), (1, 3),
                                   (323, 196)])
@pytest.mark.parametrize("layout", ["rows", "columns"])
def test_wgmma_weight_copy(ci, co, layout):
    """The bf16 copy of the weight that the forward's launch writes and the
    dgrad reads: [Kp / 8, Cop, 8] (Ci and Co padded to whole column tiles
    and slices: 64, or a multiple of 128), element (g, co, j) the
    weight at (8 g + j, co) rounded to bf16 (round to nearest even), zeros
    past Ci and Co, from either layout of the f32 weight."""
    gen = torch.Generator().manual_seed(ci * co)
    w = torch.randn(ci, co, generator=gen)
    if layout == "columns":
        w = w.t().contiguous().t()            # the SharedMLP's view
    w16 = dense_rows._weight16(w)
    kp, cop = dense_rows._padded(ci), dense_rows._padded(co)
    assert w16.shape == (kp // 8, cop, 8) and w16.dtype == torch.bfloat16
    flat = w16.permute(0, 2, 1).reshape(kp, cop)
    assert torch.equal(flat[:ci, :co], w.to(torch.bfloat16))
    assert not flat[ci:].any() and not flat[:, co:].any()


@pytest.mark.parametrize("c,padded", [(1, 64), (9, 64), (64, 64), (65, 128),
                                      (128, 128), (129, 256), (196, 256),
                                      (323, 384), (515, 640), (1024, 1024),
                                      (1536, 1536)])
def test_wgmma_weight_padding(c, padded):
    assert dense_rows._padded(c) == padded


def _wgrad_bf16_cases():
    """(rows, Ci, Co) of every K10 bf16 call of the opt-in step and of
    MSG's fused layers, then the edges: 1, 127, 129 and 131,073 rows at
    Ci = 9, 130 and 512, Co = 196."""
    cases = {(ROWS, c[0], c[1]) for (k, c), _ in
             chip_smoke.CALLS3_ON_BF16.items()
             if k == "dense_rows_wgrad_bf16"}
    cases |= {c[:3] for (k, c), _ in chip_smoke.CALLS_MSG_ON_BF16.items()
              if k == "dense_rows_wgrad_bf16"}
    for rows in (1, 127, 129, 131073):
        cases |= {(rows, 9, 64), (rows, 130, 196), (rows, 512, 256)}
    return sorted(cases)


@pytest.mark.parametrize("rows,ci,co", _wgrad_bf16_cases())
def test_wgrad_bf16_plan(rows, ci, co):
    """K10's bf16 launch: x and g by TMA exactly where their rows are whole
    16-byte pieces, else by 8- or 4-byte copies where their rows are whole
    pieces of that size, else as raw rows; the column tile the
    least of 64, 128 and 256 that holds Co; two 64-channel tiles of Ci a
    block where Ci > 64; x's contiguous rows TMA cannot read as bulk
    slices (route 1) where 3 slots of them fit; 2 to 4 raw buffers for g's
    rows without 4-byte pieces, no more than the ring's 2 to 6 slots;
    slices of 128 rows where 4 ring slots fit (with both operands by
    TMA), else 64 or 32; shared memory
    (w10::Layout, restated) within 227 KB at one block
    an SM; the persistent grid (one wave) walks every (tile, slice) once,
    each block its units in order and each unit its slices in order,
    tile fastest; no part empty; the slots no larger than x and g where
    there is more than one part; work: the warpgroups' slots, the d(bias)
    slots and a counter."""
    x = torch.empty((rows, ci), dtype=torch.bfloat16)
    routes = [dense_rows._copy_route(torch.empty((rows, c),
                                                 dtype=torch.bfloat16))
              for c in (ci, co)]
    assert routes == [16 if c % 8 == 0 else 8 if c % 4 == 0 else
                      4 if c % 2 == 0 else 2 for c in (ci, co)]
    bulk = dense_rows._bulk_rows(x, routes[0])
    assert bulk == (ci % 8 != 0)
    plan = dense_rows._wgrad_plan(rows, ci, co, *routes, SMS, bulk)
    assert plan.a_route == routes[0] or (bulk and plan.a_route == 1)
    routes[0] = plan.a_route
    assert plan.bn == (64 if co <= 64 else 128 if co <= 128 else 256)
    assert plan.pair == (ci > 64)
    assert plan.sr <= 64 or plan.bn < 256      # the kernel's A fragments
    assert plan.smem_bytes == dense_rows._w10_smem(
        plan.bn, plan.pair, plan.sr, plan.stages, plan.dslots, *routes, ci)
    assert plan.smem_bytes + 1024 <= 233472 and plan.smem_bytes <= 232448
    assert plan.dslots == (0 if routes[1] != 2 else plan.dslots)
    assert plan.dslots == 0 or 2 <= plan.dslots <= 4
    assert max(2, plan.dslots) <= plan.stages <= 6
    assert plan.stages >= 3 or plan.a_route != 1
    if routes == [16, 16]:
        at128 = dense_rows._w10_smem(plan.bn, plan.pair, 128, 4, 0,
                                     *routes, ci)
        assert (plan.sr == 128) == (at128 + 1024 <= 233472)
    if plan.stages < 6:
        assert dense_rows._w10_smem(plan.bn, plan.pair, plan.sr,
                                    plan.stages + 1, plan.dslots,
                                    *routes, ci) > 232448
    assert plan.mtiles == math.ceil(ci / (128 if plan.pair else 64))
    assert plan.ntiles == math.ceil(co / plan.bn)
    assert plan.slices == math.ceil(rows / plan.sr)
    tiles = plan.mtiles * plan.ntiles
    assert 1 <= plan.parts <= plan.slices
    assert plan.grid == min(SMS, tiles * plan.parts)
    if plan.parts > 1:
        assert tiles * plan.parts <= SMS
        assert plan.parts * tiles * 2 * 64 * plan.bn * 4 <= \
            2 * rows * (ci + co)
    walk = dense_rows._wgrad_walk(plan)
    assert len(walk) == plan.grid
    seen = []
    for units in walk:
        assert [u[1] * tiles + u[0] for u in units] == sorted(
            u[1] * tiles + u[0] for u in units)
        for tile, part, first, end in units:
            assert first < end
            seen += [(tile, s) for s in range(first, end)]
    assert sorted(seen) == [(t, s) for t in range(tiles)
                            for s in range(plan.slices)]
    kps = plan.parts * (1 if plan.pair else 2)
    assert plan.work_floats == (
        (2 * plan.mtiles if plan.pair else 1) * plan.ntiles * kps * 64
        * plan.bn + plan.ntiles * plan.parts * plan.bn + 1)


@pytest.mark.parametrize("ci,co,want", [
    (128, 1024, (256, True, 64, 4, 1, 4, 33, 132)),
    (512, 256, (256, True, 64, 4, 4, 1, 33, 132)),
    (64, 128, (128, False, 128, 4, 1, 1, 132, 132)),
    (64, 64, (64, False, 128, 6, 1, 1, 132, 132)),
    (9, 64, (64, False, 128, 6, 1, 1, 132, 132))])
def test_wgrad_bf16_plan_at_the_opt_in_step(ci, co, want):
    """K10's bf16 launch at the opt-in step's cases on 132 SMs: (128,
    1024) reads g once in 4 column tiles of 256 on 33 parts of the rows,
    (512, 256) x once in 4 tiles of 128 channels; the narrow layers one
    tile of 64 channels whose rows both warpgroups share, on 132 parts.
    (bn, pair, sr, stages, mtiles, ntiles, parts, grid)"""
    plan = dense_rows._wgrad_plan(ROWS, ci, co, 16 if ci % 8 == 0 else 2,
                                  16, SMS, ci % 8 != 0)
    assert (plan.bn, plan.pair, plan.sr, plan.stages, plan.mtiles,
            plan.ntiles, plan.parts, plan.grid) == want
    assert plan.dslots == 0


@pytest.mark.parametrize("c,offset,route", [
    (9, 0, 2), (64, 0, 16), (64, 1, 2), (196, 0, 8), (150, 0, 4),
    (6, 0, 4), (512, 0, 16), (130, 0, 4), (64, 4, 8), (64, 2, 4),
    (323, 0, 2)])
def test_wgrad_copy_route(c, offset, route):
    """K10's bf16 rows go by TMA exactly where their stride is a multiple
    of 16 bytes and the base 16-byte aligned (the opt-in step's and MSG's
    x and g but for x at Ci = 9, 6, 150, 196, 323, 515 and g at Co = 196);
    else by 8- or 4-byte copies where stride and base are multiples of
    that (Ci = 196 and Co = 196: 8; Ci = 6, 130, 150: 4); else raw (odd
    Ci); views off a boundary take the route their base allows. No
    padded copy on any route."""
    base = torch.zeros(100 * c + 16, dtype=torch.bfloat16)
    start = (-base.data_ptr() // 2) % 8 + offset      # aligned, then offset
    t = base[start:start + 100 * c].view(100, c)
    assert dense_rows._copy_route(t) == route
