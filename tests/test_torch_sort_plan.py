"""K1's sort and bin-walk plan (pvcnn_tpu_torch/ops/voxelize.py:
_sort_plan, _sort_chunks, _cut_runs), on the CPU: no kernel runs here, so
these hold the Python side of the launch to what csrc/voxelize.cu takes.

The cases are every K1 call of chip_smoke.py's steps (the mean's (C, R,
N) and the sum mode's (K, bins, C), fp32 and bf16) at B = 32 on a card of
132 SMs, at B = 1, and edges from one point and one bin to 32,768 of
each."""

import pytest

import chip_smoke
from pvcnn_tpu_torch.ops import voxelize

SMS = 132


def _cases():
    """(B, N, bins) of every K1 launch of the script's call tables, then
    the edges."""
    cases = set()
    tables = [v for k, v in vars(chip_smoke).items()
              if k.startswith("CALLS") and isinstance(v, dict)]
    for calls in tables:
        for (k, c), _ in calls.items():
            if k.startswith("avg_voxelize"):
                cases.add((chip_smoke.B, c[2], c[1] ** 3))
            elif k.startswith("scatter_sum"):
                cases.add((chip_smoke.B, c[0], c[1]))
    for n in (1, 777, 4096, 8192, 32768):
        for bins in (1, 512, 8192, 32768, 70000):
            cases |= {(1, n, bins), (32, n, bins)}
    return sorted(cases)


@pytest.mark.parametrize("b,n,bins", _cases())
def test_sort_plan(b, n, bins):
    """The sort splits a cloud over several blocks only where its points
    outnumber twice its bins and make two chunks of at least 2,048, then
    over as many blocks as one wave holds (B x parts <= SMs) or one a
    2,048 points; the chunks cover every point once, in order, none
    under 2,048 where it splits; the counters in shared memory exactly
    where the bins' counts fit 200 KiB; the bf16 sums cut runs past 64
    rows where a cloud's mean run is 64 rows or more, else none."""
    plan = voxelize._sort_plan(b, n, bins, SMS)
    split = n >= 2 * bins and n >= 2 * voxelize._SORT_MIN_POINTS
    if not split or b > SMS // 2:
        assert plan.parts == 1
    else:
        assert plan.parts == min(SMS // b, n // 2048) >= 2
        assert b * plan.parts <= SMS
    chunks = voxelize._sort_chunks(n, plan.parts)
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a[1] == c[0] for a, c in zip(chunks, chunks[1:]))
    if plan.parts > 1:
        assert min(e - f for f, e in chunks) >= 2048
    assert plan.shared == ((bins + 1) * 4 <= 200 * 1024)
    assert plan.long_run == (64 if n >= 64 * bins else 0)
    assert voxelize._LONG_RUN == 64


@pytest.mark.parametrize("count", [0, 1, 63, 64, 65, 127, 128, 129, 384,
                                   4100])
@pytest.mark.parametrize("long_run", [0, 64])
def test_cut_runs(count, long_run):
    """A run of long_run rows or fewer (or any run without a cut) is
    walked whole; a longer one in pieces of long_run rows, in order,
    covering it once."""
    pieces = voxelize._cut_runs(count, long_run)
    if not long_run or count <= long_run:
        assert pieces == [(0, count)]
        return
    assert pieces[0][0] == 0 and pieces[-1][1] == count
    assert all(a[1] == c[0] for a, c in zip(pieces, pieces[1:]))
    assert all(e - f == long_run for f, e in pieces[:-1])
    assert 0 < pieces[-1][1] - pieces[-1][0] <= long_run
