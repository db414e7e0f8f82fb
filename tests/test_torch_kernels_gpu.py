"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Marked `gpu`: they skip without a CUDA device; run them on
one with `python -m pytest tests/test_torch_kernels_gpu.py -m gpu`.
chip_smoke.py checks the same at the model's full shapes."""

import itertools

import pytest
import torch

from pvcnn_tpu_torch import kernels, ops
from pvcnn_tpu_torch.ops import conv3d, devoxelize, voxelize

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    return torch.device("cuda")


def _coords(dev, b=2, n=512):
    pts = torch.randn(b, n, 3, device=dev)
    return pts / pts.norm(dim=-1).amax()


def _k1_check(feats, flat, bins, channels_first):
    """K1's mean against its plain version, one launch per op call, two
    runs bitwise equal; -> the output."""
    before = kernels.KERNELS["avg_voxelize"].launches
    got = ops.scatter_mean(feats, flat, bins, channels_first)
    assert kernels.KERNELS["avg_voxelize"].launches == before + 1
    want = voxelize._scatter_mean_plain(feats, flat, bins, channels_first)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, ops.scatter_mean(feats, flat, bins,
                                             channels_first))
    assert kernels.KERNELS["avg_voxelize"].launches == before + 2
    return got


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("r", [1, 8, 16, 32])
@pytest.mark.parametrize("c", [1, 3, 9, 64, 130, 256])
def test_avg_voxelize_kernel(dev, c, r, b, channels_first):
    """Channel counts on and off the float4 rows, the lane groups' widths
    and the channel-major tile's 256-channel passes; R = 1 (one bin) to 32
    (most bins empty)."""
    vox, _ = ops.normalize_coords(_coords(dev, b=b), r, normalize=False)
    flat = ops.flat_voxel_index(vox, r)
    _k1_check(torch.randn(b, 512, c, device=dev), flat, r ** 3,
              channels_first)


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("case", ["one_point", "one_bin", "unaligned"])
@pytest.mark.parametrize("c", [4, 64])
def test_avg_voxelize_kernel_edges(dev, c, case, channels_first):
    """N = 1; every point of a cloud in one bin (one run of all N rows);
    rows off a 16-byte boundary (the scalar path where C % 4 == 0)."""
    b, n, r = 2, 700, 16
    flat = torch.randint(0, r ** 3, (b, n), dtype=torch.int32, device=dev)
    feats = torch.randn(b, n, c, device=dev)
    if case == "one_point":
        flat, feats = flat[:, :1], feats[:, :1]
    elif case == "one_bin":
        flat[0] = 1234
        flat[1] = r ** 3 - 1
    else:
        feats = torch.randn(b * n * c + 1, device=dev)[1:].view(b, n, c)
    _k1_check(feats, flat, r ** 3, channels_first)


@pytest.mark.parametrize("c", [3, 64, 256])
def test_k1_layouts_agree(dev, c):
    """K1's two layouts sum the same runs in the same order: the
    channel-major grid is the channel-last one transposed, bit for bit."""
    flat = torch.randint(0, 4096, (2, 3000), dtype=torch.int32, device=dev)
    feats = torch.randn(2, 3000, c, device=dev)
    first = ops.scatter_mean(feats, flat, 4096, channels_first=True)
    last = ops.scatter_mean(feats, flat, 4096, channels_first=False)
    assert torch.equal(first, last.transpose(1, 2))


@pytest.mark.parametrize("b,n,bins", [(3, 777, 512), (2, 8192, 32768),
                                      (2, 32768, 8192), (2, 5000, 70000),
                                      (1, 1, 1), (2, 4100, 1)])
def test_k1_sort_kernel(dev, b, n, bins):
    """K1's counting sort: its permutation is torch.sort(stable=True)'s,
    its bounds the running sum of the bins' counts (and both its plain
    oracle's), two runs equal; 70,000 bins outgrow the shared-memory
    counters, 4,100 points in one bin make one run of several rounds."""
    ids = torch.randint(0, bins, (b, n), dtype=torch.int32, device=dev)
    ids[0, : n // 4] = ids[0, n // 2]                  # one long run
    perm, bounds = voxelize._sort_bins(ids, bins)
    want = torch.sort(ids, dim=1, stable=True)[1].to(torch.int32)
    assert torch.equal(perm, want)
    counts = torch.stack([torch.bincount(ids[i].long(), minlength=bins)
                          for i in range(b)])
    want_bounds = torch.cat([counts.new_zeros(b, 1), counts.cumsum(1)], 1)
    assert torch.equal(bounds.long(), want_bounds)
    plain = voxelize._sort_bins_plain(ids, bins)
    assert torch.equal(perm, plain[0]) and torch.equal(bounds, plain[1])
    again = voxelize._sort_bins(ids, bins)
    assert torch.equal(perm, again[0]) and torch.equal(bounds, again[1])


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("n,bins", [(1, 1), (1, 32768), (777, 512),
                                    (4096, 1), (8192, 32768), (8192, 1024),
                                    (24576, 1024), (32768, 8192),
                                    (32768, 32768)])
def test_k1_split_sort(dev, b, n, bins):
    """K1's sort, one block a cloud or split over the plan's blocks (and
    over 3 forced on every case): perm and bounds equal to
    torch.sort(stable=True)'s and the running counts, ids out of range
    (negative or >= bins) dropped; a long run of a quarter of the cloud;
    two runs equal."""
    ids = torch.randint(0, bins, (b, n), dtype=torch.int32, device=dev)
    ids[:, : n // 4] = ids[:, n // 2: n // 2 + 1]
    ids[:, 1::7] = -1
    ids[:, 2::11] = bins
    kept = (ids >= 0) & (ids < bins)
    key = torch.where(kept, ids, torch.full_like(ids, bins))
    want = torch.sort(key, dim=1, stable=True)[1].to(torch.int32)
    counts = torch.stack([torch.bincount(ids[i][kept[i]].long(),
                                         minlength=bins) for i in range(b)])
    want_bounds = torch.cat([counts.new_zeros(b, 1), counts.cumsum(1)], 1)
    plan = voxelize._sort_plan(b, n, bins, 132)
    for parts in sorted({plan.parts, 1, 3}):
        forced = plan._replace(parts=parts)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(voxelize, "_sort_plan", lambda *a: forced)
            perm, bounds = voxelize._sort_bins(ids, bins)
            again = voxelize._sort_bins(ids, bins)
        assert torch.equal(bounds.long(), want_bounds), parts
        assert torch.equal(bounds, again[1])
        for i in range(b):        # past the kept points perm is not written
            m = int(bounds[i, -1])
            assert torch.equal(perm[i, :m], want[i, :m]), (parts, i)
            assert torch.equal(perm[i, :m], again[0][i, :m]), (parts, i)


def _devoxelize_inputs(dev, c, r, n):
    """norm_coords with collapsed corners (exact grid hits, and points on
    the last plane of one or all three axes) and a [2, C, R^3] grid."""
    _, norm = ops.normalize_coords(_coords(dev, n=n), r, normalize=True)
    norm[:, :4] = norm[:, :4].floor()
    norm[:, 4:8, 0] = r - 1
    norm[:, 8:12] = r - 1
    return norm, torch.randn(2, c, r ** 3, device=dev)


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("c,r,n", [(16, 8, 512), (32, 16, 512),
                                   (9, 8, 1000), (13, 16, 1000),
                                   (300, 32, 1000)])
def test_devoxelize_kernel(dev, c, r, n, channels_first):
    """K2 against its plain version, two runs bitwise equal; the new cases
    take channel counts off the channel-major mapping's 16- and 32-channel
    tiles, point counts off its 32-point warps, and R = 8, 16 and 32."""
    norm, grid = _devoxelize_inputs(dev, c, r, n)
    if not channels_first:
        grid = grid.transpose(1, 2).contiguous()
    before = kernels.KERNELS["trilinear_devoxelize"].launches
    got = ops.devoxelize_rows(grid, norm, r, channels_first)
    assert kernels.KERNELS["trilinear_devoxelize"].launches == before + 1
    want = devoxelize._devoxelize_plain(grid, norm, r, channels_first)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, ops.devoxelize_rows(grid, norm, r,
                                                channels_first))


@pytest.mark.parametrize("c,r,n", [(64, 32, 1000), (300, 16, 77)])
def test_devoxelize_layouts_agree(dev, c, r, n):
    """K2's two mappings sum the same terms in the same order: the
    channel-major grid and its channel-last copy give equal outputs."""
    norm, grid = _devoxelize_inputs(dev, c, r, n)
    got = devoxelize._devoxelize_cuda(grid, norm, r, True)
    last = devoxelize._devoxelize_cuda(grid.transpose(1, 2).contiguous(),
                                       norm, r, False)
    assert torch.equal(got, last)


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("ci,co,r", [(6, 16, 8), (16, 80, 12)])
def test_conv3d_kernel(dev, ci, co, r, has_prologue):
    x = torch.randn(2, ci, r ** 3, device=dev)
    w = torch.randn(co, ci, 3, 3, 3, device=dev) * 0.1
    bias = torch.randn(co, device=dev)
    scale = torch.rand(ci, device=dev) + 0.5
    shift = torch.randn(ci, device=dev)
    args = (x, w, bias, scale, shift, r, has_prologue)
    y, s1, s2 = ops.conv3d_rows_act(*args, want_stats=True)
    torch.testing.assert_close(y, conv3d._conv3d_plain(*args),
                               rtol=1e-4, atol=1e-4)
    want1, want2 = conv3d._stats_plain(y)
    torch.testing.assert_close(s1, want1, rtol=1e-4,
                               atol=1e-4 * y.abs().sum().item() / co)
    torch.testing.assert_close(s2, want2, rtol=1e-4, atol=0)
    again = ops.conv3d_rows_act(*args, want_stats=True)
    assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))


def _cpu_twin(tensors):
    return [t.detach().cpu().requires_grad_(t.requires_grad) for t in tensors]


def _grads_close(got, want, rtol=1e-4):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("has_prologue,want_stats", [(False, True),
                                                     (True, True),
                                                     (True, False)])
@pytest.mark.parametrize("ci,co,r", [(6, 16, 8), (16, 80, 12),
                                     (130, 70, 8)])
def test_conv3d_grads_on_card(dev, ci, co, r, has_prologue, want_stats):
    """The op's backward on the card (K3 as the dgrad, K4 as the wgrad)
    against the same op on the CPU (the plain versions), with cotangents
    on y, s1 and s2; ragged row and column tiles included."""
    t = [torch.randn(2, ci, r ** 3, device=dev),
         torch.randn(co, ci, 3, 3, 3, device=dev) * 0.1,
         torch.randn(co, device=dev),
         torch.rand(ci, device=dev) + 0.5, torch.randn(ci, device=dev)]
    for x in t:
        x.requires_grad_()
    cot = [torch.randn(2, co, r ** 3, device=dev),
           torch.randn(co, device=dev) * 0.1,
           torch.randn(co, device=dev) * 0.01]
    counts = kernels.launch_counts()
    out = ops.conv3d_rows_act(*t, r, has_prologue, want_stats)
    got = torch.autograd.grad(out, t, cot, allow_unused=True)
    after = kernels.launch_counts()
    assert after["conv3d_dgrad"] == counts["conv3d_dgrad"] + 1
    assert after["conv3d_wgrad"] == counts["conv3d_wgrad"] + 1
    tc = _cpu_twin(t)
    want = torch.autograd.grad(
        ops.conv3d_rows_act(*tc, r, has_prologue, want_stats), tc,
        [c.cpu() for c in cot], allow_unused=True)
    _grads_close(got, want)
    again = torch.autograd.grad(
        ops.conv3d_rows_act(*t, r, has_prologue, want_stats), t, cot,
        allow_unused=True)
    assert all(a is None or torch.equal(a, b) for a, b in zip(got, again))


def _wgrad_inputs(dev, b, ci, co, r):
    """x, dy and a prologue whose shift drives every third channel's rows
    negative (the LeakyReLU's 0.1 slope), the others partly."""
    x = torch.randn(b, ci, r ** 3, device=dev)
    gy = torch.randn(b, co, r ** 3, device=dev)
    scale = torch.rand(ci, device=dev) + 0.5
    shift = torch.randn(ci, device=dev)
    shift[::3] = -10.0
    return x, gy, scale, shift


def _wgrad_check(args):
    """K4 against its plain version at its tolerance (rtol 1e-4, atol 1e-4
    of the largest entry), one launch counted, two runs bitwise equal."""
    before = kernels.KERNELS["conv3d_wgrad"].launches
    got = conv3d._wgrad_cuda(*args)
    assert kernels.KERNELS["conv3d_wgrad"].launches == before + 1
    want = conv3d._wgrad_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * want.abs().max().item())
    assert torch.equal(got, conv3d._wgrad_cuda(*args))


@pytest.mark.parametrize("r", [1, 8, 12, 16, 32])
@pytest.mark.parametrize("co", [1, 16, 32, 33, 64, 130])
@pytest.mark.parametrize("ci", [1, 6, 9, 32, 128, 257])
def test_wgrad_kernel(dev, ci, co, r):
    """K4 at every tile (Co <= 32 and wider, ragged row and column tiles),
    z-segment length (8 at R = 1 and 8, 16 at R = 12 and 16, 32 at R = 32)
    and the plan's splits, at B = 3 with the prologue; R = 12 stages its
    rows 16 bytes at a time with a zero-filled segment end."""
    x, gy, scale, shift = _wgrad_inputs(dev, 3, ci, co, r)
    _wgrad_check((x, gy, scale, shift, r, True))


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("r", [1, 5, 8, 16, 32])
def test_wgrad_kernel_clouds(dev, b, r, has_prologue):
    """One cloud and three, with and without the prologue; R = 5 stages its
    rows 4 bytes at a time and zero-fills z = 5 .. 7 of each segment."""
    x, gy, scale, shift = _wgrad_inputs(dev, b, 9, 33, r)
    _wgrad_check((x, gy, scale, shift, r, has_prologue))


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 7, 40])
@pytest.mark.parametrize("r", [8, 16, 32])
def test_wgrad_split_boundaries(dev, monkeypatch, r, splits):
    """K4 with its reduction split in runs that end inside a cloud and at
    and across cloud boundaries (B = 3: 16, 128 or 1024 slices per cloud at
    R = 8, 16, 32), with and without runs longer than the 16 slices after
    which a block folds its accumulators into its running sums."""
    plan = conv3d._wgrad_plan

    def forced(*a):
        p = plan(*a)
        per = -(-p.slices // splits)
        return p._replace(splits=-(-p.slices // per))

    monkeypatch.setattr(conv3d, "_wgrad_plan", forced)
    x, gy, scale, shift = _wgrad_inputs(dev, 3, 32, 64, r)
    for pro in (False, True):
        _wgrad_check((x, gy, scale, shift, r, pro))


def test_wgrad_kernel_views(dev):
    """Inputs that are views: a non-contiguous x and a dy at an offset
    that is not 16-byte aligned (its rows staged 4 bytes at a time)."""
    r = 8
    x = torch.randn(3, r ** 3, 6, device=dev).transpose(1, 2)
    flat = torch.randn(3 * 40 * r ** 3 + 1, device=dev)
    gy = flat[1:].reshape(3, 40, r ** 3)
    _wgrad_check((x, gy, None, None, r, False))


@pytest.mark.parametrize("ci,co,r", [(16, 6, 8), (64, 32, 16)])
def test_dgrad_kernel(dev, ci, co, r):
    gy = torch.randn(2, co, r ** 3, device=dev)
    w = torch.randn(co, ci, 3, 3, 3, device=dev) * 0.1
    torch.testing.assert_close(conv3d._dgrad_cuda(gy, w, r),
                               conv3d._dgrad_plain(gy, w, r),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("c,r", [(16, 8), (32, 16), (13, 8)])
def test_devoxelize_bwd_kernel(dev, c, r, channels_first):
    _, norm = ops.normalize_coords(_coords(dev), r, normalize=True)
    norm[:, :4] = norm[:, :4].floor()          # collapsed corners
    g = torch.randn(2, 512, c, device=dev)
    before = kernels.KERNELS["devoxelize_bwd"].launches
    got = devoxelize._devoxelize_bwd_cuda(g, norm, r, channels_first)
    assert kernels.KERNELS["devoxelize_bwd"].launches == before + 1
    want = devoxelize._devoxelize_bwd_plain(g, norm, r, channels_first)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, devoxelize._devoxelize_bwd_cuda(
        g, norm, r, channels_first))
    # through the op's backward
    grid = torch.randn(2, c, r ** 3, device=dev)
    if not channels_first:
        grid = grid.transpose(1, 2).contiguous()
    grid.requires_grad_()
    out = ops.devoxelize_rows(grid, norm, r, channels_first)
    (dgrid,) = torch.autograd.grad(out, grid, g)
    assert torch.equal(dgrid, got)


@pytest.mark.parametrize("channels_first", [False, True])
def test_scatter_mean_backward_on_card(dev, channels_first):
    vox, _ = ops.normalize_coords(_coords(dev), 8, normalize=False)
    flat = ops.flat_voxel_index(vox, 8)
    feats = torch.randn(2, 512, 16, device=dev, requires_grad=True)
    out = ops.scatter_mean(feats, flat, 512, channels_first)
    g = torch.randn_like(out)
    (got,) = torch.autograd.grad(out, feats, g)
    fc = feats.detach().cpu().requires_grad_()
    (want,) = torch.autograd.grad(
        ops.scatter_mean(fc, flat.cpu(), 512, channels_first), fc, g.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_kernels_reject_what_they_do_not_take(dev):
    x = torch.randn(1, 4, 512, device=dev)
    with pytest.raises(ValueError, match="3x3x3"):
        ops.conv3d_rows_act(x, torch.randn(4, 4, 5, 5, 5, device=dev),
                            torch.zeros(4, device=dev), None, None, 8, False)
    with pytest.raises(ValueError, match="float32"):
        ops.scatter_mean(x.double().transpose(1, 2),
                         torch.zeros(1, 512, dtype=torch.int32, device=dev),
                         512)
    # the new wrappers: wrong dtype, wrong device
    gy = torch.randn(1, 4, 512, device=dev)
    with pytest.raises(ValueError, match="float32"):
        conv3d._wgrad_cuda(x.double(), gy, None, None, 8, False)
    with pytest.raises(ValueError, match="CUDA device"):
        conv3d._wgrad_cuda(x, gy, torch.ones(4), torch.zeros(4), 8, True)
    with pytest.raises(ValueError, match="float32"):
        conv3d._dgrad_cuda(gy.double(), torch.randn(4, 4, 3, 3, 3,
                                                    device=dev), 8)
    with pytest.raises(ValueError, match="CUDA device"):
        devoxelize._devoxelize_bwd_cuda(torch.randn(1, 64, 4, device=dev),
                                        torch.rand(1, 64, 3), 8, True)
    with pytest.raises(ValueError, match="float32"):
        devoxelize._devoxelize_bwd_cuda(
            torch.randn(1, 64, 4, device=dev, dtype=torch.float64),
            torch.rand(1, 64, 3, device=dev), 8, True)


def _room(dev, b, n, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    pts = torch.rand(b, n, 3, generator=g) * torch.tensor([1.0, 1.0, 3.0])
    if n >= 48:
        pts[:, 16:32] = pts[:, 32:48]          # duplicated points: ties
    return pts.to(dev)


@pytest.mark.parametrize("b", [1, 3, 32])
@pytest.mark.parametrize("m", [1, 2, 300, "n + 3"])
@pytest.mark.parametrize("n", [1, 31, 1023, 1025, 8192, 16384, 16385,
                               40000])
def test_fps_kernel(dev, n, m, b):
    """Indices equal the plain version's exactly (ties to the lowest index:
    duplicated points, and at B = 3 a cloud of identical points, where
    every distance ties; M > N), two runs bitwise equal, one launch; every
    cloud size takes the kernel (16,385 points and more on clusters of
    blocks)."""
    from pvcnn_tpu_torch.ops import sampling

    m = n + 3 if m == "n + 3" else m
    x = _room(dev, b, n)
    if b == 3:
        x[1] = x[1, :1]
    before = kernels.KERNELS["fps"].launches
    got = ops.furthest_point_sample_indices(x, m)
    assert kernels.KERNELS["fps"].launches == before + 1
    assert torch.equal(got, sampling._fps_plain(x, m))
    assert torch.equal(got, ops.furthest_point_sample_indices(x, m))


@pytest.mark.parametrize("plan", [(1, 32, 0), (2, 64, 0), (8, 1024, 0),
                                  (2, 128, 4), (8, 64, 16), (4, 256, 2),
                                  (8, 32, 4)])
@pytest.mark.parametrize("n", [100, 1000])
def test_fps_kernel_plans(dev, plan, n):
    """Every launch K6 takes gives the plain version's indices: clusters of
    1 to 8 blocks, points in registers or streamed (ppt = 0) from global
    memory with the distances in a global buffer."""
    from pvcnn_tpu_torch.ops import sampling

    x = _room(dev, 3, n)
    got = sampling._fps_cuda(x, 200, plan)
    assert torch.equal(got, sampling._fps_plain(x, 200))


def test_fps_kernel_streams_large_clouds(dev):
    """Above 16,384 points the plan streams the points from global memory
    on a cluster of 8 blocks; the indices stay the plain version's."""
    from pvcnn_tpu_torch.ops import sampling

    x = _room(dev, 2, 70000)
    assert sampling._fps_plan(70000)[2] == 0
    got = ops.furthest_point_sample_indices(x, 64)
    assert torch.equal(got, sampling._fps_plain(x, 64))


def _ball_query_check(c, x, radius, u):
    """K7's indices equal the plain version's exactly, one launch counted,
    two runs bitwise equal; -> the indices."""
    from pvcnn_tpu_torch.ops import neighbors

    r2 = neighbors._fp32(radius ** 2)
    before = kernels.KERNELS["ball_query"].launches
    got = neighbors._ball_query_cuda(c, x, r2, u)
    assert kernels.KERNELS["ball_query"].launches == before + 1
    assert torch.equal(got, neighbors._ball_query_plain(c, x, r2, u))
    assert torch.equal(got, neighbors._ball_query_cuda(c, x, r2, u))
    return got


@pytest.mark.parametrize("m,n,radius,u", [(1024, 8192, 0.1, 32),
                                          (16, 64, 0.8, 32),
                                          (100, 40, 0.5, 64),
                                          (33, 3000, 0.05, 8),
                                          (1000, 5000, 0.2, 1),
                                          (70, 2049, 0.3, 64),
                                          (300, 2000, 0.3, 256)])
def test_ball_query_kernel(dev, m, n, radius, u):
    """Exact against the plain version: early stop at U hits, the first-hit
    fill, a center with no hit (filled with 0), u > n, M and N off the
    warps and tiles, U = 256 (fewer centers a block, so that their hits fit
    its shared memory); then the same centers in a dense cluster, where
    every center stops at its U-th hit, through the public op."""
    x = _room(dev, 2, n)
    c = _room(dev, 2, m, seed=1)
    c[:, 0] += 10.0                              # no hit
    c[:, 1] = x[:, 0]                            # on a point
    got = _ball_query_check(c, x, radius, u)
    assert (got[:, 0] == 0).all()
    xd = 0.5 + torch.rand(2, n, 3, device=dev) * (radius / 8)
    cd = 0.5 + torch.rand(2, m, 3, device=dev) * (radius / 8)
    got = _ball_query_check(cd, xd, radius, u)
    k = min(u, n)
    assert torch.equal(got[..., :k].cpu(), torch.arange(k, dtype=torch.int32)
                       .expand(2, m, k))
    assert torch.equal(got, ops.ball_query(cd, xd, radius, u))


@pytest.mark.parametrize("u", [2048, 4096])
@pytest.mark.parametrize("m,n", [(40, 1500), (300, 3000), (70, 9000)])
@pytest.mark.parametrize("cloud", ["room", "cluster"])
def test_ball_query_kernel_many_neighbors(dev, cloud, m, n, u):
    """Above U = 1,750 the hits live in device memory (the plan's
    device_hits), with N below and above U: exact against the plain
    version on random clouds (the fill, a center without hits) and dense
    clusters (every center stops at its U-th hit, or takes every point),
    with one split and with several."""
    from pvcnn_tpu_torch.ops import neighbors

    assert neighbors._ball_query_plan(2, m, n, u, 132).device_hits
    if cloud == "room":
        x, c, radius = _room(dev, 2, n), _room(dev, 2, m, seed=3), 0.6
        c[:, 0] += 10.0                          # no hit
    else:
        x = 0.5 + torch.rand(2, n, 3, device=dev) * 0.01
        c, radius = x[:, 5:5 + m].contiguous(), 0.1
    got = _ball_query_check(c, x, radius, u)
    if cloud == "cluster":
        k = min(u, n)
        assert torch.equal(got[..., :k].cpu(),
                           torch.arange(k, dtype=torch.int32).expand(2, m, k))
    else:
        assert (got[:, 0] == 0).all()


@pytest.mark.parametrize("plan", [(32, 1, 8192, True), (256, 4, 2304, True),
                                  (64, 2, 4096, True)])
@pytest.mark.parametrize("u", [1, 32, 2048])
def test_ball_query_kernel_device_hits_plans(dev, monkeypatch, plan, u):
    """The device-memory path under forced plans (one split and several,
    32 to 256 centers a block) gives the plain version's indices, also at U
    that would fit shared memory."""
    from pvcnn_tpu_torch.ops import neighbors

    n = 8100
    x = 0.5 + torch.rand(2, n, 3, device=dev) * 0.01
    c = torch.cat([x[:, 7:207], _room(dev, 2, 100, seed=4)], dim=1)
    monkeypatch.setattr(neighbors, "_ball_query_plan",
                        lambda *a: neighbors.BallQueryPlan(*plan))
    _ball_query_check(c.contiguous(), x, 0.1, u)


@pytest.mark.parametrize("plan", [(32, 1, 8192), (64, 2, 4096),
                                  (128, 3, 2816), (256, 5, 1792),
                                  (32, 32, 256), (128, 7, 1280)])
@pytest.mark.parametrize("cloud", ["room", "cluster"])
@pytest.mark.parametrize("u", [1, 8, 32, 64])
def test_ball_query_kernel_splits(dev, monkeypatch, plan, cloud, u):
    """Every launch K7 takes gives the plain version's indices: 32 to 256
    centers a block, 1 to 32 splits of whole tiles (the last one short) over
    N = 8,100 points, random clouds (the fill) and dense clusters (early
    stop in every split)."""
    from pvcnn_tpu_torch.ops import neighbors

    n = 8100
    if cloud == "room":
        x, c, radius = _room(dev, 3, n), _room(dev, 3, 300, seed=2), 0.05
    else:
        x = 0.5 + torch.rand(3, n, 3, device=dev) * 0.01
        c, radius = x[:, 7:307].contiguous(), 0.1
    monkeypatch.setattr(neighbors, "_ball_query_plan",
                        lambda *a: neighbors.BallQueryPlan(*plan))
    _ball_query_check(c, x, radius, u)


def _nn_cloud(dev, b, n, m, seed=0):
    """Queries and centers with many ties: duplicated queries (_room),
    centers 8-11 copies of 2-5 and, where M allows, copies of centers on
    either side of M / 2, 16 and 64 (run boundaries of many plans), with
    queries on them."""
    x = _room(dev, b, n, seed=seed)
    c = _room(dev, b, m, seed=seed + 2)
    if m >= 16:
        c[:, 8:12] = c[:, 2:6]
    for at in {m // 2, 16, 64}:
        if 2 <= at < m - 1:
            c[:, at] = c[:, at - 1]
            c[:, at + 1] = c[:, 0]
    k = min(n, m, 12)
    x[:, :k] = c[:, :k]
    return x, c


def _three_nn_check(x, c):
    """K8's indices and d² exactly equal the plain version's, one launch
    counted, two runs bitwise equal."""
    from pvcnn_tpu_torch.ops import interpolate

    before = kernels.KERNELS["three_nn"].launches
    idx, d2 = interpolate._three_nn_cuda(x, c)
    assert kernels.KERNELS["three_nn"].launches == before + 1
    want_idx, want_d2 = interpolate._three_nn_plain(x, c)
    assert torch.equal(idx, want_idx)
    assert torch.equal(d2, want_d2)
    again = interpolate._three_nn_cuda(x, c)
    assert torch.equal(idx, again[0]) and torch.equal(d2, again[1])


_NN_EDGES = (1, 2, 3, 31, 32, 33, 255, 257, 1025, 8193, 20000)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("m", _NN_EDGES)
@pytest.mark.parametrize("n", _NN_EDGES)
def test_three_nn_kernel(dev, n, m, b):
    """Indices and d² exactly equal the plain version's under the plan's
    launch (ties to the lower index, also across run boundaries; M < 3 with
    idx 0 and d² = inf), two runs bitwise equal, at N and M off the warps,
    quads and stages."""
    if b * n * m > 2e8:
        b = 1                                   # the plain version's memory
    x, c = _nn_cloud(dev, b, n, m)
    _three_nn_check(x, c)


def _nn_plans():
    """(N, M, runs, threads a block, hit masks) for every launch K8 takes
    with 1-8 runs, 64-256 threads and both scans."""
    return [(n, m, runs, threads, masks)
            for n, m in ((8192, 1024), (1000, 257), (300, 33), (77, 8),
                         (40, 3000))
            for runs in (1, 2, 4, 8)
            for threads in (64, 128, 256) for masks in (False, True)
            if threads >= 32 * runs and (runs - 1) * -(-m // runs) < m]


@pytest.mark.parametrize("n,m,runs,threads,masks", _nn_plans())
def test_three_nn_kernel_plans(dev, monkeypatch, n, m, runs, threads, masks):
    """Every launch K8 takes gives the plain version's indices and d²: 1-8
    runs of centers (the last one short, ties across their boundaries),
    64-256 threads a block, a branch a pair or hit masks over 32-center
    chunks (a chunk past the run's end padded), 3 clouds."""
    from pvcnn_tpu_torch.ops import interpolate

    per_run = -(-m // runs)
    monkeypatch.setattr(interpolate, "_three_nn_plan",
                        lambda *a: interpolate.ThreeNNPlan(
                            runs, per_run, threads, masks))
    x, c = _nn_cloud(dev, 3, n, m, seed=n + m)
    _three_nn_check(x, c)


def test_three_nn_kernel_refuses_bad_plans(dev, monkeypatch):
    """A plan the launcher does not take raises; nothing falls back."""
    from pvcnn_tpu_torch.ops import interpolate

    x, c = _nn_cloud(dev, 2, 100, 40)
    for plan in ((1, 39, 128), (16, 3, 512), (2, 19, 64), (4, 10, 64),
                 (2, 40, 128), (1, 40, 288), (1, 40, 96), (3, 14, 192),
                 (1, 40, 128, 2)):
        monkeypatch.setattr(interpolate, "_three_nn_plan",
                            lambda *a, p=plan: interpolate.ThreeNNPlan(*p))
        with pytest.raises(RuntimeError, match="launch failed"):
            interpolate._three_nn_cuda(x, c)


@pytest.mark.parametrize("b,k,bins,c", [(2, 32768, 8192, 32),
                                        (3, 192, 16, 512),
                                        (2, 100, 300, 5)])
def test_scatter_sum_kernel(dev, b, k, bins, c):
    """K1's sum mode against scatter_add_, bitwise equal over two runs; the
    take_rows backward launches it."""
    from pvcnn_tpu_torch.ops import voxelize

    values = torch.randn(b, k, c, device=dev)
    idx = torch.randint(0, bins, (b, k), device=dev, dtype=torch.int32)
    before = kernels.KERNELS["scatter_sum"].launches
    got = ops.scatter_sum(values, idx, bins)
    assert kernels.KERNELS["scatter_sum"].launches == before + 1
    torch.testing.assert_close(got, voxelize._scatter_sum_plain(
        values, idx, bins), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.scatter_sum(values, idx, bins))
    table = torch.randn(b, bins, c, device=dev, requires_grad=True)
    (grad,) = torch.autograd.grad(ops.take_rows(table, idx), table, values)
    assert torch.equal(grad, got)


def _k1_bin_major(mean, values, idx, bins):
    if mean:
        return ops.scatter_mean(values, idx, bins, channels_first=False)
    return ops.scatter_sum(values, idx, bins)


@pytest.mark.parametrize("spread", ["one_bin", "few_bins"])
@pytest.mark.parametrize("c", [5, 9, 32, 130, 512])
@pytest.mark.parametrize("mean", [False, True])
def test_k1_bin_major_kernel(dev, mean, c, spread):
    """K1's bin-major mapping (scatter_sum; scatter_mean channel-last)
    against its plain version, two runs bitwise equal: every row in one bin
    (one lane group walks the whole run), or 6 bins of 512 holding all rows
    (most bins empty); channel counts on both sides of the float4 path and
    of the lane group's width."""
    k, bins = 1500, 512
    if spread == "one_bin":
        idx = torch.full((2, k), 300, dtype=torch.int32, device=dev)
        idx[1] = 0
    else:
        idx = torch.randint(0, 6, (2, k), dtype=torch.int32, device=dev) * 97
    values = torch.randn(2, k, c, device=dev)
    name = "avg_voxelize" if mean else "scatter_sum"
    before = kernels.KERNELS[name].launches
    got = _k1_bin_major(mean, values, idx, bins)
    assert kernels.KERNELS[name].launches == before + 1
    if mean:
        want = voxelize._scatter_mean_plain(values, idx, bins, False)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        want = voxelize._scatter_sum_plain(values, idx, bins)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, _k1_bin_major(mean, values, idx, bins))
    assert int((got != 0).any(-1).sum()) == int((want != 0).any(-1).sum())


@pytest.mark.parametrize("mean", [False, True])
def test_k1_bin_major_unaligned_rows(dev, mean):
    """Rows that start off a 16-byte boundary take the scalar path (C = 32
    would take float4 loads) and give the same result."""
    values = torch.randn(2 * 300 * 32 + 1, device=dev)[1:].view(2, 300, 32)
    idx = torch.randint(0, 64, (2, 300), dtype=torch.int32, device=dev)
    got = _k1_bin_major(mean, values, idx, 64)
    assert torch.equal(got, _k1_bin_major(mean, values.clone(), idx, 64))


def test_point_kernels_reject_what_they_do_not_take(dev):
    from pvcnn_tpu_torch.ops import sampling

    with pytest.raises(ValueError, match="N > 0"):
        ops.furthest_point_sample_indices(torch.rand(1, 0, 3, device=dev), 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        # 32 threads of one point each cannot hold 100 points
        sampling._fps_cuda(torch.rand(1, 100, 3, device=dev), 4, (1, 32, 1))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ball_query(torch.rand(1, 4, 3, device=dev), torch.rand(1, 8, 3),
                       0.1, 4)
    with pytest.raises(ValueError, match=r"\[B, N, 3\]"):
        ops.three_nn(torch.rand(1, 4, 2, device=dev),
                     torch.rand(1, 8, 3, device=dev))
    with pytest.raises(ValueError, match="float32"):
        ops.scatter_sum(torch.rand(1, 4, 2, device=dev, dtype=torch.float64),
                        torch.zeros(1, 4, dtype=torch.int32, device=dev), 3)


@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("has_prologue,slope", [(False, 0.0), (True, 0.0),
                                                (True, 0.1)])
@pytest.mark.parametrize("rows,ci,co", [(1024, 9, 64), (1000, 130, 70),
                                        (2048, 512, 256)])
def test_dense_rows_kernel(dev, rows, ci, co, has_prologue, slope,
                           want_stats):
    """K9 against its plain version (ragged row, channel and column tiles
    included), statistics within 1e-4 of the sum of magnitudes, two runs
    bitwise equal."""
    from pvcnn_tpu_torch.ops import dense_rows

    args = (torch.randn(rows, ci, device=dev),
            torch.randn(ci, co, device=dev) / ci ** 0.5,
            torch.randn(co, device=dev), torch.rand(ci, device=dev) + 0.5,
            torch.randn(ci, device=dev), slope, has_prologue, want_stats)
    before = kernels.KERNELS["dense_rows_fwd"].launches
    y, s1, s2 = dense_rows._forward_cuda(*args)
    assert kernels.KERNELS["dense_rows_fwd"].launches == before + 1
    want, w1, w2 = dense_rows._forward_plain(*args)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s1, w1, rtol=1e-4,
                               atol=1e-4 * want.abs().sum().item() / co)
    torch.testing.assert_close(s2, w2, rtol=1e-4, atol=0)
    again = dense_rows._forward_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("rows,ci,co", [(1024, 9, 64), (1000, 130, 70),
                                        (4096, 128, 1024)])
def test_dense_rows_wgrad_kernel(dev, rows, ci, co, has_prologue):
    """K10 (dW and d(bias) in one pass) against its plain version, within
    1e-4 of the largest entry; two runs bitwise equal."""
    from pvcnn_tpu_torch.ops import dense_rows

    args = (torch.randn(rows, ci, device=dev), torch.randn(rows, co, device=dev),
            torch.rand(ci, device=dev) + 0.5, torch.randn(ci, device=dev),
            0.1, has_prologue)
    before = kernels.KERNELS["dense_rows_wgrad"].launches
    dw, db = dense_rows._wgrad_cuda(*args)
    assert kernels.KERNELS["dense_rows_wgrad"].launches == before + 1
    want_dw, want_db = dense_rows._wgrad_plain(*args)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4,
                               atol=1e-4 * want_dw.abs().max().item())
    torch.testing.assert_close(db, want_db, rtol=1e-4,
                               atol=1e-4 * want_db.abs().max().item())
    again = dense_rows._wgrad_cuda(*args)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


@pytest.mark.parametrize("has_prologue,want_stats", [(False, True),
                                                     (True, False)])
def test_dense_rows_grads_on_card(dev, has_prologue, want_stats):
    """The op's backward on the card (K9 as the dgrad, K10) against the same
    op on the CPU, with cotangents on y, s1 and s2."""
    t = [torch.randn(4, 256, 33, device=dev),
         torch.randn(33, 70, device=dev) * 0.2, torch.randn(70, device=dev),
         torch.rand(33, device=dev) + 0.5, torch.randn(33, device=dev)]
    for x in t:
        x.requires_grad_()
    cot = [torch.randn(4, 256, 70, device=dev),
           torch.randn(70, device=dev) * 0.1,
           torch.randn(70, device=dev) * 0.01]
    counts = kernels.launch_counts()
    out = ops.dense_rows_act(*t, 0.1, has_prologue, want_stats)
    got = torch.autograd.grad(out, t, cot, allow_unused=True)
    after = kernels.launch_counts()
    for name in ("dense_rows_fwd", "dense_rows_dgrad", "dense_rows_wgrad"):
        assert after[name] == counts[name] + 1
    tc = _cpu_twin(t)
    want = torch.autograd.grad(
        ops.dense_rows_act(*tc, 0.1, has_prologue, want_stats), tc,
        [c.cpu() for c in cot], allow_unused=True)
    _grads_close(got, want)


def _ndhwc_check(x, g):
    """K11 against its plain version (27 shifted-slice products) and
    cuDNN's weight gradient, within 1e-4 of the largest entry; one launch
    counted, two runs bitwise equal; -> (K11's dW, its tolerance scale)."""
    before = kernels.KERNELS["conv3d_ndhwc_wgrad"].launches
    got = conv3d._ndhwc_wgrad_cuda(x, g, 3)
    assert kernels.KERNELS["conv3d_ndhwc_wgrad"].launches == before + 1
    want = conv3d._ndhwc_wgrad_plain(x, g, 3)
    scale = max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(got, conv3d._ndhwc_wgrad_cuda(x, g, 3))
    lib = torch.nn.grad.conv3d_weight(x.permute(0, 4, 1, 2, 3), want.shape,
                                      g.permute(0, 4, 1, 2, 3), padding=1)
    torch.testing.assert_close(got, lib, rtol=1e-4, atol=1e-4 * scale)
    return got, scale


@pytest.mark.parametrize("b,r,ci,co", list(itertools.product(
    [1, 3], [1, 5, 8, 12, 16, 32], [1, 6, 9, 32, 64, 128, 257],
    [1, 16, 32, 33, 64, 130])) + [(1, 12, 130, 70)])
def test_conv3d_ndhwc_wgrad_kernel(dev, b, r, ci, co):
    """K11 at K4's grid: every tile (Co <= 32 and wider, ragged row and
    column tiles), z-segment length (8 at R <= 8 with zero-filled ends at
    R = 1 and 5, 16 at R = 12 and 16, 32) and the plan's splits, one cloud
    and three; R = 12 with Ci not a multiple of 4 stages x's rows 16 bytes
    at a time with a zero-filled segment end; through conv3d_same's
    backward with a non-contiguous cotangent."""
    x = torch.randn(b, r, r, r, ci, device=dev)
    g = torch.randn(b, r, r, r, co, device=dev)
    got, scale = _ndhwc_check(x, g)
    w = torch.randn(co, ci, 3, 3, 3, device=dev, requires_grad=True)
    gt = g.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    (dw,) = torch.autograd.grad(ops.conv3d_same(x, w), w, gt)
    torch.testing.assert_close(dw, got, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 7, 40])
@pytest.mark.parametrize("r", [8, 16, 32])
def test_ndhwc_wgrad_split_boundaries(dev, monkeypatch, r, splits):
    """K11 with its reduction split in runs that end inside a cloud and at
    and across cloud boundaries (B = 3), with and without runs longer than
    the 16 slices after which a block folds its accumulators."""
    plan = conv3d._wgrad_plan

    def forced(*a):
        p = plan(*a)
        per = -(-p.slices // splits)
        return p._replace(splits=-(-p.slices // per))

    monkeypatch.setattr(conv3d, "_wgrad_plan", forced)
    x = torch.randn(3, r, r, r, 32, device=dev)
    g = torch.randn(3, r, r, r, 64, device=dev)
    _ndhwc_check(x, g)


def test_ndhwc_wgrad_views(dev):
    """Inputs that are views: a channel-last x permuted from a channel-major
    grid, and a cotangent at an offset that is not 16-byte aligned with
    odd channel counts (every copy of K11 moves 4 bytes)."""
    r = 8
    x = torch.randn(3, 7, r, r, r, device=dev).permute(0, 2, 3, 4, 1)
    flat = torch.randn(3 * r ** 3 * 33 + 1, device=dev)
    g = flat[1:].reshape(3, r, r, r, 33)
    _ndhwc_check(x, g)


def test_new_kernels_reject_what_they_do_not_take(dev):
    from pvcnn_tpu_torch.ops import dense_rows

    x = torch.randn(1024, 8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        dense_rows._forward_cuda(x.double(), torch.randn(8, 4, device=dev),
                                 torch.zeros(4, device=dev), None, None, 0.0,
                                 False, True)
    with pytest.raises(ValueError, match="CUDA device"):
        dense_rows._wgrad_cuda(x, torch.randn(1024, 4), None, None, 0.0,
                               False)
    with pytest.raises(ValueError, match="weight"):
        dense_rows._forward_cuda(x, torch.randn(4, 8, device=dev),
                                 torch.zeros(8, device=dev), None, None, 0.0,
                                 False, True)
    grid = torch.randn(1, 4, 4, 4, 3, device=dev)
    with pytest.raises(ValueError, match="3x3x3"):
        conv3d._ndhwc_wgrad_cuda(grid, torch.randn(1, 4, 4, 4, 5, device=dev),
                                 5)
    with pytest.raises(ValueError, match="cubic"):
        conv3d._ndhwc_wgrad_cuda(grid, torch.randn(1, 4, 4, 2, 5, device=dev),
                                 3)


def _k5_coords(dev, b, n, r, seed):
    """norm_coords in [0, R-1] with exact-integer points and points on the
    R-1 plane of each axis and of all three (collapsed corners)."""
    gen = torch.Generator().manual_seed(seed)
    norm = torch.rand(b, n, 3, generator=gen) * (r - 1)
    norm[:, :16] = norm[:, :16].floor()
    for axis in range(3):
        norm[:, 16 + 8 * axis:24 + 8 * axis, axis] = r - 1
    norm[:, 40:48] = r - 1
    return norm.to(dev)


def _k5_check(g, norm, r, atol=1e-5):
    """K5 in both layouts against its plain version; the sort glue equal to
    its plain version; two runs and the two layouts bitwise equal."""
    points, bounds = devoxelize._sort_points(norm, r)
    want_points, want_bounds = devoxelize._sort_points_plain(norm, r)
    assert torch.equal(points.view(torch.int32),
                       want_points.view(torch.int32))
    assert torch.equal(bounds, want_bounds)
    before = kernels.KERNELS["devoxelize_bwd"].launches
    got = devoxelize._devoxelize_bwd_cuda(g, norm, r, True)
    assert kernels.KERNELS["devoxelize_bwd"].launches == before + 1
    want = devoxelize._devoxelize_bwd_plain(g, norm, r, True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    assert torch.equal(got, devoxelize._devoxelize_bwd_cuda(g, norm, r, True))
    last = devoxelize._devoxelize_bwd_cuda(g, norm, r, False)
    assert torch.equal(last, got.transpose(1, 2))


@pytest.mark.parametrize("r", [8, 16, 32])
@pytest.mark.parametrize("c", [1, 5, 13, 32, 130])
def test_k5_kernel(dev, c, r):
    """K5 at channel counts on and off its float4 rows and lane groups, R =
    8, 16 and 32, 777 points (a multiple of no tile), collapsed corners on
    the R-1 planes and at exact integers."""
    norm = _k5_coords(dev, 2, 777, r, seed=c + r)
    _k5_check(torch.randn(2, 777, c, device=dev), norm, r)


def test_k5_large_grid(dev):
    """R = 40: the sort's R^3 + 1 counters outgrow shared memory and live
    in the bounds buffer."""
    norm = _k5_coords(dev, 2, 777, 40, seed=40)
    _k5_check(torch.randn(2, 777, 8, device=dev), norm, 40)


@pytest.mark.parametrize("c", [5, 64])
def test_k5_one_bin(dev, c):
    """Every point of a cloud in one base bin: one run of all N points,
    walked by each of the 8 bins around it; one cloud at an exact grid
    point (7 of the 8 corners collapse). A bin sums up to 2000 terms, in
    another order than the plain version's atomics: held to 1e-5 of the
    largest entry."""
    r, n = 16, 2000
    norm = 5.0 + torch.rand(2, n, 3, device=dev) * 0.999
    norm[1] = 9.0
    g = torch.randn(2, n, c, device=dev)
    scale = devoxelize._devoxelize_bwd_plain(g, norm, r, True).abs().max()
    _k5_check(g, norm, r, atol=1e-5 * scale.item())


@pytest.mark.parametrize("has_prologue,want_stats", [(False, False),
                                                     (False, True),
                                                     (True, True),
                                                     (True, False)])
@pytest.mark.parametrize("b,ci,co,r", [(2, 16, 16, 12), (3, 32, 32, 16),
                                       (2, 9, 32, 16), (2, 64, 33, 8),
                                       (32, 128, 128, 8), (32, 256, 256, 8),
                                       (2, 6, 64, 5), (2, 33, 16, 8),
                                       (1, 2049, 24, 4), (1, 24, 2049, 4)])
def test_conv3d_tiles(dev, b, ci, co, r, has_prologue, want_stats):
    """K3's forward at each tile (Co <= 32 and wider) and split of its
    reduction (R = 8 at B = 32, Ci = Co in {128, 256}; the few blocks of
    B = 2 and 1), the unaligned table (Ci = 6, 9; Ci = 2049 rebuilds it 54
    times, from slice offsets that split blocks start at): against the
    plain version, statistics within 1e-4, two runs bitwise equal; and as
    the dgrad onto 16, 32, 33 and 2049 channels among others, and from
    2049."""
    x = torch.randn(b, ci, r ** 3, device=dev)
    w = torch.randn(co, ci, 3, 3, 3, device=dev) / (27 * ci) ** 0.5
    bias = torch.randn(co, device=dev)
    scale = torch.rand(ci, device=dev) + 0.5
    shift = torch.randn(ci, device=dev)
    args = (x, w, bias, scale, shift, r, has_prologue, want_stats)
    y, s1, s2 = conv3d._forward_cuda(*args)
    want, w1, w2 = conv3d._forward_plain(*args)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    if want_stats:
        torch.testing.assert_close(s1, w1, rtol=1e-4,
                                   atol=1e-4 * want.abs().sum().item() / co)
        torch.testing.assert_close(s2, w2, rtol=1e-4, atol=0)
    again = conv3d._forward_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
    gy = torch.randn(b, co, r ** 3, device=dev)
    dx = conv3d._dgrad_cuda(gy, w, r)
    torch.testing.assert_close(dx, conv3d._dgrad_plain(gy, w, r), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(dx, conv3d._dgrad_cuda(gy, w, r))


def _dense_inputs(dev, rows, ci, co, layout="columns"):
    """x [rows, Ci], the weight [Ci, Co] in `layout` ("columns": the fused
    SharedMLP's transposed view of a [Co, Ci] weight; "rows": contiguous),
    bias, prologue scale and shift, a cotangent g [rows, Co]."""
    w = torch.randn(co, ci, device=dev) / ci ** 0.5
    w = w.t() if layout == "columns" else w.t().contiguous()
    return (torch.randn(rows, ci, device=dev), w, torch.randn(co, device=dev),
            torch.rand(ci, device=dev) + 0.5, torch.randn(ci, device=dev),
            torch.randn(rows, co, device=dev))


def _dense_check(dev, rows, ci, co, has_prologue, layout="columns"):
    """K9 (with statistics), the dgrad and K10 against their plain versions
    (K9 and the statistics at test_dense_rows_kernel's tolerances; the
    dgrad against g @ w.t() too; K10 within 1e-4 of the largest entry),
    two runs bitwise equal, one launch a call. Returns the outputs. Below
    1,000 rows a channel's s2 is a sum of a few squares, each carrying y's
    own error (its atol 1e-4): there s2 is held to 2e-4 of sum |y| too."""
    from pvcnn_tpu_torch.ops import dense_rows

    x, w, bias, scale, shift, g = _dense_inputs(dev, rows, ci, co, layout)
    args = (x, w, bias, scale, shift, 0.1, has_prologue, True)
    counts = kernels.launch_counts()
    y, s1, s2 = dense_rows._forward_cuda(*args)
    dx = dense_rows._dgrad_cuda(g, w)
    dw, db = dense_rows._wgrad_cuda(x, g, scale, shift, 0.1, has_prologue)
    after = kernels.launch_counts()
    for name in ("dense_rows_fwd", "dense_rows_dgrad", "dense_rows_wgrad"):
        assert after[name] == counts[name] + 1
    want, w1, w2 = dense_rows._forward_plain(*args)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s1, w1, rtol=1e-4,
                               atol=1e-4 * want.abs().sum().item() / co)
    if rows >= 1000:
        torch.testing.assert_close(s2, w2, rtol=1e-4, atol=0)
    else:
        assert ((s2 - w2).abs() <= 1e-4 * w2.abs()
                + 2e-4 * want.abs().sum(0)).all()
    torch.testing.assert_close(dx, dense_rows._dgrad_plain(g, w), rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(dx, g @ w.t(), rtol=1e-4, atol=1e-4)
    want_dw, want_db = dense_rows._wgrad_plain(x, g, scale, shift, 0.1,
                                               has_prologue)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4,
                               atol=1e-4 * want_dw.abs().max().item())
    torch.testing.assert_close(db, want_db, rtol=1e-4,
                               atol=1e-4 * want_db.abs().max().item())
    again = (*dense_rows._forward_cuda(*args), dense_rows._dgrad_cuda(g, w),
             *dense_rows._wgrad_cuda(x, g, scale, shift, 0.1, has_prologue))
    assert all(torch.equal(a, b)
               for a, b in zip((y, s1, s2, dx, dw, db), again))
    return y, s1, s2, dx, dw, db


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("rows", [1, 37, 127, 128, 129, 1000])
@pytest.mark.parametrize("ci,co", [(9, 64), (9, 70), (130, 70), (130, 64),
                                   (64, 130), (4, 4)])
def test_dense_rows_ragged(dev, ci, co, rows, has_prologue):
    """K9, its dgrad and K10 on rows that fill no tile or one tile and a
    row, on unaligned rows (Ci = 9 and 130: 36 and 520 bytes) and columns
    (Co = 70, 130), the weight in the SharedMLP's layout."""
    _dense_check(dev, rows, ci, co, has_prologue)


@pytest.mark.parametrize("ci,co", [(9, 64), (64, 64), (64, 128), (128, 1024),
                                   (512, 256), (130, 70)])
def test_dense_rows_weight_layouts(dev, ci, co):
    """The weight read by rows (contiguous [Ci, Co]) and by columns (the
    SharedMLP's view) in place: the same products in the same order, so
    K9, the dgrad and K10 are bitwise equal across the two layouts."""
    torch.manual_seed(1)
    by_columns = _dense_check(dev, 1000, ci, co, False, "columns")
    torch.manual_seed(1)
    by_rows = _dense_check(dev, 1000, ci, co, False, "rows")
    assert all(torch.equal(a, b) for a, b in zip(by_columns, by_rows))


def _calls3_on_dense():
    import chip_smoke

    return sorted({c[:2] for (k, c), _ in chip_smoke.CALLS3_ON.items()
                   if k == "dense_rows_fwd"})


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("ci,co", _calls3_on_dense())
def test_dense_rows_opt_in_shapes(dev, ci, co, has_prologue):
    """Every K9 / dgrad / K10 shape of the S3DIS PVCNN opt-in step
    (chip_smoke.CALLS3_ON) at 4,133 rows (32 row tiles and a ragged one;
    K10 then splits its rows in 16 chunks, or one where Ci <= 64)."""
    _dense_check(dev, 4133, ci, co, has_prologue)


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("chunk", [32, 96, 4096, 8192])
@pytest.mark.parametrize("ci,co", [(9, 64), (130, 70), (128, 256)])
def test_dense_rows_wgrad_fold(dev, monkeypatch, ci, co, chunk,
                               has_prologue):
    """K10's chunks and their fold kernel: forced chunks of 1, 3 and 128
    slices (4,100 rows: 129, 43 and 2 chunks, the last ones ragged) and one
    chunk of all rows against the plain version; any chunking within the
    same tolerance of the one-chunk result."""
    from pvcnn_tpu_torch.ops import dense_rows

    plan = dense_rows._plan
    monkeypatch.setattr(dense_rows, "_plan", lambda *a: plan(*a)._replace(
        chunk=chunk, splits=-(-4100 // chunk),
        partial_bytes=4 * -(-4100 // chunk) * (ci * co + co)))
    x, _, _, scale, shift, g = _dense_inputs(dev, 4100, ci, co)
    dw, db = dense_rows._wgrad_cuda(x, g, scale, shift, 0.1, has_prologue)
    want_dw, want_db = dense_rows._wgrad_plain(x, g, scale, shift, 0.1,
                                               has_prologue)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4,
                               atol=1e-4 * want_dw.abs().max().item())
    torch.testing.assert_close(db, want_db, rtol=1e-4,
                               atol=1e-4 * want_db.abs().max().item())
    again = dense_rows._wgrad_cuda(x, g, scale, shift, 0.1, has_prologue)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


def test_dense_rows_reject_what_they_do_not_take(dev):
    from pvcnn_tpu_torch.ops import dense_rows

    x, w, bias, _, _, g = _dense_inputs(dev, 300, 8, 4)
    with pytest.raises(ValueError, match="float32"):
        dense_rows._dgrad_cuda(g.double(), w)
    with pytest.raises(ValueError, match="CUDA device"):
        dense_rows._dgrad_cuda(g, w.cpu())
    with pytest.raises(ValueError, match="does not match"):
        dense_rows._dgrad_cuda(g, w.t())
    with pytest.raises(ValueError, match="differ in rows"):
        dense_rows._wgrad_cuda(x, g[:-1], None, None, 0.0, False)
    with pytest.raises(ValueError, match="prologue"):
        dense_rows._forward_cuda(x, w, bias, torch.ones(3, device=dev),
                                 torch.zeros(3, device=dev), 0.0, True, True)


# ---- the KITTI Frustum paths' shapes ---------------------------------------


def _frustum_points(dev, b, n, seed=0):
    """[b, n, 3] synthetic frustum clouds (data/kitti/frustum.py): an
    object's box holding 30-60% of the points, the rest spread over tens
    of metres of depth."""
    import numpy as np

    from pvcnn_tpu_torch.data.kitti.frustum import synthetic_batch

    inputs, _ = synthetic_batch(np.random.RandomState(seed), b, n)
    return torch.from_numpy(inputs["features"][..., :3]).to(dev)


@pytest.mark.parametrize("ci,co,r", [(4, 64, 16), (64, 128, 12)])
def test_conv3d_frustum_shapes(dev, ci, co, r):
    """FrustumPVCNNE's first conv (Ci = 4: 7 reduction splits of
    ceil(27 Ci / 16) slices) and its R = 12 conv (1,728 voxels, off K3's
    128-voxel span): K3's forward with and without its prologue and
    statistics (the unfused branch), its dgrad and K4, at B = 32, against
    the plain versions."""
    b = 32
    x = torch.randn(b, ci, r ** 3, device=dev)
    w = torch.randn(co, ci, 3, 3, 3, device=dev) * 0.1
    bias = torch.randn(co, device=dev)
    scale = torch.rand(ci, device=dev) + 0.5
    shift = torch.randn(ci, device=dev)
    for pro in (False, True):
        args = (x, w, bias, scale, shift, r, pro)
        for stats in (False, True):
            y, s1, s2 = conv3d._forward_cuda(*args, stats)
            want, w1, w2 = conv3d._forward_plain(*args, stats)
            torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
            if stats:
                torch.testing.assert_close(
                    s1, w1, rtol=1e-4, atol=1e-4 * want.abs().sum().item()
                    / co)
                torch.testing.assert_close(s2, w2, rtol=1e-4, atol=0)
            assert torch.equal(y, conv3d._forward_cuda(*args, stats)[0])
        x_, gy, scale_, shift_ = _wgrad_inputs(dev, b, ci, co, r)
        _wgrad_check((x_, gy, scale_, shift_, r, pro))
    gy = torch.randn(b, co, r ** 3, device=dev)
    got = conv3d._dgrad_cuda(gy, w, r)
    torch.testing.assert_close(got, conv3d._dgrad_plain(gy, w, r),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got, conv3d._dgrad_cuda(gy, w, r))


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("c", [4, 64])
def test_k1_k2_k5_at_r12(dev, c, channels_first):
    """K1, K2 and K5 at R = 12 on 32 frustum clouds of 1,024 points (the
    object's points crowd a few bins, the rest spread thin), both layouts,
    against the plain versions. K5 sums hundreds of terms into an
    object's bins, and the plain version adds them by atomics in any
    order: it is held, as chip_smoke.py holds it, to an fp64 sum at 1e-6
    of each output's sum of |terms| and to the plain version at that
    bound (at least 1e-5)."""
    r, n = 12, 1024
    pts = _frustum_points(dev, 32, n)
    vox, norm = ops.normalize_coords(pts, r, normalize=True)
    flat = ops.flat_voxel_index(vox, r)
    _k1_check(torch.randn(32, n, c, device=dev), flat, r ** 3,
              channels_first)
    grid = torch.randn(32, c, r ** 3, device=dev)
    if not channels_first:
        grid = grid.transpose(1, 2).contiguous()
    got = devoxelize._devoxelize_cuda(grid, norm, r, channels_first)
    torch.testing.assert_close(
        got, devoxelize._devoxelize_plain(grid, norm, r, channels_first),
        rtol=1e-5, atol=1e-6)
    g = torch.randn(32, n, c, device=dev)
    got = devoxelize._devoxelize_bwd_cuda(g, norm, r, channels_first)
    mag = devoxelize._devoxelize_bwd_plain(g.abs(), norm, r, channels_first)
    exact = devoxelize._devoxelize_bwd_plain(g.double(), norm.double(), r,
                                             channels_first)
    assert ((got - exact).abs() <= 1e-6 * mag + 1e-12).all()
    want = devoxelize._devoxelize_bwd_plain(g, norm, r, channels_first)
    assert ((got - want).abs()
            <= 1e-5 * want.abs() + (1e-6 * mag).clamp(min=1e-5)).all()
    assert torch.equal(got, devoxelize._devoxelize_bwd_cuda(
        g, norm, r, channels_first))


@pytest.mark.parametrize("n,m", [(1024, 128), (512, 128), (128, 32)])
def test_fps_frustum_shapes(dev, n, m):
    """K6 at FrustumPointNet2's cases on frustum clouds (B = 24): indices
    equal the plain version's."""
    from pvcnn_tpu_torch.ops import sampling

    x = _frustum_points(dev, 24, n, seed=n)
    got = ops.furthest_point_sample_indices(x, m)
    assert torch.equal(got, sampling._fps_plain(x, m))
    assert torch.equal(got, ops.furthest_point_sample_indices(x, m))


@pytest.mark.parametrize("radius,u", [(0.2, 32), (0.4, 64), (0.8, 128)])
def test_ball_query_sparse_frustum(dev, radius, u):
    """K7 at FrustumPointNet2's SA1 (1,024 points, 128 FPS centers) on
    sparse frustum clouds, where most centers hold few hits and fill U by
    repeating their first: indices equal the plain version's."""
    from pvcnn_tpu_torch.ops import sampling

    x = _frustum_points(dev, 24, 1024, seed=3)
    c = sampling.furthest_point_sample(x, 128)
    got = _ball_query_check(c, x, radius, u)
    filled = (got[..., -1] == got[..., 0]).float().mean().item()
    assert filled > 0.5                      # most centers take the fill


@pytest.mark.parametrize("n,m", [(32, 1), (128, 32), (1024, 128)])
def test_three_nn_frustum_shapes(dev, n, m):
    """K8 at FrustumPointNet2's feature propagations on frustum clouds (B =
    24): 32 queries against the group-all level's one zero center (two
    slots with d² = inf), and the two FP levels above it; indices and d²
    exactly the plain version's, and the interpolation weights too."""
    from pvcnn_tpu_torch.ops import interpolate

    x = _frustum_points(dev, 24, n, seed=n)
    c = (torch.zeros(24, 1, 3, device=dev) if m == 1
         else x[:, :m].contiguous())
    _three_nn_check(x, c)
    idx, d2 = interpolate._three_nn_cuda(x, c)
    if m == 1:
        assert torch.isinf(d2[..., 1:]).all() and (idx == 0).all()
    assert torch.equal(interpolate._weights_from_d2(d2),
                       interpolate._weights_from_d2(
                           interpolate._three_nn_plain(x, c)[1]))


@pytest.mark.parametrize("co,r", [(64, 16), (64, 12)])
def test_ndhwc_wgrad_ci4(dev, co, r):
    """K11 at FrustumPVCNNE's first conv (Ci = 4) on the opt-in path, B =
    32: z-slots of one channel quad (`last_slots`), against the plain
    version and cuDNN's weight gradient."""
    ci = 4
    x = torch.randn(32, r, r, r, ci, device=dev)
    g = torch.randn(32, r, r, r, co, device=dev)
    plan = conv3d._wgrad_plan(32, ci, co, r, conv3d._sm_count(dev.index or 0))
    assert conv3d._ndhwc_layout(ci, plan) == "last_slots"
    _ndhwc_check(x, g)


# ---- the bf16 modes of K1-K5 ------------------------------------------------

def _bf16_close(got, want, scale=None):
    """bf16 outputs within two bf16 roundings of want's scale (the kernel
    and the plain version sum in f32 in other orders and round once)."""
    assert got.dtype == want.dtype == torch.bfloat16
    got, want = got.float(), want.float()
    scale = want.abs().max().item() if scale is None else scale
    torch.testing.assert_close(got, want, rtol=0, atol=2 ** -7 * scale)


def _counted(name, fn, *args):
    before = kernels.KERNELS[name].launches
    out = fn(*args)
    assert kernels.KERNELS[name].launches == before + 1
    return out


@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("b,ci,co,r", [
    (2, 6, 16, 8), (2, 9, 33, 5), (1, 16, 32, 16), (2, 32, 64, 8),
    (1, 64, 130, 8), (3, 1, 1, 4), (2, 128, 128, 16), (1, 20, 70, 12),
    (4, 16, 16, 32), (8, 32, 32, 16)])
def test_conv3d_bf16_kernel(dev, b, ci, co, r, has_prologue, want_stats):
    """K3's bf16 mode (both tiles, Ci % 16 == 0 and not, ragged voxel and
    channel tiles; the narrow tile at ShapeNet PVCNN 0.25x's grids)
    against its plain version: y within two bf16 roundings,
    the f32 statistics within 1e-4 of their plain sums, two runs bitwise
    equal; the dgrad and K4's bf16 mode likewise."""
    bf = torch.bfloat16
    x = torch.randn(b, ci, r ** 3, device=dev).to(bf)
    w = (torch.randn(co, ci, 3, 3, 3, device=dev) / (27 * ci) ** 0.5).to(bf)
    bias = torch.randn(co, device=dev)
    scale = torch.rand(ci, device=dev) + 0.5
    shift = torch.randn(ci, device=dev)
    args = (x, w, bias, scale, shift, r, has_prologue, want_stats)
    y, s1, s2 = _counted("conv3d_fwd_bf16", conv3d._forward_cuda, *args)
    want, w1, w2 = conv3d._forward_plain(*args)
    _bf16_close(y, want)
    if want_stats:
        yf = conv3d._conv3d_plain(
            conv3d._activated(x, scale, shift, has_prologue), w.float(),
            bias, None, None, r, False)
        torch.testing.assert_close(s1, w1, rtol=0,
                                   atol=1e-4 * yf.abs().sum(dim=(0, 2)).max())
        torch.testing.assert_close(s2, w2, rtol=1e-4, atol=1e-6)
    assert all(torch.equal(a, c) for a, c in
               zip((y, s1, s2), conv3d._forward_cuda(*args)))
    gy = torch.randn(b, co, r ** 3, device=dev).to(bf)
    dx = _counted("conv3d_dgrad_bf16", conv3d._dgrad_cuda, gy, w, r)
    _bf16_close(dx, conv3d._dgrad_plain(gy, w, r))
    assert torch.equal(dx, conv3d._dgrad_cuda(gy, w, r))
    wargs = (x, gy, scale, shift, r, has_prologue)
    dw = _counted("conv3d_wgrad_bf16", conv3d._wgrad_cuda, *wargs)
    _bf16_close(dw, conv3d._wgrad_plain(*wargs))
    assert torch.equal(dw, conv3d._wgrad_cuda(*wargs))


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 40])
def test_wgrad_bf16_splits(dev, monkeypatch, splits):
    """K4's bf16 mode at forced splits (runs of chunks across clouds, the
    last run short): the same dW within two bf16 roundings."""
    bf = torch.bfloat16
    b, ci, co, r = 3, 16, 32, 8
    x = torch.randn(b, ci, r ** 3, device=dev).to(bf)
    gy = torch.randn(b, co, r ** 3, device=dev).to(bf)
    plan = conv3d._wgrad_bf16_plan(b, ci, co, r, 132)
    per = -(-plan.chunks // splits)
    monkeypatch.setattr(conv3d, "_wgrad_bf16_plan", lambda *a: plan._replace(
        splits=-(-plan.chunks // per), per_split=per))
    _bf16_close(conv3d._wgrad_cuda(x, gy, None, None, r, False),
                conv3d._wgrad_plain(x, gy, None, None, r, False))


def _conv_bf16_case(dev, b, ci, co, r, has_prologue=True):
    bf = torch.bfloat16
    x = torch.randn(b, ci, r ** 3, device=dev).to(bf)
    w = (torch.randn(co, ci, 3, 3, 3, device=dev) / (27 * ci) ** 0.5).to(bf)
    bias = torch.randn(co, device=dev)
    scale = torch.rand(ci, device=dev) + 0.5
    shift = torch.randn(ci, device=dev)
    gy = torch.randn(b, co, r ** 3, device=dev).to(bf)
    return (x, w, bias, scale, shift, r, has_prologue), gy


# ShapeNet PVCNN's bf16 convs (Ci, Co, R) at 1x and 0.25x, at a small B
SHAPENET_BF16 = [(6, 64, 32), (64, 64, 32), (64, 128, 16), (128, 128, 16),
                 (6, 16, 32), (16, 16, 32), (16, 32, 16), (32, 32, 16)]


# S3DIS PVCNN2's (Co = 32: the N = 32 tile; Co = 256: two column blocks)
# and S3DIS PVCNN's new ones
S3DIS_BF16 = [(9, 32, 32), (32, 32, 32), (64, 64, 16), (128, 128, 8),
              (256, 256, 8), (9, 64, 32)]


@pytest.mark.parametrize("ci,co,r", SHAPENET_BF16)
def test_conv3d_bf16_shapenet_shapes(dev, ci, co, r):
    """K3, its dgrad and K4 in bf16 at the training step's channel counts
    and grids (B = 2): within two bf16 roundings of the plain versions, the
    statistics within 1e-4 of their plain sums."""
    _conv_bf16_shape(dev, ci, co, r)


@pytest.mark.parametrize("ci,co,r", S3DIS_BF16)
def test_conv3d_bf16_s3dis_shapes(dev, ci, co, r):
    """As test_conv3d_bf16_shapenet_shapes at S3DIS PVCNN2's and PVCNN's
    bf16 convs."""
    _conv_bf16_shape(dev, ci, co, r)


def _conv_bf16_shape(dev, ci, co, r):
    args, gy = _conv_bf16_case(dev, 2, ci, co, r)
    y, s1, s2 = conv3d._forward_cuda(*args, True)
    want, w1, w2 = conv3d._forward_plain(*args, True)
    _bf16_close(y, want)
    torch.testing.assert_close(s2, w2, rtol=1e-4, atol=1e-6)
    w = args[1]
    _bf16_close(conv3d._dgrad_cuda(gy, w, r), conv3d._dgrad_plain(gy, w, r))
    wargs = (args[0], gy) + args[3:]
    _bf16_close(conv3d._wgrad_cuda(*wargs), conv3d._wgrad_plain(*wargs))


def test_conv3d_bf16_no_clouds(dev):
    """B = 0: empty outputs, zero statistics and a zero dW, one launch
    counted each."""
    args, gy = _conv_bf16_case(dev, 0, 16, 32, 8)
    y, s1, s2 = _counted("conv3d_fwd_bf16", conv3d._forward_cuda, *args,
                         True)
    assert y.shape == (0, 32, 512) and not s1.any() and not s2.any()
    dx = _counted("conv3d_dgrad_bf16", conv3d._dgrad_cuda, gy, args[1], 8)
    assert dx.shape == (0, 16, 512)
    dw = conv3d._wgrad_cuda(args[0], gy, *args[3:])
    assert dw.shape == (32, 16, 3, 3, 3) and not dw.any()


@pytest.mark.parametrize("ci,co", [(16, 32), (40, 24)])
def test_conv3d_bf16_ragged_tile(dev, ci, co):
    """R = 12: K3's 8 x 8 M tile and K4's chunk ragged in both z and y (and
    x odd), the halo outside the grid on every side."""
    args, gy = _conv_bf16_case(dev, 2, ci, co, 12)
    y, s1, s2 = conv3d._forward_cuda(*args, True)
    want, w1, w2 = conv3d._forward_plain(*args, True)
    _bf16_close(y, want)
    torch.testing.assert_close(s2, w2, rtol=1e-4, atol=1e-6)
    _bf16_close(conv3d._dgrad_cuda(gy, args[1], 12),
                conv3d._dgrad_plain(gy, args[1], 12))
    wargs = (args[0], gy) + args[3:]
    _bf16_close(conv3d._wgrad_cuda(*wargs), conv3d._wgrad_plain(*wargs))


def test_conv3d_bf16_bitwise_on_another_stream(dev):
    """Two runs of K3 (with statistics), its dgrad and K4 bitwise equal, the
    second on another stream."""
    args, gy = _conv_bf16_case(dev, 4, 64, 64, 16)
    wargs = (args[0], gy) + args[3:]

    def run():
        return (conv3d._forward_cuda(*args, True)
                + (conv3d._dgrad_cuda(gy, args[1], 16),
                   conv3d._wgrad_cuda(*wargs)))

    first = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.parametrize("c,r", [(1, 8), (5, 8), (16, 16), (64, 32),
                                 (130, 16)])
def test_k1_k2_k5_bf16(dev, c, r):
    """K1's, K2's and K5's bf16 modes (channel-major) against their plain
    versions on the card and on the CPU: K1 and K2 within two bf16
    roundings of the output's scale, K5 within 2^-7 of each bin's sum of
    |terms|; two runs bitwise equal."""
    bf = torch.bfloat16
    b, n = 2, 700
    vox, norm = ops.normalize_coords(_coords(dev, b=b, n=n), r,
                                     normalize=False)
    flat = ops.flat_voxel_index(vox, r)
    flat[0, :300] = flat[0, 0]                       # a run of 300 rows
    feats = torch.randn(b, n, c, device=dev).to(bf)
    got = _counted("avg_voxelize_bf16", voxelize._scatter_mean_cuda, feats,
                   flat, r ** 3, True)[0]
    _bf16_close(got, voxelize._scatter_mean_plain(feats.cpu(), flat.cpu(),
                                                  r ** 3, True).to(dev))
    assert torch.equal(got, voxelize._scatter_mean_cuda(feats, flat, r ** 3,
                                                        True)[0])
    grid = torch.randn(b, c, r ** 3, device=dev).to(bf)
    got = _counted("trilinear_devoxelize_bf16", devoxelize._devoxelize_cuda,
                   grid, norm, r, True)
    _bf16_close(got, devoxelize._devoxelize_plain(grid, norm, r, True))
    assert torch.equal(got, devoxelize._devoxelize_cuda(grid, norm, r, True))
    g = torch.randn(b, n, c, device=dev).to(bf)
    got = _counted("devoxelize_bwd_bf16", devoxelize._devoxelize_bwd_cuda, g,
                   norm, r, True)
    want = devoxelize._devoxelize_bwd_plain(g.cpu(), norm.cpu(), r, True)
    mag = devoxelize._devoxelize_bwd_plain(g.abs().float().cpu(), norm.cpu(),
                                           r, True)
    assert got.dtype == bf
    bad = (got.float().cpu() - want.float()).abs() > 2 ** -7 * mag + 1e-30
    assert not bad.any()
    assert torch.equal(got, devoxelize._devoxelize_bwd_cuda(g, norm, r,
                                                            True))


def test_bf16_kernels_reject_what_they_do_not_take(dev):
    """Mixed bf16 and float32 operands, bf16 coordinates: a ValueError
    naming the dtype it got and the kernels that take it (channel-last
    bf16 grids are K1's, K2's and K5's bf16 modes since they serve the
    NDHWC branch)."""
    bf = torch.bfloat16
    x = torch.randn(1, 4, 512, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        devoxelize._devoxelize_cuda(x.transpose(1, 2).contiguous().to(bf),
                                    torch.rand(1, 64, 3, device=dev).to(bf),
                                    8, False)
    with pytest.raises(ValueError, match="bfloat16"):
        devoxelize._devoxelize_bwd_cuda(
            torch.randn(1, 64, 4, device=dev).to(bf),
            torch.rand(1, 64, 3, device=dev).double(), 8, False)
    with pytest.raises(ValueError, match="dense_rows_wgrad_bf16"):
        from pvcnn_tpu_torch.ops import dense_rows
        dense_rows._wgrad_cuda(torch.randn(8, 4, device=dev).to(bf),
                               torch.randn(8, 4, device=dev), None, None,
                               0.0, False)
    with pytest.raises(ValueError, match="conv3d_ndhwc_wgrad_bf16"):
        conv3d._ndhwc_wgrad_cuda(torch.randn(1, 4, 4, 4, 2, device=dev).to(
            bf), torch.randn(1, 4, 4, 4, 2, device=dev), 3)
    with pytest.raises(ValueError, match="conv3d_fwd_bf16"):
        conv3d._forward_cuda(x.to(bf), torch.randn(4, 4, 3, 3, 3, device=dev),
                             torch.zeros(4, device=dev), None, None, 8,
                             False, False)
    with pytest.raises(ValueError, match="conv3d_wgrad_bf16"):
        conv3d._wgrad_cuda(x.to(bf), x, None, None, 8, False)


@pytest.mark.parametrize("has_prologue,want_stats", [(False, True),
                                                     (True, True)])
def test_conv3d_bf16_grads_on_card(dev, has_prologue, want_stats):
    """The bf16 conv op's VJP on the card against the CPU's plain versions
    (dx and dW bf16 within two roundings, dbias, dscale and dshift f32)."""
    bf = torch.bfloat16
    b, ci, co, r = 2, 16, 32, 8
    leaves = [torch.randn(b, ci, r ** 3).to(bf),
              (torch.randn(co, ci, 3, 3, 3) / (27 * ci) ** 0.5).to(bf),
              torch.randn(co), torch.rand(ci) + 0.5, torch.randn(ci)]
    cot = (torch.randn(b, co, r ** 3).to(bf), 0.1 * torch.randn(co),
           0.01 * torch.randn(co))

    def grads(device):
        args = [t.to(device).requires_grad_() for t in leaves]
        out = ops.conv3d_rows_act(*args, r, has_prologue, want_stats)
        got = torch.autograd.grad(out, args, [c.to(device) for c in cot],
                                  allow_unused=True)
        return [None if g is None else g.cpu() for g in got]

    got, want = grads(dev), grads("cpu")
    _bf16_close(got[0], want[0])
    _bf16_close(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0,
                                       atol=2 ** -7 * w.abs().max().item())


def test_split_dense_bf16_on_card(dev):
    """The bf16 SplitDense (cuBLAS products of bf16 parts into f32, one
    rounding) on the card against the CPU's widened products: output and
    gradients within two bf16 roundings of their scale."""
    from pvcnn_tpu_torch.nn.shared_mlp import SplitDense

    layer = SplitDense(16 + 40 + 8, 24, dtype="bfloat16")
    shapes = [(2, 300, 16), (2, 300, 40), (2, 1, 8)]
    parts = [torch.randn(s).to(torch.bfloat16) for s in shapes]
    cot = torch.randn(2, 300, 24).to(torch.bfloat16)

    def run(device):
        mod = layer.to(device)
        mod.zero_grad()
        xs = [p.detach().clone().to(device).requires_grad_() for p in parts]
        y = mod(xs)
        y.backward(cot.to(device))
        return [t.detach().cpu() for t in
                [y] + [x.grad for x in xs] + [mod.weight.grad, mod.bias.grad]]

    want = run("cpu")
    got = run(dev)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=2 ** -7 * w.float().abs().max().item())


def _k1_sum_bf16(values, idx, bins):
    """scatter_sum on bf16 values on the card (one scatter_sum_bf16 launch
    counted), held to its plain version and the fp64 sum: bf16 out, within
    2^-7 of each output's sum of |terms| of the plain version and within
    one bf16 rounding (2^-8) plus 1e-6 of the sum of |terms| of the exact
    sum; the bins that hold rows are the plain version's."""
    got = _counted("scatter_sum_bf16", ops.scatter_sum, values, idx, bins)
    assert got.dtype == torch.bfloat16
    want = voxelize._scatter_sum_plain(values, idx, bins)
    mag = voxelize._scatter_sum_plain(values.abs().float(), idx, bins)
    assert not ((got.float() - want.float()).abs() > 2 ** -7 * mag).any()
    exact = voxelize._scatter_sum_plain(values.double(), idx, bins)
    assert ((got.double() - exact).abs()
            <= 2 ** -8 * exact.abs() + 1e-6 * mag.double()).all()
    assert int((got != 0).any(-1).sum()) == int((want != 0).any(-1).sum())
    return got


@pytest.mark.parametrize("spread", ["one_bin", "few_bins"])
@pytest.mark.parametrize("c", [5, 9, 32, 130, 512])
def test_k1_sum_bf16_kernel(dev, c, spread):
    """K1's bf16 sum mode (the take_rows backward of a bf16 cotangent):
    every row in one bin (one lane group walks the whole run, as after a
    group-all level), or 6 bins of 512 holding all rows; channel counts on
    both sides of the 8-byte vector path and of the lane group's width.
    Two runs bitwise equal; take_rows' backward launches it."""
    k, bins = 1500, 512
    if spread == "one_bin":
        idx = torch.full((2, k), 300, dtype=torch.int32, device=dev)
        idx[1] = 0
    else:
        idx = torch.randint(0, 6, (2, k), dtype=torch.int32, device=dev) * 97
    values = torch.randn(2, k, c, device=dev).to(torch.bfloat16)
    got = _k1_sum_bf16(values, idx, bins)
    assert torch.equal(got, ops.scatter_sum(values, idx, bins))
    table = torch.randn(2, bins, c, device=dev).to(
        torch.bfloat16).requires_grad_()
    (grad,) = torch.autograd.grad(ops.take_rows(table, idx), table, values)
    assert torch.equal(grad, got)


@pytest.mark.parametrize("b,k,bins,c", [(2, 32768, 8192, 32),
                                        (3, 384, 1, 1024),
                                        (2, 24576, 1024, 128)])
def test_k1_sum_bf16_model_shapes(dev, b, k, bins, c):
    """At PVCNN2's SA1 grouping and FP4 interpolation and PointNet++'s FP1
    (384 rows of 1,024 channels into one bin) on random indices."""
    values = torch.randn(b, k, c, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, bins, (b, k), device=dev, dtype=torch.int32)
    _k1_sum_bf16(values, idx, bins)


@pytest.mark.parametrize("case", ["one_bin", "skewed", "at_the_cut"])
@pytest.mark.parametrize("c", [9, 64, 1024])
def test_k1_sum_bf16_long_runs(dev, monkeypatch, c, case):
    """K1's bf16 sum on runs longer than long_run (cut into pieces walked
    side by side): every row in one bin (PointNet++'s FP1, which the plan
    cuts), and, with the cut forced, a skewed mix of long and short runs
    and runs of exactly long_run and long_run + 1 rows. Two runs bitwise
    equal, within the fp64 bound (_k1_sum_bf16); the runs of long_run rows
    or fewer bitwise the sums of an uncut walk."""
    lr = voxelize._LONG_RUN
    if case == "one_bin":
        idx = torch.zeros((3, 384), dtype=torch.int32, device=dev)
        bins = 1
    elif case == "skewed":
        bins = 512
        idx = torch.randint(0, bins, (2, 6000), dtype=torch.int32,
                            device=dev)
        idx[:, :3000] = torch.randint(0, 4, (2, 3000), dtype=torch.int32,
                                      device=dev)
    else:
        bins = 64
        idx = torch.cat([torch.full((lr,), 5), torch.full((lr + 1,), 9),
                         torch.full((lr - 1,), 17)]).to(
            torch.int32).to(dev).repeat(2, 1)
    plan = voxelize._sort_plan(*idx.shape, bins, 132)
    assert plan.long_run == (lr if case == "one_bin" else 0)
    values = torch.randn(*idx.shape, c, device=dev).to(torch.bfloat16)
    monkeypatch.setattr(voxelize, "_sort_plan",
                        lambda *a: plan._replace(long_run=lr))
    got = _k1_sum_bf16(values, idx, bins)
    assert torch.equal(got, ops.scatter_sum(values, idx, bins))
    monkeypatch.setattr(voxelize, "_sort_plan",
                        lambda *a: plan._replace(long_run=0))
    uncut = ops.scatter_sum(values, idx, bins)
    counts = torch.stack([torch.bincount(i.long(), minlength=bins)
                          for i in idx])
    short = counts <= lr
    assert torch.equal(got[short], uncut[short])
    assert (counts > lr).any()


def test_k1_sum_bf16_unaligned_rows(dev):
    """Rows that start off an 8-byte boundary take the scalar path (C = 32
    would take 8-byte vectors) and give the same sums."""
    values = torch.randn(2 * 300 * 32 + 1, device=dev).to(
        torch.bfloat16)[1:].view(2, 300, 32)
    idx = torch.randint(0, 64, (2, 300), dtype=torch.int32, device=dev)
    got = _k1_sum_bf16(values, idx, 64)
    assert torch.equal(got, ops.scatter_sum(values.clone(), idx, 64))


# ---- the bf16 modes of K9 / K10, K11 and the channel-last K1 / K2 / K5 -----


def _dense_bf16_check(dev, rows, ci, co, has_prologue, x_offset=0,
                      w_offset=0):
    """K9 (with statistics), its dgrad and K10 in bf16 against their plain
    versions: y and dx within two bf16 roundings of their scale, the f32
    statistics within 1e-4 of the plain sums (s1 relative to sum |y|), dW
    and d(bias) within 1e-4 of their largest entry; each bitwise equal
    over two runs and on another stream; one launch a call of each bf16
    record (K10 none without rows). x_offset / w_offset > 0 hand the
    wrappers views that start off a 16-byte boundary."""
    from pvcnn_tpu_torch.ops import dense_rows

    bf = torch.bfloat16
    base = torch.randn(rows * ci + x_offset, device=dev).to(bf)
    x = base[x_offset:].view(rows, ci)
    wbase = torch.randn(co * ci + w_offset, device=dev) / ci ** 0.5
    w = wbase[w_offset:].view(co, ci).t()               # the SharedMLP's view
    bias = torch.randn(co, device=dev)
    scale, shift = torch.rand(ci, device=dev) + 0.5, torch.randn(ci,
                                                                 device=dev)
    g = torch.randn(rows, co, device=dev).to(bf)
    args = (x, w, bias, scale, shift, 0.1, has_prologue, True)

    def run():
        return (*dense_rows._forward_cuda(*args), dense_rows._dgrad_cuda(g, w),
                *dense_rows._wgrad_cuda(x, g, scale, shift, 0.1,
                                        has_prologue))

    counts = kernels.launch_counts()
    got = run()
    after = kernels.launch_counts()
    # K9 and its dgrad are launched (the launcher returns without rows);
    # K10's wrapper returns zeros without a launch
    for name in ("dense_rows_fwd_bf16", "dense_rows_dgrad_bf16",
                 "dense_rows_wgrad_bf16"):
        assert after[name] == counts[name] + (
            1 if rows or not name.endswith("wgrad_bf16") else 0)
    y, s1, s2, dx, dw, db = got
    assert (y.dtype, dx.dtype, dw.dtype, db.dtype) == (bf, bf, torch.float32,
                                                       torch.float32)
    want, w1, w2 = dense_rows._forward_plain(*args)
    if rows:
        _bf16_close(y, want)
        mag = want.float().abs().sum(0)                 # sum |y| a channel
        assert ((s1 - w1).abs() <= 1e-4 * mag + 1e-6).all()
        assert ((s2 - w2).abs() <= 1e-4 * w2 + 2e-4 * mag + 1e-6).all()
        _bf16_close(dx, dense_rows._dgrad_plain(g, w))
    want_dw, want_db = dense_rows._wgrad_plain(x, g, scale, shift, 0.1,
                                               has_prologue)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4,
                               atol=1e-4 * want_dw.abs().max().item())
    torch.testing.assert_close(db, want_db, rtol=1e-4,
                               atol=1e-4 * want_db.abs().max().item())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, run()))
    return got


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("rows", [0, 1, 37, 128, 129, 1000])
@pytest.mark.parametrize("ci,co", [(9, 64), (9, 70), (130, 70), (64, 130),
                                   (4, 4), (323, 196)])
def test_dense_rows_bf16_ragged(dev, ci, co, rows, has_prologue):
    """K9 / dgrad / K10 in bf16 on no rows, rows that fill no tile or one
    tile and a row, Ci = 9 (padded to 16), Co = 70, 130, 196 (MSG's,
    padded to 200 for the dgrad's rows)."""
    _dense_bf16_check(dev, rows, ci, co, has_prologue)


@pytest.mark.parametrize("ci,co", [(9, 64), (64, 64), (64, 128),
                                   (128, 1024), (512, 256)])
def test_dense_rows_bf16_opt_in_shapes(dev, ci, co):
    """Every K9 / dgrad / K10 shape of the S3DIS PVCNN opt-in step at its
    131,072 rows (K10 split into its plan's chunks)."""
    _dense_bf16_check(dev, 131072, ci, co, False)


@pytest.mark.parametrize("x_offset,w_offset", [(1, 0), (0, 1), (3, 5)])
def test_dense_rows_bf16_unaligned(dev, x_offset, w_offset):
    """Rows and a weight that start off a 16-byte boundary: K9 and K10
    read such rows themselves (the weight through its bf16 copy), and the
    results are those of the aligned tensors."""
    torch.manual_seed(3)
    got = _dense_bf16_check(dev, 1000, 64, 128, True, x_offset, w_offset)
    torch.manual_seed(3)
    base = _dense_bf16_check(dev, 1000, 64, 128, True)
    if (x_offset, w_offset) == (0, 0):
        assert all(torch.equal(a, b) for a, b in zip(got, base))


@pytest.mark.parametrize("parts", [1, 3, 33])
@pytest.mark.parametrize("ci,co", [(9, 64), (130, 70), (128, 256)])
def test_dense_rows_bf16_wgrad_fold(dev, monkeypatch, ci, co, parts):
    """K10 in bf16 on forced runs of 1, 3 and 33 parts of a tile's slices
    (4,100 rows, the last slice ragged), the warpgroups' slots added in
    order inside the launch, against the plain version; twice bitwise
    equal."""
    from pvcnn_tpu_torch.ops import dense_rows

    plan = dense_rows._wgrad_plan

    def forced(*args):
        p = plan(*args)
        kps = parts if p.pair else 2 * parts
        work = ((2 * p.mtiles if p.pair else 1) * p.ntiles * kps * 64 * p.bn
                + p.ntiles * parts * p.bn + 1)
        return p._replace(parts=parts, work_floats=work,
                          grid=min(args[5], p.mtiles * p.ntiles * parts))

    monkeypatch.setattr(dense_rows, "_wgrad_plan", forced)
    bf = torch.bfloat16
    x = torch.randn(4100, ci, device=dev).to(bf)
    g = torch.randn(4100, co, device=dev).to(bf)
    scale, shift = torch.rand(ci, device=dev) + 0.5, torch.randn(ci,
                                                                 device=dev)
    for pro in (False, True):
        dw, db = dense_rows._wgrad_cuda(x, g, scale, shift, 0.1, pro)
        want_dw, want_db = dense_rows._wgrad_plain(x, g, scale, shift, 0.1,
                                                   pro)
        torch.testing.assert_close(dw, want_dw, rtol=1e-4,
                                   atol=1e-4 * want_dw.abs().max().item())
        torch.testing.assert_close(db, want_db, rtol=1e-4,
                                   atol=1e-4 * want_db.abs().max().item())
        again = dense_rows._wgrad_cuda(x, g, scale, shift, 0.1, pro)
        assert torch.equal(dw, again[0]) and torch.equal(db, again[1])


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("rows", [1, 127, 129, 131073])
@pytest.mark.parametrize("ci,co", [(9, 64), (130, 196), (512, 256),
                                   (6, 195)])
def test_dense_rows_bf16_wgrad_wgmma(dev, ci, co, rows, has_prologue):
    """K10 in bf16 on wgmma (one dense_rows_wgrad_bf16 launch a call) at
    ragged rows, Ci of 9 (x's rows 2-byte aligned: gathered from raw
    rows), 130 (two 64-channel tiles and a third; rows 4-byte aligned)
    and 512, Co = 196 (g's rows 8-byte aligned), and Ci = 6 (4-byte
    copies) with Co = 195 (g's raw rows laid out by the producer): within
    K10's tolerance
    of the plain version, twice bitwise equal, the same on another
    stream, and on views that start off a 16-byte boundary (other copy
    routes) within the tolerance and twice bitwise equal."""
    from pvcnn_tpu_torch.ops import dense_rows

    bf = torch.bfloat16
    xb = torch.randn(rows * ci + 3, device=dev).to(bf)
    gb = torch.randn(rows * co + 5, device=dev).to(bf)
    x, g = xb[:rows * ci].view(rows, ci), gb[:rows * co].view(rows, co)
    scale, shift = torch.rand(ci, device=dev) + 0.5, torch.randn(ci,
                                                                 device=dev)
    run = lambda x, g: _counted("dense_rows_wgrad_bf16",
                                dense_rows._wgrad_cuda, x, g, scale, shift,
                                0.1, has_prologue)
    dw, db = run(x, g)
    want_dw, want_db = dense_rows._wgrad_plain(x, g, scale, shift, 0.1,
                                               has_prologue)
    torch.testing.assert_close(dw, want_dw, rtol=1e-4,
                               atol=1e-4 * want_dw.abs().max().item())
    torch.testing.assert_close(db, want_db, rtol=1e-4,
                               atol=1e-4 * want_db.abs().max().item())
    again = run(x, g)
    assert torch.equal(dw, again[0]) and torch.equal(db, again[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = run(x, g)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(dw, other[0]) and torch.equal(db, other[1])
    # views off a 16-byte boundary: other copy routes (and so possibly
    # another plan and order), the same function
    xo = torch.empty_like(xb)[3:].view(rows, ci)
    go = torch.empty_like(gb)[5:].view(rows, co)
    xo.copy_(x)
    go.copy_(g)
    off = run(xo, go)
    torch.testing.assert_close(off[0], want_dw, rtol=1e-4,
                               atol=1e-4 * want_dw.abs().max().item())
    torch.testing.assert_close(off[1], want_db, rtol=1e-4,
                               atol=1e-4 * want_db.abs().max().item())
    again = run(xo, go)
    assert torch.equal(off[0], again[0]) and torch.equal(off[1], again[1])


def _k9_bf16_run(x, w, bias, scale, shift, g, has_prologue):
    """K9 in bf16: the forward with statistics, then the dgrad reading the
    forward's copy of the weight; -> (y, s1, s2, dx, the copy)."""
    from pvcnn_tpu_torch.ops import dense_rows

    staged = {}
    y, s1, s2 = dense_rows._forward_cuda(x, w, bias, scale, shift, 0.1,
                                         has_prologue, True, staged)
    dx = dense_rows._dgrad_cuda(g, w, staged)
    return y, s1, s2, dx, staged["w16"]


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("rows", [1, 127, 129, 131073])
@pytest.mark.parametrize("ci,co", [(9, 64), (130, 70), (512, 256)])
def test_k9_bf16_wgmma(dev, ci, co, rows, has_prologue):
    """K9 in bf16 on wgmma at ragged row counts (one row, a tile short, a
    tile and a row, 131,072 + 1), Ci = 9 and 130 (rows read by the
    consumers) and 512 (by TMA), with and without the prologue: y and dx
    within two bf16 roundings of the plain versions, the statistics
    within 1e-4 of the plain sums; the forward's weight copy equal to
    `_weight16` and read by the dgrad; one launch a call; twice bitwise
    equal, and on another stream."""
    from pvcnn_tpu_torch.ops import dense_rows

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(rows + ci)
    x = torch.randn(rows, ci, device=dev, generator=gen).to(bf)
    w = (torch.randn(co, ci, device=dev, generator=gen) / ci ** 0.5).t()
    bias = torch.randn(co, device=dev, generator=gen)
    scale = torch.rand(ci, device=dev, generator=gen) + 0.5
    shift = torch.randn(ci, device=dev, generator=gen)
    g = torch.randn(rows, co, device=dev, generator=gen).to(bf)
    args = (x, w, bias, scale, shift, g, has_prologue)
    counts = kernels.launch_counts()
    got = _k9_bf16_run(*args)
    after = kernels.launch_counts()
    for name in ("dense_rows_fwd_bf16", "dense_rows_dgrad_bf16"):
        assert after[name] == counts[name] + 1
    y, s1, s2, dx, w16 = got
    assert torch.equal(w16, dense_rows._weight16(w))
    want, w1, w2 = dense_rows._forward_plain(x, w, bias, scale, shift, 0.1,
                                             has_prologue, True)
    _bf16_close(y, want)
    mag = want.float().abs().sum(0)
    assert ((s1 - w1).abs() <= 1e-4 * mag + 1e-6).all()
    assert ((s2 - w2).abs() <= 1e-4 * w2 + 2e-4 * mag + 1e-6).all()
    _bf16_close(dx, dense_rows._dgrad_plain(g, w))
    assert all(torch.equal(a, b) for a, b in zip(got, _k9_bf16_run(*args)))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = _k9_bf16_run(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("ci,co", [(64, 64), (64, 128), (128, 1024)])
def test_k9_bf16_wgmma_view(dev, ci, co, has_prologue):
    """Rows and a cotangent that start off a 16-byte boundary (views into
    a larger tensor), which K9's consumers stage slice by slice, give the
    outputs of their aligned copies (read by TMA): y, dx and the weight's
    copy bit for bit (each output the same f32 sum in the same order); the
    statistics within 1e-5 of their scale where the two plans' blocks
    differ (their slots are added in another grouping), else bit for
    bit."""
    bf = torch.bfloat16
    rows = 4099
    x = torch.randn(rows * ci + 1, device=dev).to(bf)[1:].view(rows, ci)
    g = torch.randn(rows * co + 3, device=dev).to(bf)[3:].view(rows, co)
    w = torch.randn(ci, co, device=dev) / ci ** 0.5
    bias = torch.randn(co, device=dev)
    scale, shift = torch.rand(ci, device=dev) + 0.5, torch.randn(ci,
                                                                 device=dev)
    got = _k9_bf16_run(x, w, bias, scale, shift, g, has_prologue)
    want = _k9_bf16_run(x.clone(), w, bias, scale, shift, g.clone(),
                        has_prologue)
    for i in (0, 3, 4):
        assert torch.equal(got[i], want[i])
    from pvcnn_tpu_torch.ops import dense_rows

    plans = [dense_rows._wgmma_plan(rows, co, ci, tma, has_prologue, 132)
             for tma in (False, True)]
    mag = want[0].float().abs().sum(0)          # sum |y| a column
    for a, b, scale in zip(got[1:3], want[1:3], (mag, want[2])):
        if plans[0][:5] == plans[1][:5]:        # the same blocks
            assert torch.equal(a, b)
        else:
            assert ((a - b).abs() <= 1e-5 * scale + 1e-6).all()


@pytest.mark.parametrize("r", [4, 8, 12, 16, 32])
@pytest.mark.parametrize("ci", [9, 16, 24, 64])
def test_k11_bf16_in_place(dev, monkeypatch, r, ci):
    """K11 in bf16 reading the channel-last grids in place (x staged only
    at Ci = 9) bitwise equal to the staged route (both grids staged, K4's
    own launcher), B = 1, Co = 64 and 40; one launch a call."""
    staged = []
    stage = conv3d._stage_last_bf16
    monkeypatch.setattr(conv3d, "_stage_last_bf16",
                        lambda t: staged.append(t.shape[-1]) or stage(t))
    for co in (64, 40):
        x, g = _ndhwc_bf16_inputs(dev, 1, r, ci, co)
        before = kernels.KERNELS["conv3d_ndhwc_wgrad_bf16"].launches
        dw = conv3d._ndhwc_wgrad_cuda(x, g, 3)
        assert kernels.KERNELS["conv3d_ndhwc_wgrad_bf16"].launches == \
            before + 1
        assert staged == ([ci] if ci % 8 else [])
        assert torch.equal(dw, conv3d._ndhwc_wgrad_cuda_bf16(x, g, r,
                                                             staged=True))
        staged.clear()


def test_dense_rows_bf16_grads_on_card(dev):
    """The bf16 op's VJP on the card against the CPU's plain versions: y
    and dx within two bf16 roundings of their scale, the statistics,
    dW, d(bias), dscale and dshift f32 within 1e-3 of their scale."""
    from pvcnn_tpu_torch.ops import dense_rows_act

    bf = torch.bfloat16
    rows, ci, co = 1024, 32, 48
    x = torch.randn(rows, ci).to(bf)
    w, bias = torch.randn(ci, co) / ci ** 0.5, torch.randn(co)
    scale, shift = torch.rand(ci) + 0.5, torch.randn(ci)
    gy = torch.randn(rows, co).to(bf)
    gs1, gs2 = torch.randn(co) * 1e-3, torch.randn(co) * 1e-4

    def vjp(device):
        ins = [t.to(device).requires_grad_(t.is_floating_point())
               for t in (x, w, bias, scale, shift)]
        y, s1, s2 = dense_rows_act(*ins, 0.1, True, True)
        torch.autograd.backward((y, s1, s2), (gy.to(device), gs1.to(device),
                                              gs2.to(device)))
        return [y, s1, s2] + [t.grad for t in ins]

    got = [t.cpu() for t in vjp(dev)]
    want = vjp("cpu")
    _bf16_close(got[0], want[0])
    _bf16_close(got[3], want[3])
    for a, b in zip(got[1:3] + got[4:], want[1:3] + want[4:]):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-3,
                                   atol=1e-3 * b.abs().max().item())


def _ndhwc_bf16_inputs(dev, b, r, ci, co, offset=0):
    bf = torch.bfloat16
    base = torch.randn(b * r ** 3 * ci + offset, device=dev).to(bf)
    x = base[offset:].view(b, r, r, r, ci)
    return x, torch.randn(b, r, r, r, co, device=dev).to(bf)


@pytest.mark.parametrize("b,r,ci,co", [(2, 8, 9, 64), (2, 8, 16, 16),
                                       (1, 12, 70, 33), (2, 16, 64, 64),
                                       (1, 16, 64, 128), (1, 16, 128, 128),
                                       (2, 32, 9, 64), (1, 32, 64, 64),
                                       (0, 8, 16, 16), (3, 5, 24, 40)])
def test_conv3d_ndhwc_wgrad_bf16_kernel(dev, b, r, ci, co):
    """K11 in bf16 against its plain version (within two bf16 roundings of
    dW's scale), bitwise equal over two runs and on another stream, and
    bitwise equal to K4's bf16 mode on the same grids channel-major (the
    channel-last staging pass writes K4's staged layout); one launch a
    call (none without clouds)."""
    x, g = _ndhwc_bf16_inputs(dev, b, r, ci, co)
    before = kernels.KERNELS["conv3d_ndhwc_wgrad_bf16"].launches
    dw = conv3d._ndhwc_wgrad_cuda(x, g, 3)
    assert kernels.KERNELS["conv3d_ndhwc_wgrad_bf16"].launches == \
        before + (1 if b else 0)
    assert dw.dtype == torch.bfloat16 and dw.shape == (co, ci, 3, 3, 3)
    want = conv3d._ndhwc_wgrad_plain(x, g, 3)
    if not b:
        assert not dw.any()
        return
    _bf16_close(dw, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = conv3d._ndhwc_wgrad_cuda(x, g, 3)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert torch.equal(dw, again)
    assert torch.equal(dw, conv3d._ndhwc_wgrad_cuda(x, g, 3))
    rows = lambda t: t.reshape(b, r ** 3, -1).transpose(1, 2).contiguous()
    assert torch.equal(dw, conv3d._wgrad_cuda(rows(x), rows(g), None, None,
                                              r, False))


def test_conv3d_ndhwc_wgrad_bf16_unaligned(dev):
    """x starting off a 16-byte boundary (and Ci = 9: 18-byte rows) is
    staged element by element, to the same dW."""
    for ci in (9, 64):
        x, g = _ndhwc_bf16_inputs(dev, 2, 8, ci, 32, offset=3)
        assert torch.equal(conv3d._ndhwc_wgrad_cuda(x, g, 3),
                           conv3d._ndhwc_wgrad_cuda(x.clone(), g, 3))


def test_conv3d_same_bf16_grads_on_card(dev):
    """conv3d_same's VJP in bf16 on the card (cuDNN's bf16 convs, K11's bf16
    mode) against the CPU's (f32 convs of the widened operands, rounded;
    the plain K11): y, dx and dW bf16 within two roundings of their
    scale."""
    bf = torch.bfloat16
    x = torch.randn(2, 8, 8, 8, 16).to(bf)
    w = (torch.randn(32, 16, 3, 3, 3) / 12).to(bf)
    g = torch.randn(2, 8, 8, 8, 32).to(bf)

    def vjp(device):
        xx, ww = (t.to(device).requires_grad_() for t in (x, w))
        y = conv3d.conv3d_same(xx, ww)
        y.backward(g.to(device))
        return y, xx.grad, ww.grad

    for a, b in zip(vjp(dev), vjp("cpu")):
        _bf16_close(a.cpu(), b)


@pytest.mark.parametrize("c,r", [(1, 8), (5, 8), (9, 32), (16, 16),
                                 (64, 32), (130, 16)])
def test_k1_k2_k5_bf16_channel_last(dev, c, r):
    """K1's, K2's and K5's bf16 modes on channel-last grids [B, R^3, C] (the
    NDHWC branch) against their plain versions (K1 and K2 within two bf16
    roundings of the output's scale, K5 within 2^-7 of each bin's sum of
    |terms|), two runs bitwise equal (the second also on another stream),
    and bitwise equal to the channel-major modes transposed (the same sums
    in the same order)."""
    bf = torch.bfloat16
    b, n = 2, 700
    vox, norm = ops.normalize_coords(_coords(dev, b=b, n=n), r,
                                     normalize=False)
    flat = ops.flat_voxel_index(vox, r)
    flat[0, :300] = flat[0, 0]                       # a run of 300 rows
    feats = torch.randn(b, n, c, device=dev).to(bf)
    got = _counted("avg_voxelize_bf16", voxelize._scatter_mean_cuda, feats,
                   flat, r ** 3, False)[0]
    assert got.shape == (b, r ** 3, c)
    _bf16_close(got, voxelize._scatter_mean_plain(feats, flat, r ** 3,
                                                  False))
    assert torch.equal(got, voxelize._scatter_mean_cuda(feats, flat, r ** 3,
                                                        False)[0])
    assert torch.equal(got.transpose(1, 2), voxelize._scatter_mean_cuda(
        feats, flat, r ** 3, True)[0])
    grid = torch.randn(b, r ** 3, c, device=dev).to(bf)
    got = _counted("trilinear_devoxelize_bf16", devoxelize._devoxelize_cuda,
                   grid, norm, r, False)
    _bf16_close(got, devoxelize._devoxelize_plain(grid, norm, r, False))
    assert torch.equal(got, devoxelize._devoxelize_cuda(grid, norm, r,
                                                        False))
    assert torch.equal(got, devoxelize._devoxelize_cuda(
        grid.transpose(1, 2).contiguous(), norm, r, True))
    g = torch.randn(b, n, c, device=dev).to(bf)
    got = _counted("devoxelize_bwd_bf16", devoxelize._devoxelize_bwd_cuda, g,
                   norm, r, False)
    assert got.shape == (b, r ** 3, c) and got.dtype == bf
    want = devoxelize._devoxelize_bwd_plain(g, norm, r, False)
    mag = devoxelize._devoxelize_bwd_plain(g.abs().float(), norm, r, False)
    bad = (got.float() - want.float()).abs() > 2 ** -7 * mag + 1e-30
    assert not bad.any()
    assert torch.equal(got, devoxelize._devoxelize_bwd_cuda(g, norm, r,
                                                            False))
    assert torch.equal(got.transpose(1, 2), devoxelize._devoxelize_bwd_cuda(
        g, norm, r, True))

    def run():
        return (voxelize._scatter_mean_cuda(feats, flat, r ** 3, False)[0],
                devoxelize._devoxelize_cuda(grid, norm, r, False),
                devoxelize._devoxelize_bwd_cuda(g, norm, r, False))

    first = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_k1_k2_k5_bf16_channel_last_unaligned(dev):
    """Channel-last bf16 rows and grids off an 8-byte boundary take the
    scalar paths, to the same results."""
    bf = torch.bfloat16
    b, n, c, r = 2, 500, 32, 8
    vox, norm = ops.normalize_coords(_coords(dev, b=b, n=n), r,
                                     normalize=False)
    flat = ops.flat_voxel_index(vox, r)
    feats = torch.randn(b * n * c + 1, device=dev).to(bf)[1:].view(b, n, c)
    assert torch.equal(voxelize._scatter_mean_cuda(feats, flat, r ** 3,
                                                   False)[0],
                       voxelize._scatter_mean_cuda(feats.clone(), flat,
                                                   r ** 3, False)[0])
    g = torch.randn(b * n * c + 1, device=dev).to(bf)[1:].view(b, n, c)
    assert torch.equal(devoxelize._devoxelize_bwd_cuda(g, norm, r, False),
                       devoxelize._devoxelize_bwd_cuda(g.clone(), norm, r,
                                                       False))


# ---- the bf16 K2 / K5 in either layout --------------------------------------

def _bits(t):
    """bf16 bits with every NaN as one NaN."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.view(torch.int16)


def _k5_bf16_true_corners(g, norm, r, cf):
    """K5's bf16 sums in plain torch on the CPU, formed as
    `_devoxelize_bwd_plain` forms them (each weight and term rounded to
    bf16, f32 sums by `scatter_add_` corner by corner, each in point
    order: the brick kernel's order), counting only a point's true
    corners, as K5 does: a corner that collapsed onto lo (f = 0 on an axis
    of its bits, weight exactly 0) adds nothing, where the plain version
    adds 0 * g, a NaN for an infinite g. -> the grid gradient in the
    layout"""
    g, norm = g.cpu(), norm.cpu()
    b, n, c = g.shape
    idx8, w8 = devoxelize._corners(norm, r)
    frac = norm - torch.floor(norm)
    rows = torch.zeros(b, r ** 3, c)
    for k in range(8):
        true = torch.ones(b, n, dtype=torch.bool)
        for axis, bit in ((0, 4), (1, 2), (2, 1)):
            if k & bit:
                true &= frac[..., axis] > 0
        term = (w8[..., k, None].to(g.dtype) * g).float()
        term = torch.where(true[..., None], term, torch.zeros_like(term))
        rows.scatter_add_(1, idx8[..., k, None].expand(-1, -1, c), term)
    rows = rows.to(g.dtype)
    return rows.transpose(1, 2).contiguous() if cf else rows


def _k2_k5_bf16_check(norm, c, r, grid=None, g=None, cf=True):
    """The bf16 K2 and K5 on a channel-major grid (cf, the rows branch) or
    a channel-last one (the NDHWC branch), one launch a call, against
    their plain versions: K2 within two bf16 roundings of the output's
    scale, K5 within 2^-7 of each bin's sum of |terms| and bitwise the
    plain version on the CPU (the same terms, summed in the same order).
    Each output is checked twice bitwise: a second run, then the other
    layout's output transposed (the same sums in the same order). grid,
    where given, is in the layout under test. -> (K2's output, K5's)"""
    bf = torch.bfloat16
    b, n, _ = norm.shape
    if grid is None:
        grid = torch.randn(b, c, r ** 3, device=norm.device).to(bf)
        grid = grid if cf else grid.transpose(1, 2).contiguous()
    if g is None:
        g = torch.randn(b, n, c, device=norm.device).to(bf)
    out = _counted("trilinear_devoxelize_bf16", devoxelize._devoxelize_cuda,
                   grid, norm, r, cf)
    assert out.shape == (b, n, c) and out.dtype == bf
    _bf16_close(out, devoxelize._devoxelize_plain(grid, norm, r, cf))
    assert torch.equal(out, devoxelize._devoxelize_cuda(grid, norm, r, cf))
    assert torch.equal(out, devoxelize._devoxelize_cuda(
        grid.transpose(1, 2).contiguous(), norm, r, not cf))
    dgrid = _counted("devoxelize_bwd_bf16", devoxelize._devoxelize_bwd_cuda,
                     g, norm, r, cf)
    assert dgrid.shape == ((b, c, r ** 3) if cf else (b, r ** 3, c))
    assert dgrid.dtype == bf
    want = devoxelize._devoxelize_bwd_plain(g, norm, r, cf)
    mag = devoxelize._devoxelize_bwd_plain(g.abs().float(), norm, r, cf)
    assert not ((dgrid.float() - want.float()).abs()
                > 2 ** -7 * mag + 1e-30).any()
    assert torch.equal(dgrid.cpu(), devoxelize._devoxelize_bwd_plain(
        g.cpu(), norm.cpu(), r, cf))
    assert torch.equal(dgrid, devoxelize._devoxelize_bwd_cuda(g, norm, r,
                                                              cf))
    assert torch.equal(dgrid.transpose(1, 2), devoxelize._devoxelize_bwd_cuda(
        g, norm, r, not cf))
    return out, dgrid


@pytest.mark.parametrize("cf", [True, False])
@pytest.mark.parametrize("c,r,n", [
    (64, 32, 2048), (128, 16, 2048),          # ShapeNet PVCNN 1x
    (16, 32, 2048), (32, 16, 2048),           # 0.25x
    (32, 32, 8192), (64, 16, 1024), (128, 8, 256), (256, 8, 64),
    (128, 16, 1024),                          # S3DIS PVCNN2
    (64, 16, 4096),                           # S3DIS PVCNN (and opt-in)
    (64, 32, 4096), (128, 16, 4096)])         # S3DIS PVCNN opt-in
def test_k2_k5_bf16_model_shapes(dev, c, r, n, cf):
    """The bf16 K2 and K5 in either layout at the (C, R, N) of the bf16
    steps, the three of S3DIS PVCNN's opt-in step among them, on 2 clouds
    normalized as the PVConvs normalize them: PVCNN2's (128, 8, 256) and
    (256, 8, 64) put 64-256 points in 512 bins."""
    _, norm = ops.normalize_coords(_coords(dev, b=2, n=n), r,
                                   normalize=True)
    _k2_k5_bf16_check(norm, c, r, cf=cf)


@pytest.mark.parametrize("cf", [True, False])
@pytest.mark.parametrize("c,r", sorted(
    {(5, 5), (130, 5), (1, 12), (40, 12), (16, 4), (9, 32)}
    | set(itertools.product([1, 5, 9, 72, 130], [4, 5, 12]))))
def test_k2_k5_bf16_ragged(dev, c, r, cf):
    """R = 4, 5 and 12 (short bricks, 2-byte grid loads and output stores
    into a channel-major grid) and C off the 8-channel groups (2-byte g,
    grid and output loads and stores, partial chunks and groups); exact
    grid hits and points on the R - 1 planes (collapsed corners)."""
    norm = _k5_coords(dev, 3, 500, r, seed=c + r)
    _k2_k5_bf16_check(norm, c, r, cf=cf)


@pytest.mark.parametrize("cf", [True, False])
def test_k2_k5_bf16_one_bin(dev, cf):
    """300 points of a cloud in one base bin (one run that outgrows the
    staged points of a plan for fewer points), the rest spread; a second
    cloud at one exact grid point."""
    r, n = 16, 700
    gen = torch.Generator().manual_seed(3)
    norm = torch.rand(2, n, 3, generator=gen) * (r - 1)
    norm[0, :300] = 6.0 + torch.rand(300, 3, generator=gen) * 0.999
    norm[1] = 9.0
    _k2_k5_bf16_check(norm.to(dev), 64, r, cf=cf)


@pytest.mark.parametrize("cf", [True, False])
@pytest.mark.parametrize("staged", [0, 1, 7, 64])
def test_k5_bf16_staged_points(dev, monkeypatch, staged, cf):
    """K5 with fewer staged points than its bricks hold (the points past
    them are read where they lie, in the same walk): bitwise equal to the
    default plan's output, twice, and to the other layout's transposed
    under the forced plan."""
    r, n, c = 16, 900, 24
    gen = torch.Generator().manual_seed(4)
    norm = torch.rand(2, n, 3, generator=gen) * (r - 1)
    norm[0, :300] = 6.0 + torch.rand(300, 3, generator=gen) * 0.999
    norm = norm.to(dev)
    g = torch.randn(2, n, c, device=dev).to(torch.bfloat16)
    want = devoxelize._devoxelize_bwd_cuda(g, norm, r, cf)
    assert devoxelize._brick_plan(n, c, r).staged > staged
    plan = devoxelize._brick_plan(n, c, r)._replace(staged=staged)
    monkeypatch.setattr(devoxelize, "_brick_plan", lambda *_: plan)
    got = devoxelize._devoxelize_bwd_cuda(g, norm, r, cf)
    assert torch.equal(got, want)
    assert torch.equal(got, devoxelize._devoxelize_bwd_cuda(g, norm, r, cf))
    assert torch.equal(got.transpose(1, 2), devoxelize._devoxelize_bwd_cuda(
        g, norm, r, not cf))


def test_k2_k5_bf16_refuse_bad_plans(dev, monkeypatch):
    """A chunk other than 8, 16 or 32 channels, or more staged points than
    shared memory holds: the launcher refuses, the wrapper raises."""
    norm = _k5_coords(dev, 1, 100, 8, seed=5)
    grid = torch.randn(1, 16, 512, device=dev).to(torch.bfloat16)
    g = torch.randn(1, 100, 16, device=dev).to(torch.bfloat16)
    for plan in (devoxelize.BrickPlan(12, 64),
                 devoxelize.BrickPlan(16, 1 << 20)):
        monkeypatch.setattr(devoxelize, "_brick_plan", lambda *_: plan)
        with pytest.raises(RuntimeError, match="launch failed"):
            devoxelize._devoxelize_bwd_cuda(g, norm, 8, True)
        if plan.tc == 12:
            with pytest.raises(RuntimeError, match="launch failed"):
                devoxelize._devoxelize_cuda(grid, norm, 8, True)


@pytest.mark.parametrize("cf", [True, False])
def test_k2_k5_bf16_no_clouds(dev, cf):
    """B = 0: empty outputs of the layout's shapes."""
    norm = torch.rand(0, 64, 3, device=dev)
    grid = torch.randn(0, 16, 512, device=dev).to(torch.bfloat16)
    grid = grid if cf else grid.transpose(1, 2).contiguous()
    g = torch.randn(0, 64, 16, device=dev).to(torch.bfloat16)
    assert devoxelize._devoxelize_cuda(grid, norm, 8, cf).shape == (0, 64,
                                                                    16)
    assert devoxelize._devoxelize_bwd_cuda(g, norm, 8, cf).shape == (
        (0, 16, 512) if cf else (0, 512, 16))


@pytest.mark.parametrize("cf", [True, False])
@pytest.mark.parametrize("c", [16, 13])
def test_k2_k5_bf16_unaligned(dev, c, cf):
    """A grid and a g one element off a 16-byte boundary in either layout
    (2-byte loads; C = 13 also 2-byte stores), to the same bits as their
    aligned copies."""
    bf = torch.bfloat16
    r, n, b = 16, 600, 2
    norm = _k5_coords(dev, b, n, r, seed=c)
    flat = torch.randn(b * c * r ** 3 + 1, device=dev).to(bf)[1:]
    grid = flat.view(b, c, r ** 3) if cf else flat.view(b, r ** 3, c)
    g = torch.randn(b * n * c + 1, device=dev).to(bf)[1:].view(b, n, c)
    assert grid.data_ptr() % 16 and g.data_ptr() % 16
    out, dgrid = _k2_k5_bf16_check(norm, c, r, grid=grid, g=g, cf=cf)
    assert torch.equal(out, devoxelize._devoxelize_cuda(grid.clone(), norm,
                                                        r, cf))
    assert torch.equal(dgrid, devoxelize._devoxelize_bwd_cuda(g.clone(), norm,
                                                              r, cf))


@pytest.mark.parametrize("cf,r,n", [(True, 32, 2048), (False, 32, 4096)])
def test_k2_k5_bf16_on_another_stream(dev, cf, r, n):
    """Two runs of the bf16 K2 and K5 bitwise equal, the second on another
    stream (channel-last at an opt-in shape)."""
    c = 64
    _, norm = ops.normalize_coords(_coords(dev, b=2, n=n), r, normalize=True)
    grid = torch.randn(2, c, r ** 3, device=dev).to(torch.bfloat16)
    grid = grid if cf else grid.transpose(1, 2).contiguous()
    g = torch.randn(2, n, c, device=dev).to(torch.bfloat16)

    def run():
        return (devoxelize._devoxelize_cuda(grid, norm, r, cf),
                devoxelize._devoxelize_bwd_cuda(g, norm, r, cf))

    first = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        second = run()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("cf", [True, False])
@pytest.mark.parametrize("c", [5, 16, 72])
def test_k2_k5_bf16_special_values(dev, c, cf):
    """Subnormal, tiny and huge cotangents and grids, signed zeros,
    infinities and NaN, and points a hair past a grid plane (weights near
    2^-20), NaN for NaN: K5 (its fma.rn.bf16x2 terms) gives the bits of f32
    products rounded to bf16, summed in f32, as the plain version forms
    them on the CPU: bitwise `_devoxelize_bwd_plain` on finite and NaN
    cotangents, and bitwise its true-corner sums on infinite ones (the
    plain version adds 0 * inf for a collapsed corner); each layout's K2
    and K5 bitwise the other layout's transposed (K2's two layouts run two
    kernels), and K5's subnormal channel keeps subnormal sums."""
    bf = torch.bfloat16
    r, n, b = 8, 400, 2
    norm = _k5_coords(dev, b, n, r, seed=6)
    norm[:, 50:150] = norm[:, 50:150].floor() + 2.0 ** -20
    norm[:, 150:200] = norm[:, 150:200].floor() + (1 - 2.0 ** -20)
    special = torch.tensor([0.0, -0.0, 1e-39, -3e-40, 9.2e-41, 1.2e-38,
                            -1.1e-38, 2e-38, 3.3e38, -3.3e38, float("inf"),
                            float("-inf"), float("nan"), 1.0, -2.5, 7e-3])

    def pick(*shape):
        t = torch.randn(*shape)
        at = torch.rand(*shape) < 0.3
        t[at] = special[torch.randint(len(special), (int(at.sum()),))]
        return t.to(bf).to(dev)

    grid, g = pick(b, c, r ** 3), pick(b, n, c)
    # channel 0: bf16 subnormals only, so its products and sums are too
    g[..., 0] = (torch.randn(b, n, device=dev) * 1e-39).to(bf)
    grid = grid if cf else grid.transpose(1, 2).contiguous()
    out = devoxelize._devoxelize_cuda(grid, norm, r, cf)
    assert torch.equal(_bits(out), _bits(devoxelize._devoxelize_cuda(
        grid, norm, r, cf)))
    assert torch.equal(_bits(out), _bits(devoxelize._devoxelize_cuda(
        grid.transpose(1, 2).contiguous(), norm, r, not cf)))
    dgrid = devoxelize._devoxelize_bwd_cuda(g, norm, r, cf)
    assert torch.equal(_bits(dgrid), _bits(devoxelize._devoxelize_bwd_cuda(
        g, norm, r, cf)))
    assert torch.equal(_bits(dgrid.transpose(1, 2)), _bits(
        devoxelize._devoxelize_bwd_cuda(g, norm, r, not cf)))
    assert torch.equal(_bits(dgrid.cpu()),
                       _bits(_k5_bf16_true_corners(g, norm, r, cf)))
    finite = torch.where(g.isinf(), torch.zeros_like(g), g)
    assert torch.equal(
        _bits(devoxelize._devoxelize_bwd_cuda(finite, norm, r, cf).cpu()),
        _bits(devoxelize._devoxelize_bwd_plain(finite.cpu(), norm.cpu(), r,
                                               cf)))
    tiny = (dgrid[:, 0] if cf else dgrid[..., 0]).float().abs()
    assert ((tiny > 0) & (tiny < 1.1754944e-38)).any()
