"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small shapes. Marked `gpu`: they skip without a CUDA device; run them on
one with `python -m pytest tests/test_torch_kernels_gpu.py -m gpu`.
chip_smoke.py checks the same at the model's full shapes."""

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


@pytest.mark.parametrize("r", [1, 8, 16, 32])
@pytest.mark.parametrize("co", [1, 16, 32, 33, 64, 130])
@pytest.mark.parametrize("ci", [1, 6, 9, 32, 128, 257])
def test_wgrad_kernel(dev, ci, co, r):
    """K4 at every tile (Co <= 32 and wider, ragged row and column tiles),
    z-segment length (8 at R = 1 and 8, 16 at R = 16, 32 at R = 32) and
    the plan's splits, at B = 3 with the prologue."""
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


@pytest.mark.parametrize("m,n,radius,u", [(1024, 8192, 0.1, 32),
                                          (16, 64, 0.8, 32),
                                          (100, 40, 0.5, 64),
                                          (33, 3000, 0.05, 8)])
def test_ball_query_kernel(dev, m, n, radius, u):
    """Exact against the plain version: early stop at U hits, the first-hit
    fill, a center with no hit (filled with 0), u > n."""
    from pvcnn_tpu_torch.ops import neighbors

    x = _room(dev, 2, n)
    c = _room(dev, 2, m, seed=1)
    c[:, 0] += 10.0                              # no hit
    c[:, 1] = x[:, 0]                            # on a point
    before = kernels.KERNELS["ball_query"].launches
    got = ops.ball_query(c, x, radius, u)
    assert kernels.KERNELS["ball_query"].launches == before + 1
    want = neighbors._ball_query_plain(c, x, neighbors._fp32(radius ** 2), u)
    assert torch.equal(got, want)
    assert (got[:, 0] == 0).all()
    assert torch.equal(got, ops.ball_query(c, x, radius, u))


@pytest.mark.parametrize("n,m", [(8192, 1024), (64, 16), (300, 2), (50, 1),
                                 (70, 2000)])
def test_three_nn_kernel(dev, n, m):
    """Indices and d² exactly equal the plain version's (ties to the lower
    index, M < 3 with idx 0 and d² = inf), two runs bitwise equal."""
    from pvcnn_tpu_torch.ops import interpolate

    x = _room(dev, 2, n)
    c = _room(dev, 2, m, seed=2)
    if m >= 16:
        c[:, 8:12] = c[:, 2:6]
        x[:, :4] = c[:, 2:6]
    before = kernels.KERNELS["three_nn"].launches
    idx, d2 = interpolate._three_nn_cuda(x, c)
    assert kernels.KERNELS["three_nn"].launches == before + 1
    want_idx, want_d2 = interpolate._three_nn_plain(x, c)
    assert torch.equal(idx, want_idx)
    assert torch.equal(d2, want_d2)
    again = interpolate._three_nn_cuda(x, c)
    assert torch.equal(idx, again[0]) and torch.equal(d2, again[1])


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


@pytest.mark.parametrize("b,r,ci,co", [(2, 8, 9, 64), (2, 16, 64, 64),
                                       (1, 12, 130, 70)])
def test_conv3d_ndhwc_wgrad_kernel(dev, b, r, ci, co):
    """K11 against its plain version (27 shifted-slice products), within
    1e-4 of the largest entry, two runs bitwise equal; through
    conv3d_same's backward with a non-contiguous cotangent, and against
    cuDNN's weight gradient."""
    x = torch.randn(b, r, r, r, ci, device=dev)
    g = torch.randn(b, r, r, r, co, device=dev)
    before = kernels.KERNELS["conv3d_ndhwc_wgrad"].launches
    got = conv3d._ndhwc_wgrad_cuda(x, g, 3)
    assert kernels.KERNELS["conv3d_ndhwc_wgrad"].launches == before + 1
    want = conv3d._ndhwc_wgrad_plain(x, g, 3)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(got, conv3d._ndhwc_wgrad_cuda(x, g, 3))
    lib = torch.nn.grad.conv3d_weight(x.permute(0, 4, 1, 2, 3), want.shape,
                                      g.permute(0, 4, 1, 2, 3), padding=1)
    torch.testing.assert_close(got, lib, rtol=1e-4, atol=1e-4 * scale)
    w = torch.randn(co, ci, 3, 3, 3, device=dev, requires_grad=True)
    gt = g.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)
    (dw,) = torch.autograd.grad(ops.conv3d_same(x, w), w, gt)
    torch.testing.assert_close(dw, got, rtol=1e-4, atol=1e-4 * scale)


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
