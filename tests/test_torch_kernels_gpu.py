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
