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


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("c,r", [(6, 8), (16, 16)])
def test_avg_voxelize_kernel(dev, c, r, channels_first):
    vox, _ = ops.normalize_coords(_coords(dev), r, normalize=False)
    flat = ops.flat_voxel_index(vox, r)
    feats = torch.randn(2, 512, c, device=dev)
    before = kernels.KERNELS["avg_voxelize"].launches
    got = ops.scatter_mean(feats, flat, r ** 3, channels_first)
    assert kernels.KERNELS["avg_voxelize"].launches == before + 1
    want = voxelize._scatter_mean_plain(feats, flat, r ** 3, channels_first)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, ops.scatter_mean(feats, flat, r ** 3,
                                             channels_first))


@pytest.mark.parametrize("channels_first", [False, True])
@pytest.mark.parametrize("c,r", [(16, 8), (32, 16)])
def test_devoxelize_kernel(dev, c, r, channels_first):
    _, norm = ops.normalize_coords(_coords(dev), r, normalize=True)
    norm[:, :4] = norm[:, :4].floor()          # collapsed corners
    grid = torch.randn(2, c, r ** 3, device=dev)
    if not channels_first:
        grid = grid.transpose(1, 2).contiguous()
    got = ops.devoxelize_rows(grid, norm, r, channels_first)
    want = devoxelize._devoxelize_plain(grid, norm, r, channels_first)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("has_prologue", [False, True])
@pytest.mark.parametrize("ci,co,r", [(6, 16, 8), (16, 80, 12)])
def test_conv3d_kernel(dev, ci, co, r, has_prologue):
    x = torch.randn(2, ci, r ** 3, device=dev)
    w = torch.randn(co, ci, 3, 3, 3, device=dev) * 0.1
    bias = torch.randn(co, device=dev)
    scale = torch.rand(ci, device=dev) + 0.5
    shift = torch.randn(ci, device=dev)
    args = (x, w, bias, scale, shift, r, has_prologue)
    torch.testing.assert_close(ops.conv3d_rows_act(*args),
                               conv3d._conv3d_plain(*args),
                               rtol=1e-4, atol=1e-4)


def test_kernels_reject_what_they_do_not_take(dev):
    x = torch.randn(1, 4, 512, device=dev)
    with pytest.raises(ValueError, match="3x3x3"):
        ops.conv3d_rows_act(x, torch.randn(4, 4, 5, 5, 5, device=dev),
                            torch.zeros(4, device=dev), None, None, 8, False)
    with pytest.raises(ValueError, match="float32"):
        ops.scatter_mean(x.double().transpose(1, 2),
                         torch.zeros(1, 512, dtype=torch.int32, device=dev),
                         512)
