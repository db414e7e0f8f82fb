"""Structural guarantees of the port: it imports neither jax nor the JAX
package, a non-CPU tensor never falls back to a plain version, a failed
kernel build raises, and chip_smoke.py refuses to run without a GPU."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from pvcnn_tpu_torch import kernels
from pvcnn_tpu_torch.ops import (conv3d, dense_rows, devoxelize,
                                 gather_utils, interpolate, neighbors,
                                 sampling, voxelize)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pvcnn_tpu_torch\n"
        "for m in pkgutil.walk_packages(pvcnn_tpu_torch.__path__, "
        "'pvcnn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'pvcnn_tpu' or m.startswith('pvcnn_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('pvcnn_tpu_torch')]),"
        " bad)\n")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(" ", 1)
    assert int(count) >= 15
    assert bad.strip() == "[]"


def test_chip_smoke_needs_a_gpu(tmp_path):
    """Without CUDA, and alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    for cwd in (ROOT, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ,
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


CALLS = {
    "avg_voxelize": (voxelize, "_scatter_mean_plain", lambda: voxelize
                     .scatter_mean(_meta(2, 64, 6),
                                   _meta(2, 64, dtype=torch.int32), 512)),
    "trilinear_devoxelize": (devoxelize, "_devoxelize_plain", lambda:
                             devoxelize.devoxelize_rows(
                                 _meta(2, 512, 16), _meta(2, 64, 3), 8)),
    "conv3d_fwd": (conv3d, "_forward_plain", lambda: conv3d.conv3d_rows_act(
        _meta(2, 6, 512), _meta(16, 6, 3, 3, 3), _meta(16), None, None, 8,
        False, True)),
    # the backward passes dispatch on the saved tensors' device
    "conv3d_dgrad": (conv3d, "_dgrad_plain", lambda: _conv_backward(
        (True, False, False, False, False))),
    "conv3d_wgrad": (conv3d, "_wgrad_plain", lambda: _conv_backward(
        (False, True, False, False, False))),
    "devoxelize_bwd": (devoxelize, "_devoxelize_bwd_plain", lambda:
                       devoxelize._DevoxelizeRows.backward(
                           types.SimpleNamespace(
                               saved_tensors=(_meta(2, 64, 3),),
                               needs_input_grad=(True, False, False, False),
                               resolution=8, channels_first=True),
                           _meta(2, 64, 16))),
    "fps": (sampling, "_fps_plain", lambda:
            sampling.furthest_point_sample_indices(_meta(2, 64, 3), 16)),
    "ball_query": (neighbors, "_ball_query_plain", lambda:
                   neighbors.ball_query(_meta(2, 16, 3), _meta(2, 64, 3),
                                        0.2, 8)),
    "three_nn": (interpolate, "_three_nn_plain", lambda:
                 interpolate.three_nn(_meta(2, 64, 3), _meta(2, 16, 3))),
    # the take_rows backward dispatches on the cotangent's device
    "scatter_sum": (voxelize, "_scatter_sum_plain", lambda:
                    gather_utils._TakeRows.backward(
                        types.SimpleNamespace(
                            saved_tensors=(_meta(2, 40, dtype=torch.int32),),
                            needs_input_grad=(True, False), num_rows=16),
                        _meta(2, 40, 8))),
    "dense_rows_fwd": (dense_rows, "_forward_plain", lambda:
                       dense_rows.dense_rows_act(
                           _meta(2, 512, 9), _meta(9, 16), _meta(16), None,
                           None, 0.0, False, True)),
    "dense_rows_dgrad": (dense_rows, "_dgrad_plain", lambda: _dense_backward(
        (True, False, False, False, False))),
    "dense_rows_wgrad": (dense_rows, "_wgrad_plain", lambda: _dense_backward(
        (False, True, True, False, False))),
    "conv3d_ndhwc_wgrad": (conv3d, "_ndhwc_wgrad_plain", lambda:
                           conv3d._Conv3dSame.backward(
                               types.SimpleNamespace(
                                   saved_tensors=(_meta(2, 8, 8, 8, 6),
                                                  _meta(16, 6, 3, 3, 3)),
                                   needs_input_grad=(False, True)),
                               _meta(2, 8, 8, 8, 16))),
}


def _dense_backward(needs):
    ctx = types.SimpleNamespace(
        saved_tensors=(_meta(2, 512, 9), _meta(9, 16), None, None, None),
        needs_input_grad=needs, slope=0.0, has_prologue=False,
        want_stats=False)
    return dense_rows._DenseRowsAct.backward(ctx, _meta(2, 512, 16),
                                             _meta(16), _meta(16))


def _conv_backward(needs):
    ctx = types.SimpleNamespace(
        saved_tensors=(_meta(2, 6, 512), _meta(16, 6, 3, 3, 3), None, None,
                       None),
        needs_input_grad=needs, resolution=8, has_prologue=False,
        want_stats=False)
    return conv3d._Conv3dRowsAct.backward(ctx, _meta(2, 16, 512), _meta(16),
                                          _meta(16))


@pytest.mark.parametrize("name", sorted(CALLS))
def test_non_cpu_tensors_never_take_the_plain_version(monkeypatch, name):
    module, plain, call = CALLS[name]

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


def test_failed_loader_raises_and_counts_nothing(monkeypatch):
    def broken_loader():
        raise RuntimeError("kernel library failed to load")

    monkeypatch.setattr(kernels, "library", broken_loader)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="failed to load"):
        kernels.launch("conv3d_fwd", "pvcnn_conv3d_fwd")
    assert set(kernels.launch_counts().values()) == {0}


def test_failed_build_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        kernels.build()
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build()
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("name", sorted(kernels.KERNELS))
def test_kernel_records_name_their_sources(name):
    """Each kernel's source exists and `replaces` points at the definition
    of a TPU kernel function: one whose body reaches pl.pallas_call."""
    k = kernels.KERNELS[name]
    assert os.path.exists(os.path.join(ROOT, k.source))
    path, line = k.replaces.split(":")
    with open(os.path.join(ROOT, path)) as f:
        lines = f.read().splitlines()[int(line) - 1:]
    assert lines[0].startswith("def "), lines[0]
    body = []
    for text in lines[1:]:
        if text.startswith(("def ", "@", "class ")):
            break
        body.append(text)
    assert "pl.pallas_call" in "\n".join(body), lines[0]
    json.dumps(vars(k))
