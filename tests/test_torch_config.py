"""The port's config layer against the JAX package's on the same inputs:
Config nodes and their factories, update_from_file's chain of
__init__.py files (and where the port's chain starts), dotted overrides,
_parse_value, get_save_path and parse_device_spec; select_device's
refusals."""

import os
import sys
import types

import numpy as np
import pytest
import torch

from pvcnn_tpu.utils import common as jcommon
from pvcnn_tpu.utils import config as jconfig
from pvcnn_tpu.utils import device as jdevice
from pvcnn_tpu_torch.utils import common, config, device


def _plain(node):
    """A Config tree as plain values: (factory name, {key: value})."""
    if isinstance(node, dict):
        func = getattr(node, "func", None)
        return (getattr(func, "__name__", None),
                {k: _plain(v) for k, v in node.items()})
    if isinstance(node, (list, tuple)):
        return type(node)(_plain(v) for v in node)
    return node


def _pair(*args, **kwargs):
    return args, kwargs


def _tree(module):
    """One factory tree, built from `module`'s Config class."""
    c = module.Config
    return c(_pair, a=c(_pair, b=1), c=[c(_pair, b=2), 3],
             d=c(_pair, _detach_=True, e=4), f=c(g=5))


def test_config_nodes_build_as_jax_does():
    """Calling a node builds its children first (lists and tuples of nodes
    too), passes a detached child through unbuilt and appends the call's
    own keywords; a node without a factory returns itself; a factory must
    be callable."""
    for module in (jconfig, config):
        with pytest.raises(TypeError):
            module.Config(3)
    got = _tree(config)(1, z=9)
    want = _tree(jconfig)(1, z=9)
    assert got[0] == want[0] == (1,)
    assert _plain(got[1]) == _plain(want[1])
    assert got[1]["d"].detached and got[1]["d"].func is _pair
    f = config.Config(g=5)
    assert f() is f and f.func is None and not f.detached
    assert str(_tree(config)).replace("pvcnn_tpu_torch", "") == \
        str(_tree(jconfig)).replace("pvcnn_tpu", "")


@pytest.mark.parametrize("value", [
    "3", "-2.5e-3", "'quoted'", '"double"', "(1, 2)", "[5, 10]", "True",
    "None", "1e-3 * 2", "word", "a/b.py", "{'k': 1}", "'", "x=1"])
def test_parse_value_matches_jax(value):
    assert config._parse_value(value) == jconfig._parse_value(value)


@pytest.mark.parametrize("value", ["iter", "max", "open", "epoch"])
def test_parse_value_keeps_names(value):
    """A bare word is its text in the port, builtins' names too: JAX's
    _parse_value turns `iter` (--configs.train.scheduler_unit=iter, the
    per-step schedule train_dml documents) into the builtin function,
    which then compares unequal to 'iter'."""
    assert config._parse_value(value) == value
    assert (jconfig._parse_value(value) == value) == (value == "epoch")


def test_overrides_match_jax():
    """--configs.x.y=z and the two-token form, into new and existing
    nodes; a node a value replaces; an argument without the prefix
    raises."""
    args = ("--configs.train.num_epochs=1", "--configs.model.width", "0.5",
            "--configs.dataset.root=/data/x", "--configs.a.b.c=(1, 2)",
            "--configs.seed", "7", "--configs.train=3",
            "--configs.train.lr=1e-3")
    trees = []
    for module in (jconfig, config):
        c = module.Config(seed=1, model=module.Config(_pair, depth=2))
        c.update_from_arguments(*args)
        trees.append(_plain(c))
        with pytest.raises(ValueError):
            c.update_from_arguments("--other=1")
    assert trees[0] == trees[1]


@pytest.fixture
def trace(monkeypatch):
    """A module the config files below append their own paths to."""
    module = types.ModuleType("config_trace")
    module.calls = []
    monkeypatch.setitem(sys.modules, "config_trace", module)
    return module.calls


def _write(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("import config_trace\n"
                "config_trace.calls.append(__file__)\n")


def _chain(module, path, trace):
    del trace[:]
    module.Config().update_from_file(path)
    return list(trace)


def test_update_from_file_chain(tmp_path, monkeypatch, trace):
    """For a path under `configs/` and for one without such a directory,
    the port executes the JAX loader's files in its order, each once; for
    a config tree inside a package (pkg/configs/...), and for an absolute
    path, the port's chain starts at `configs` and leaves out the
    package's own __init__.py, which the JAX loader executes."""
    for rel in ("pkg/__init__.py", "pkg/configs/__init__.py",
                "pkg/configs/a/__init__.py", "pkg/configs/a/b/__init__.py",
                "pkg/configs/a/b/leaf.py", "configs/__init__.py",
                "configs/a/__init__.py", "configs/a/leaf.py",
                "plain/__init__.py", "plain/leaf.py"):
        _write(str(tmp_path / rel))
    monkeypatch.chdir(tmp_path)
    for path in ("configs/a/leaf.py", "configs/a/../a/leaf.py",
                 "plain/leaf.py"):
        want = _chain(jconfig, path, trace)
        assert _chain(config, path, trace) == want and len(want) >= 2
    want = _chain(jconfig, "pkg/configs/a/b/leaf.py", trace)
    assert want[0] == os.path.join("pkg", "__init__.py")
    assert _chain(config, "pkg/configs/a/b/leaf.py", trace) == want[1:]
    assert _chain(config, str(tmp_path / "pkg/configs/a/b/leaf.py"),
                  trace) == [str(tmp_path / p) for p in want[1:]]


@pytest.mark.parametrize("paths", [
    ("configs/shapenet/pvcnn/c1.py",),
    ("configs/s3dis/pvcnn2/area5/c0p5.py",),
    ("configs/a/b.py", "configs/a/c.py"),
    ("configs/s3dis/pvcnn/area5/c1.py", "configs/shapenet/pointnet.py",
     "configs/shapenet/pvcnn/c0p25.py"),
    ("other/x.py",)])
def test_save_path_matches_jax(paths):
    """The JAX function's run directory for its own paths, and the same one
    for the port's tree (pvcnn_tpu_torch/configs/..., relative or
    absolute)."""
    want = jcommon.get_save_path(*paths, prefix="runs")
    assert common.get_save_path(*paths, prefix="runs") == want
    if paths[0].startswith("configs/"):
        for base in ("pvcnn_tpu_torch", "/srv/x/pvcnn_tpu_torch"):
            port = [f"{base}/{p}" for p in paths]
            assert common.get_save_path(*port) == want


@pytest.mark.parametrize("spec", ["0", "3", "0,2-3", "cpu", "gpu0", "tpu1,3",
                                  " 1 , 2 ", "", "GPU2-4", "cpu,1"])
def test_parse_device_spec_matches_jax(spec):
    assert device.parse_device_spec(spec) == jdevice.parse_device_spec(spec)


def test_select_device(monkeypatch):
    """cpu is the CPU; no spec is cuda:0 and an index its card, both
    refused without CUDA; with two visible cards, an index names its card,
    an index past them is refused, and so are several indices, naming the
    multi-GPU work that is not ported."""
    assert device.select_device("cpu") == torch.device("cpu")
    assert device.select_device(" CPU ") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in (None, "", "0", "gpu1"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device.select_device(spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device.select_device(None) == torch.device("cuda", 0)
    assert device.select_device("gpu1") == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="out of range"):
        device.select_device("2")
    for spec in ("0,1", "0-1", "gpu0,gpu1"):
        with pytest.raises(ValueError, match="DDP.*Queue 1, item 5"):
            device.select_device(spec)


def test_config_values_keep_arrays():
    """A node holds any value a config file sets (arrays included) and
    hands it to its factory as it is."""
    templates = np.arange(6.0).reshape(2, 3)
    built = config.Config(_pair, t=templates)()
    assert built[1]["t"] is templates
