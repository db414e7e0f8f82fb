"""Each of the port's 15 leaf configs (pvcnn_tpu_torch/configs/) against its
JAX twin (configs/): the same keys and values but the differences listed
in DIFFERS, and factories of the same names in the port's package; the
model it builds against the per-dataset entry point's recipe builder at
the config's width (state_dict keys and shapes); and the recipe's epochs,
lr, weight decay, schedule, batch size and points against the config's.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from pvcnn_tpu_torch.models import s3dis as ts3dis
from pvcnn_tpu_torch.models import shapenet as tshapenet
from pvcnn_tpu_torch.models.kitti import frustum as tkitti
from pvcnn_tpu_torch.train import kitti as tkitti_train
from pvcnn_tpu_torch.train import shapenet as tshapenet_train
from pvcnn_tpu_torch.utils.common import get_save_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "pvcnn_tpu_torch"
LEAVES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, files in os.walk(os.path.join(ROOT, "configs"))
    for f in files if f.endswith(".py") and f != "__init__.py")

# the only keys in which a port config differs from its JAX twin, and why
DIFFERS = {
    # the JAX trainer's TPU-only batch presort (configs/shapenet/pvcnn and
    # configs/s3dis/pvcnn): the port leaves out TPU-only machinery
    "train.presort": "absent",
    # 16 workers in the JAX configs; 0 (the serial loader, prefetch 2) in
    # the port, which measured faster on the card than 16 workers
    "data.num_workers": 0,
}
# the evaluator each config names, in the port under another name
RENAMED = {"evaluate": "evaluate_from_configs"}


def _load(module, path):
    """The config at `path` loaded into `module`'s cleared singleton -> a
    copy of its top node (the singleton restored afterwards)."""
    configs = module.configs
    saved = dict(configs)
    configs.clear()
    try:
        configs.update_from_file(path)
        return module.Config(**configs)
    finally:
        configs.clear()
        configs.update(saved)


def _flat(node, prefix=""):
    """{dotted key: value} of a Config tree; a node's factory under
    'key.<factory>'."""
    out = {}
    if getattr(node, "func", None) is not None:
        out[prefix + "<factory>"] = node.func
    for k, v in node.items():
        if isinstance(v, dict) and hasattr(v, "func"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _same(got, want, key):
    if callable(want):
        name = RENAMED.get(want.__name__, want.__name__)
        assert got.__name__ == name, key
        assert got.__module__.startswith(PORT + "."), key
        assert want.__module__.startswith("pvcnn_tpu."), key
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and np.array_equal(got, want), key
    elif isinstance(want, dict):
        assert set(got) == set(want), key
        for k in want:
            _same(got[k], want[k], f"{key}[{k}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), key
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{key}[{i}]")
    else:
        assert type(got) is type(want) and got == want, key


@pytest.fixture(scope="module")
def modules():
    from pvcnn_tpu.utils import config as jconfig
    from pvcnn_tpu_torch.utils import config as tconfig

    return jconfig, tconfig


@pytest.mark.parametrize("leaf", LEAVES)
def test_port_config_equals_jax_twin(monkeypatch, modules, leaf):
    """Every key and value of the JAX config but DIFFERS's, and factories
    of the same names from the port's package."""
    assert len(LEAVES) == 15
    jconfig, tconfig = modules
    monkeypatch.chdir(ROOT)
    want = _flat(_load(jconfig, leaf))
    got = _flat(_load(tconfig, os.path.join(PORT, leaf)))
    for key, value in DIFFERS.items():
        if value == "absent":
            assert key not in got
            want.pop(key, None)
        elif key in want:
            assert got.pop(key) == value
            want.pop(key)
    assert sorted(got) == sorted(want)
    for key in want:
        _same(got[key], want[key], key)


def _recipe(leaf: str, config):
    """The per-dataset entry point's recipe of the config at `leaf` ->
    (model builder(width), epochs, lr, weight decay, schedule(epochs),
    batch size, points, save path)."""
    parts = leaf.split("/")
    if parts[1] == "shapenet":
        name = "pvcnn" if parts[2] == "pvcnn" else parts[2][:-3]
        epochs, schedule, path = tshapenet_train.RECIPES[name]
        batch = inspect.signature(
            tshapenet_train.train).parameters["batch_size"].default
        points = inspect.signature(
            tshapenet_train.train).parameters["num_points"].default
        if name == "pvcnn":
            path = f"runs/shapenet.pvcnn.{parts[3][:-3]}"
        return (lambda w: tshapenet.MODELS[name].build(50, 16, w), epochs,
                tshapenet_train.LR, 0.0, schedule, batch, points, path)
    if parts[1] == "s3dis":
        name = parts[2]
        spec = ts3dis.MODELS[name]
        width = config.model.get("width_multiplier", 1.0)
        return (spec.build, ts3dis.EPOCHS, ts3dis.LR, spec.weight_decay,
                lambda epochs: spec.scheduler(), ts3dis.BATCH_SIZE,
                spec.num_points, ts3dis.save_path(name, width))
    name = parts[3][:-3]
    spec = tkitti.MODELS[name]
    return (spec.build, tkitti.EPOCHS, tkitti.LR, 0.0, spec.scheduler,
            spec.batch_size, tkitti.NUM_POINTS,
            f"runs/kitti.frustum.{name}")


@pytest.mark.parametrize("leaf", LEAVES)
def test_port_config_is_the_recipe(monkeypatch, modules, leaf):
    """configs.model() has the state_dict (keys, shapes) of the recipe
    builder at the config's width; the recipe's epochs, lr, weight decay,
    lr of every epoch, batch size, points and save path are the config's;
    its meters and criterion build."""
    _, tconfig = modules
    monkeypatch.chdir(ROOT)
    c = _load(tconfig, os.path.join(PORT, leaf))
    build, epochs, lr, decay, schedule, batch, points, path = \
        _recipe(leaf, c)
    width = c.model.get("width_multiplier", 1.0)
    got = {k: v.shape for k, v in c.model().state_dict().items()}
    want = {k: v.shape for k, v in build(width).state_dict().items()}
    assert got == want
    assert c.train.num_epochs == epochs
    assert c.train.optimizer.lr == lr
    assert c.train.optimizer.get("weight_decay", 0.0) == decay
    assert c.train.batch_size == batch and c.dataset.num_points == points
    assert get_save_path(os.path.join(PORT, leaf)) == path
    mine = schedule(epochs).bind(lr)
    theirs = c.train.scheduler().bind(lr)
    assert [mine(e) for e in range(epochs)] == \
        [theirs(e) for e in range(epochs)]
    optimizer = c.train.optimizer([torch.nn.Parameter(torch.zeros(2))])
    assert optimizer.defaults["lr"] == lr
    assert optimizer.defaults["weight_decay"] == decay
    meters = {k: m() for k, m in c.train.meters.items()}
    assert meters and c.train.criterion() is not None
    if leaf.startswith("configs/kitti"):
        assert {k.format("val") for k in meters} == \
            set(tkitti_train.meters("val"))
