"""The port's training pieces against the JAX package: Adam and the lr
schedules, the generator-driven Dropout, MeterShapeNet, the train split's
sampling, and the trainer entry point with its checkpoints (which map back
into JAX variables).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu.data.shapenet import ShapeNet
from pvcnn_tpu.meters.shapenet import MeterShapeNet as JMeter
from pvcnn_tpu.models.shapenet import PVCNN as JPVCNN
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.meters.shapenet import MeterShapeNet
from pvcnn_tpu_torch.models.shapenet import PVCNN
from pvcnn_tpu_torch.models.utils import Dropout
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.shapenet import main as train_main
from test_torch_train import _inputs


def test_adam_semantics_match_jax():
    """The port's Adam (L2 decay folded into the gradient) against the JAX
    package's optax chain, with mid-run lr changes."""
    import optax

    from pvcnn_tpu.train.optim import Adam as JAdam
    from pvcnn_tpu.train.optim import set_learning_rate as jset_lr

    rng = np.random.RandomState(0)
    p0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) for _ in range(6)]
    lrs = [1e-2, 1e-2, 5e-3, 5e-3, 2e-3, 2e-3]
    wd = 3e-2
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = toptim.Adam([pt], lr=lrs[0], weight_decay=wd)
    tx, _ = JAdam(lrs[0], weight_decay=wd)
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    for g, lr in zip(grads, lrs):
        toptim.set_learning_rate(opt, lr)
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
        jset_lr(opt_state, lr)
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(params),
                                   rtol=1e-5, atol=5e-7)


@pytest.mark.parametrize("name,kw", [
    ("CosineAnnealingLR", dict(t_max=7, eta_min=1e-5)),
    ("StepLR", dict(step_size=3, gamma=0.5)),
    ("MultiStepLR", dict(milestones=[2, 5], gamma=0.3)),
])
def test_schedules_match_jax(name, kw):
    from pvcnn_tpu.train import optim as joptim

    mine = getattr(toptim, name)(**kw).bind(1e-3)
    theirs = getattr(joptim, name)(**kw).bind(1e-3)
    assert [mine(e) for e in range(10)] == [theirs(e) for e in range(10)]


def test_dropout_draws_from_its_generator():
    x = torch.ones(4, 64, 32)
    d = Dropout(0.2).train()
    d.generator = torch.Generator().manual_seed(5)
    a = d(x)
    d.generator = torch.Generator().manual_seed(5)
    assert torch.equal(a, d(x))
    assert set(a.unique().tolist()) == {0.0, 1.25}
    assert torch.equal(d.eval()(x), x)


@pytest.mark.parametrize("seed", range(3))
def test_meter_matches_jax(seed):
    rng = np.random.RandomState(seed)
    outputs = rng.randn(6, 40, 50).astype(np.float32)
    shapes = rng.randint(0, 16, 6)
    targets = np.stack([rng.randint(tdata.SHAPE_PART_CLASSES[s][1][0],
                                    tdata.SHAPE_PART_CLASSES[s][1][-1] + 1,
                                    40) for s in shapes])
    mine, theirs = MeterShapeNet(), JMeter()
    for sl in (slice(0, 4), slice(4, 6)):
        mine.update(outputs[sl], targets[sl])
        theirs.update(outputs[sl], targets[sl])
    assert mine.compute() == theirs.compute()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shapenet"))
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70),
                                 (9, 88)])
    return root


def test_train_split_draws_like_jax(tree):
    """Resampling and jitter of the train split draw the numbers the JAX
    dataset draws from np.random.seed(seed)."""
    mine = tdata.ShapeNetDataset(tree, 64, "train", seed=4)
    theirs = ShapeNet(tree, 64, split="train")["train"]
    assert len(mine) == len(theirs) == 10        # train + val lists
    np.random.seed(4)
    for i in (0, 3, 3, 7):
        f_t, y_t = theirs[i]
        f_m, y_m = mine[i]
        np.testing.assert_array_equal(y_m, y_t)
        np.testing.assert_allclose(f_m, f_t, rtol=0, atol=1e-6)
    test = tdata.ShapeNetDataset(tree, 64, "test")
    f, _ = test[0]
    assert not test.jitter and f.shape == (64, 22)


def test_trainer_cli_writes_and_resumes(tree, tmp_path, capsys):
    """Two epochs of at most 2 steps on the CPU write latest, e0, e1 and
    best; a third epoch resumes at epoch 2; the training checkpoint's model
    maps into JAX variables that give the flax model the port's eval
    forward."""
    save = str(tmp_path / "run")
    args = ["--root", tree, "--width", "0.125", "--batch-size", "2",
            "--num-points", "64", "--max-steps", "2", "--device", "cpu",
            "--save-path", save]
    meters = train_main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "training epoch 0/2" in out and "training epoch 1/2" in out
    for name in ("latest.pth.tar", "latest/e0.pth.tar", "latest/e1.pth.tar",
                 "best.pth.tar"):
        assert os.path.exists(os.path.join(save, name)), name
    assert 0.0 <= meters["acc/iou_test"] <= 1.0
    ckpt = torch.load(os.path.join(save, "latest.pth.tar"),
                      weights_only=True)
    assert ckpt["epoch"] == 1 and set(ckpt) == {"epoch", "model",
                                                "optimizer", "meters"}

    train_main(args + ["--epochs", "3"])
    out = capsys.readouterr().out
    assert "loading checkpoint" in out and "training epoch 2/3" in out
    assert "training epoch 0/3" not in out
    assert os.path.exists(os.path.join(save, "latest/e2.pth.tar"))

    port = PVCNN(50, 16, 3, width_multiplier=0.125)
    port.load_state_dict(ckpt["model"])
    jmodel = JPVCNN(num_classes=50, num_shapes=16, extra_feature_channels=3,
                    width_multiplier=0.125)
    x, _ = _inputs(5, n=64)
    v = jmodel.init(jax.random.PRNGKey(0), x, train=False)
    params, stats = ci.import_state_dict(
        {k: t.numpy() for k, t in ckpt["model"].items()}, v["params"],
        v["batch_stats"], ci.pvcnn_shapenet_mapping())
    with jax.default_matmul_precision("float32"):
        want = jmodel.apply({"params": params, "batch_stats": stats}, x,
                            train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
