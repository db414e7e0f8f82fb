"""The port's S3DIS PVCNN2 slice against the JAX package: the state_dict
layout (that of the reference, so released checkpoints load), the eval
forward, one-step gradients, a three-step trajectory against the JAX
Trainer, and MeterS3DIS.

Model size: the shrunk blocks of tests/test_model_parity.py (PVCNN2_SA /
PVCNN2_FP: centers 32/16/8/4, 8 neighbors, PVConv grids at R = 8, 4, 2) at
width 0.5, B = 2, N = 128 S3DIS-like windows (x, y in [0, 1], z in [0, 3],
rgb, room-normalized xyz). JAX runs its CPU formulations at fp32 matmul
precision; dropout is off on both sides in training.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.meters.s3dis import MeterS3DIS as JMeter
from pvcnn_tpu.models.s3dis import PVCNN2 as JPVCNN2
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.meters.s3dis import MeterS3DIS
from pvcnn_tpu_torch.models.s3dis import PVCNN2
from pvcnn_tpu_torch.models.utils import Dropout
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.predict import predict
from pvcnn_tpu_torch.train.trainer import Trainer
from pvcnn_tpu_torch.utils.weights import (init_random_,
                                           state_dict_from_jax)
from test_model_parity import PVCNN2_FP, PVCNN2_SA, _pvcnn2_mapping
from test_torch_train import _flat, no_dropout  # noqa: F401 (fixture)
from torch_twins import TwinPVCNN2

B, N, WIDTH = 2, 128, 0.5
RNGS = {"dropout": jax.random.PRNGKey(1)}


class _SmallJPVCNN2(JPVCNN2):
    sa_blocks = PVCNN2_SA
    fp_blocks = PVCNN2_FP


class _SmallPVCNN2(PVCNN2):
    sa_blocks = PVCNN2_SA
    fp_blocks = PVCNN2_FP


class _SmallTwin(TwinPVCNN2):
    sa_blocks = PVCNN2_SA
    fp_blocks = PVCNN2_FP


def windows(seed, b=B, n=N):
    """[b, n, 9] S3DIS-like windows and [b, n] labels in 0..12."""
    rng = np.random.RandomState(seed)
    xyz = rng.rand(b, n, 3) * [1.0, 1.0, 3.0]
    rgb = rng.rand(b, n, 3)
    room = rng.rand(b, 1, 3) * [8.0, 6.0, 0.0] + [0.0, 0.0, 3.0]
    normed = (xyz + rng.rand(b, 1, 3) * [4.0, 3.0, 0.0]) / room
    x = np.concatenate([xyz, rgb, normed], -1).astype(np.float32)
    return x, rng.randint(0, 13, (b, n)).astype(np.int64)


def _models(seed=1):
    """(flax model, flax variables, port model holding the same weights).
    The port draws them (init_random_: BatchNorm statistics included) and
    checkpoint_import moves them into the flax tree, whose shapes come from
    jax.eval_shape (no eager init)."""
    jmodel = _SmallJPVCNN2(num_classes=13, extra_feature_channels=6,
                           width_multiplier=WIDTH)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), windows(0)[0], train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    port = init_random_(_SmallPVCNN2(13, 6, width_multiplier=WIDTH), seed)
    state = {k: t.numpy() for k, t in port.state_dict().items()}
    params, stats = ci.import_state_dict(state, zeros["params"],
                                         zeros["batch_stats"],
                                         _pvcnn2_mapping())
    return jmodel, {"params": params, "batch_stats": stats}, port


@pytest.fixture(scope="module")
def models():
    return _models()


def test_weights_from_jax_round_trip(models):
    """JAX variables -> state_dict_from_jax -> the port's state_dict, the
    exact tensors the flax tree was built from."""
    _, variables, port = models
    fresh = _SmallPVCNN2(13, 6, width_multiplier=WIDTH)
    fresh.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], _pvcnn2_mapping(),
        fresh.state_dict()))
    want = port.state_dict()
    for k, t in fresh.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(t, want[k]), k


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("small", [True, False])
def test_state_dict_is_the_reference_layout(small):
    """Keys and shapes equal the reference's (TwinPVCNN2), so a released
    `.pth.tar` loads as it is; at width 1 every key but BatchNorm's step
    counters is named by the checkpoint-import mapping."""
    port = (_SmallPVCNN2(13, 6, width_multiplier=WIDTH) if small
            else PVCNN2(13))
    twin = (_SmallTwin(13, 6, width_multiplier=WIDTH) if small
            else TwinPVCNN2(13))
    assert _shapes(port) == _shapes(twin)
    port.load_state_dict(twin.state_dict())
    if small:
        return
    named = set()
    for prefix, _, kind in ci.pvcnn2_s3dis_mapping():
        leaves = (("weight", "bias", "running_mean", "running_var")
                  if kind == "bn" else ("weight", "bias"))
        named |= {f"{prefix}.{leaf}" for leaf in leaves}
    keys = {k for k in port.state_dict() if "num_batches_tracked" not in k}
    assert keys <= named
    assert not (named - keys) - {k for k in named
                                 if k.endswith(".bias") and "fc." in k}


@pytest.mark.parametrize("seed", [2, 3])
def test_eval_forward_matches_jax(models, seed):
    jmodel, variables, port = models
    x, _ = windows(seed)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False))(variables, x))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (B, N, 13)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    probs = predict(port, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(probs, np.asarray(jax.nn.softmax(want, -1)),
                               rtol=1e-4, atol=1e-5)


def _grad_tree(port, variables):
    named = dict(port.named_parameters())
    grads = {k: (named[k].grad if k in named else torch.zeros_like(t))
             .numpy() for k, t in port.state_dict().items()}
    tree, _ = ci.import_state_dict(grads, variables["params"],
                                   variables["batch_stats"],
                                   _pvcnn2_mapping())
    return tree


@pytest.fixture
def fp32_selection(monkeypatch):
    """JAX's Pallas kernels select neighbors in fp32 whatever the input
    dtype; its CPU formulations select in the input dtype. For the fp64
    run, hand the CPU formulations the fp32 coordinates, which is what the
    Pallas kernels (and the port) compute."""
    import pvcnn_tpu.ops as jops_pkg
    from pvcnn_tpu.ops import interpolate, sampling

    f32 = lambda a: jnp.asarray(a, jnp.float32)
    fps, bq, nn3 = (sampling.furthest_point_sample_indices, jops.ball_query,
                    interpolate.three_nn)
    monkeypatch.setattr(sampling, "furthest_point_sample_indices",
                        lambda c, m: fps(f32(c), m))
    monkeypatch.setattr(jops_pkg, "ball_query",
                        lambda c, p, r, u: bq(f32(c), f32(p), r, u))
    monkeypatch.setattr(interpolate, "three_nn",
                        lambda p, c: nn3(f32(p), f32(c)))


def _jax_loss_and_grads(jmodel, variables, x, y, dtype):
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)

    def loss_fn(p, stats, x, y):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats}, x,
                                 train=True, rngs=RNGS,
                                 mutable=["batch_stats"])
        return jops.cross_entropy(logits, y)

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            cast(variables["params"]), cast(variables["batch_stats"]),
            jnp.asarray(x, dtype), jnp.asarray(y))
    return float(loss), _flat(grads)


def _port_train(port):
    for mod in port.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return port.train()


def _port_loss_and_grads(port, variables, x, y):
    loss = CrossEntropyLoss()(port(torch.from_numpy(x).to(
        port.classifier[-1].weight.dtype)), torch.from_numpy(y))
    loss.backward()
    return loss.item(), _flat(_grad_tree(port, variables))


def _agreement(got, want):
    flipped = np.abs(got - want) > 5e-3 * np.abs(want).max()
    return flipped.mean(), np.linalg.norm(got - want) / np.linalg.norm(want)


def test_one_step_gradients_match_jax(no_dropout, fp32_selection):
    """Train-mode loss and every parameter gradient against
    jax.value_and_grad of the flax model, both sides selecting neighbors in
    fp32 (as the Pallas kernels and the port's kernels do).

    In fp64 (the port's plain versions run in fp64 on the CPU) the two
    compute the same function: loss rtol 1e-7, no element flipped at 5e-3
    of the largest gradient, rel-L2 < 1e-6 (measured 4.6e-10 and 3.2e-7:
    the three-NN weights are fp32 on both sides, and XLA's fused weight
    arithmetic rounds 1 ulp apart from torch's). In fp32 the criteria of
    tests/test_torch_train.py: against JAX fp32 loss rtol 5e-3 and rel-L2 <
    5e-2 (measured 4.8e-6 and 2.9e-2); against JAX fp64 loss rtol 1e-5,
    flipped fraction < 2e-3 and rel-L2 < 5e-2 (measured 1.1e-6, 2.9e-7 and
    1.1e-2), the criteria chip_smoke.py holds the kernel path to. At this size JAX's own
    fp32 gradients lie 1.5e-2 to 1.1e-1 (rel-L2) from its fp64 ones,
    depending on the input (max-pool and ReLU gates flip under fp32
    noise): on this input 2.6e-2."""
    import copy

    jmodel, variables, port = _models()
    port = _port_train(port)
    port64 = copy.deepcopy(port).double()
    x, y = windows(5)
    loss_t, got = _port_loss_and_grads(port, variables, x, y)
    loss_j, want = _jax_loss_and_grads(jmodel, variables, x, y, jnp.float32)
    assert np.isclose(loss_t, loss_j, rtol=5e-3, atol=1e-5)
    assert _agreement(got, want)[1] < 5e-2
    with jax.enable_x64(True):
        loss_64, want = _jax_loss_and_grads(jmodel, variables, x, y,
                                            jnp.float64)
    assert np.isclose(loss_t, loss_64, rtol=1e-5, atol=0)
    flipped, rel_l2 = _agreement(got, want)
    assert flipped < 2e-3 and rel_l2 < 5e-2, (flipped, rel_l2)
    loss_t64, got64 = _port_loss_and_grads(port64, variables, x, y)
    assert np.isclose(loss_t64, loss_64, rtol=1e-7, atol=0)
    flipped, rel_l2 = _agreement(got64, want)
    assert flipped == 0 and rel_l2 < 1e-6, (flipped, rel_l2)


def test_three_step_trajectory_matches_jax_trainer(no_dropout):
    """Three Adam steps (weight decay 1e-5, the c1 recipe's) with a cosine
    lr set before each step: the port's Trainer against the JAX Trainer on
    the same batches, per-step losses within the 3% band of
    tests/test_torch_train.py."""
    from pvcnn_tpu.nn.loss import CrossEntropyLoss as JCrossEntropyLoss
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import Adam as JAdam
    from pvcnn_tpu.train.optim import CosineAnnealingLR as JCosine
    from pvcnn_tpu.train.optim import set_learning_rate as jset_lr
    from pvcnn_tpu.train.trainer import Trainer as JTrainer
    from pvcnn_tpu.train.trainer import TrainState

    k, lr, wd = 3, 1e-3, 1e-5
    batches = [windows(10 + i) for i in range(k)]
    jmodel, variables, port = _models()
    tx, _ = JAdam(lr, weight_decay=wd)
    jtrainer = JTrainer(jmodel, JCrossEntropyLoss(), tx,
                        mesh=pmesh.make_mesh(1))
    # the state Trainer.init_state builds, from these variables (its own
    # eager model.init would take most of this test's time)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax.device_put(
        TrainState(params=params, batch_stats=jax.tree.map(
            jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params)),
        pmesh.replicated(jtrainer.mesh))
    jsched = JCosine(t_max=k, base_lr=lr)
    losses_j = []
    with jax.default_matmul_precision("float32"):
        for i, (x, y) in enumerate(batches):
            jset_lr(state.opt_state, jsched(i))
            batch = pmesh.shard_batch((x, y.astype(np.int32)), jtrainer.mesh)
            state, loss = jtrainer._train_step(state, batch,
                                               jax.random.PRNGKey(0))
            losses_j.append(float(loss))

    port = _port_train(port)
    opt = toptim.Adam(port.parameters(), lr=lr, weight_decay=wd)
    trainer = Trainer(port, CrossEntropyLoss(), opt, "cpu", seed=0)
    sched = toptim.CosineAnnealingLR(t_max=k).bind(lr)
    losses_t = []
    for i, (x, y) in enumerate(batches):
        toptim.set_learning_rate(opt, sched(i))
        losses_t.append(float(trainer.train_step(torch.from_numpy(x),
                                                 torch.from_numpy(y))))
    rel = np.abs(np.subtract(losses_t, losses_j)) / np.abs(losses_j)
    assert rel.max() < 3e-2, (losses_t, losses_j)
    assert rel[0] < 1e-4, rel[0]


@pytest.mark.parametrize("metric", ["iou", "overall", "class"])
def test_meter_s3dis_matches_jax(metric):
    rng = np.random.RandomState(5)
    got, want = MeterS3DIS(metric, 13), JMeter(metric, 13)
    for _ in range(3):
        outputs = rng.randn(4, 50, 13).astype(np.float32)
        targets = rng.randint(0, 12, (4, 50))       # class 12 never seen
        got.update(outputs, targets)
        want.update(outputs, targets)
    assert got.compute() == want.compute()
    with pytest.raises(ValueError, match="metric"):
        MeterS3DIS("miou")
