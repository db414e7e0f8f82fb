"""The port's S3DIS PVCNN against the JAX package: the state_dict layout
(that of the reference, so released checkpoints load), weights through
pvcnn_s3dis_mapping(), the eval forward, one-step gradients against JAX in
fp32 and fp64, and a three-step trajectory against the JAX Trainer, each on
the default path and on the opt-in path that three switches open in both
packages:

    PVCNN_TPU_DENSE_BN_FUSED=auto     fused Dense + BN statistics (K9/K10)
    PVCNN_TPU_CONV_ROWS=0             the NDHWC voxel branch
    PVCNN_TPU_CUSTOM_CONV_WGRAD=1     its custom weight gradient (K11)

(the JAX side of the opt-in path runs its Pallas kernels in interpret mode).
Model size: width 0.25 and voxel resolution multiplier 0.25, as
tests/test_model_parity.py's pvcnn_s3dis case (PVConv grids at R = 8 and 4),
on B = 4 windows of N = 256 points: 1024 rows, the least the fused layers
take. (At B = 2 the cloud MLP's BatchNorm normalizes over two samples and
JAX's own fp32 gradients lie 0.57 (rel-L2) from its fp64 ones; at B = 4,
1.3e-4.) Dropout is off on both sides in training.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.models.s3dis import PVCNN as JPVCNN
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.models.s3dis import PVCNN
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.trainer import Trainer
from pvcnn_tpu_torch.utils.weights import init_random_, state_dict_from_jax
from test_torch_pvcnn2 import _agreement, _port_train, windows
from test_torch_train import _flat, no_dropout  # noqa: F401 (fixture)
from torch_twins import TwinPVCNNS3DIS

B, N = 4, 256
SIZE = dict(width_multiplier=0.25, voxel_resolution_multiplier=0.25)
RNGS = {"dropout": jax.random.PRNGKey(1)}
SWITCHES = {"PVCNN_TPU_DENSE_BN_FUSED": "auto", "PVCNN_TPU_CONV_ROWS": "0",
            "PVCNN_TPU_CUSTOM_CONV_WGRAD": "1"}


@pytest.fixture(params=[False, True], ids=["default", "switches"])
def switches(request, monkeypatch):
    """The default path, or the opt-in path with the three switches set
    (and the JAX package's Pallas kernels in interpret mode)."""
    if request.param:
        for name, value in SWITCHES.items():
            monkeypatch.setenv(name, value)
        monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "1")
    return request.param


def _models(seed=1):
    """(flax model, flax variables, port model holding the same weights):
    the port draws them (BatchNorm statistics included) and
    checkpoint_import moves them into the flax tree, whose shapes come from
    jax.eval_shape (no eager init)."""
    jmodel = JPVCNN(num_classes=13, extra_feature_channels=6, **SIZE)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), windows(0, B, N)[0], train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    port = init_random_(PVCNN(13, 6, **SIZE), seed)
    state = {k: t.numpy() for k, t in port.state_dict().items()}
    params, stats = ci.import_state_dict(state, zeros["params"],
                                         zeros["batch_stats"],
                                         ci.pvcnn_s3dis_mapping())
    return jmodel, {"params": params, "batch_stats": stats}, port


@pytest.fixture(scope="module")
def models():
    return _models()


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("small", [True, False])
def test_state_dict_is_the_reference_layout(small):
    """Keys and shapes equal the reference's (TwinPVCNNS3DIS), so a
    released `.pth.tar` loads as it is; every key but BatchNorm's step
    counters is named by the checkpoint-import mapping."""
    kw = SIZE if small else {}
    port, twin = PVCNN(13, 6, **kw), TwinPVCNNS3DIS(13, 6, **kw)
    assert _shapes(port) == _shapes(twin)
    port.load_state_dict(twin.state_dict())
    named = set()
    for prefix, _, kind in ci.pvcnn_s3dis_mapping():
        leaves = (("weight", "bias", "running_mean", "running_var")
                  if kind == "bn" else ("weight", "bias"))
        named |= {f"{prefix}.{leaf}" for leaf in leaves}
    keys = {k for k in port.state_dict() if "num_batches_tracked" not in k}
    assert keys == named


def test_weights_from_jax_round_trip(models):
    """JAX variables -> state_dict_from_jax -> the port's state_dict, the
    exact tensors the flax tree was built from."""
    _, variables, port = models
    fresh = PVCNN(13, 6, **SIZE)
    fresh.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"],
        ci.pvcnn_s3dis_mapping(), fresh.state_dict()))
    want = port.state_dict()
    for k, t in fresh.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(t, want[k]), k


def test_eval_forward_matches_jax(models, switches):
    """Eval logits within 1e-4 of the flax model's (its running-statistics
    BatchNorms; the opt-in path changes only the voxel branch's layout in
    eval)."""
    jmodel, variables, port = models
    x, _ = windows(2, B, N)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, train=False))(variables, x))
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (B, N, 13)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _grad_tree(port, variables):
    named = dict(port.named_parameters())
    grads = {k: (named[k].grad if k in named else torch.zeros_like(t))
             .numpy() for k, t in port.state_dict().items()}
    tree, _ = ci.import_state_dict(grads, variables["params"],
                                   variables["batch_stats"],
                                   ci.pvcnn_s3dis_mapping())
    return tree


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


def _port_loss_and_grads(port, variables, x, y):
    loss = CrossEntropyLoss()(port(torch.from_numpy(x).to(
        port.classifier[-1].weight.dtype)), torch.from_numpy(y))
    loss.backward()
    return loss.item(), _flat(_grad_tree(port, variables))


def test_one_step_gradients_match_jax(no_dropout, switches, monkeypatch):
    """Train-mode loss and every parameter gradient against
    jax.value_and_grad of the flax model under the same switches.

    In fp64 (the port's plain versions run in fp64 on the CPU) the two
    compute the same function: loss rtol 1e-7, no element flipped at 5e-3
    of the largest gradient, rel-L2 < 1e-6. In fp32 the criteria of
    tests/test_torch_pvcnn2.py: against JAX fp32 loss rtol 5e-3 and rel-L2
    < 5e-2; against JAX fp64 loss rtol 1e-5, flipped fraction < 2e-3 and
    rel-L2 < 5e-2, the criteria chip_smoke.py holds the kernel path to.
    JAX's Pallas interpret mode does not trace under x64 (lax.rem of int32
    and int64), so on the opt-in path JAX's fp64 reference runs its XLA
    formulations of the same functions: the unfused SharedMLP and the
    shifted-slice weight gradient (which it takes for fp64 on a TPU too)."""
    jmodel, variables, port = _models()
    port = _port_train(port)
    port64 = copy.deepcopy(port).double()
    x, y = windows(5, B, N)
    loss_t, got = _port_loss_and_grads(port, variables, x, y)
    loss_j, want = _jax_loss_and_grads(jmodel, variables, x, y, jnp.float32)
    assert np.isclose(loss_t, loss_j, rtol=5e-3, atol=1e-5)
    assert _agreement(got, want)[1] < 5e-2
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "0")
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


def test_switched_on_step_matches_switched_off(no_dropout, monkeypatch):
    """Inside the port, one step's loss and gradients on the two paths: the
    same function in another order (loss rtol 1e-5, rel-L2 < 1e-3)."""
    _, variables, port = _models()
    x, y = windows(6, B, N)
    out = []
    for on in (False, True):
        for name, value in SWITCHES.items():
            monkeypatch.setenv(name, value) if on else monkeypatch.delenv(
                name, raising=False)
        model = _port_train(copy.deepcopy(port))
        out.append(_port_loss_and_grads(model, variables, x, y))
    (loss_off, g_off), (loss_on, g_on) = out
    assert np.isclose(loss_on, loss_off, rtol=1e-5, atol=0)
    assert _agreement(g_on, g_off)[1] < 1e-3


def test_three_step_trajectory_matches_jax_trainer(no_dropout, monkeypatch):
    """With the switches on in both packages: three Adam steps (weight
    decay 1e-5, the c1 recipe's) with a cosine lr set before each step, the
    port's Trainer against the JAX Trainer on the same batches; per-step
    losses within the 3% band of tests/test_torch_pvcnn2.py, step 1 within
    1e-4."""
    from pvcnn_tpu.nn.loss import CrossEntropyLoss as JCrossEntropyLoss
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import Adam as JAdam
    from pvcnn_tpu.train.optim import CosineAnnealingLR as JCosine
    from pvcnn_tpu.train.optim import set_learning_rate as jset_lr
    from pvcnn_tpu.train.trainer import Trainer as JTrainer
    from pvcnn_tpu.train.trainer import TrainState

    for name, value in SWITCHES.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("PVCNN_TPU_PALLAS_INTERPRET", "1")
    k, lr, wd = 3, 1e-3, 1e-5
    batches = [windows(10 + i, B, N) for i in range(k)]
    jmodel, variables, port = _models()
    tx, _ = JAdam(lr, weight_decay=wd)
    jtrainer = JTrainer(jmodel, JCrossEntropyLoss(), tx,
                        mesh=pmesh.make_mesh(1))
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
