"""The port's ShapeNet PointNet++ SSG and MSG against the JAX package: the
state_dict layout (that of the reference, so released checkpoints load),
weights carried across by state_dict_from_jax, the eval forward, one-step
gradients, a three-step trajectory against the JAX Trainer, and the voting
evaluator on SSG's six input columns.

Model size: the shrunk blocks of tests/test_model_parity.py (SSG_SA /
MSG_SA: 32 and 16 centers, 4-16 neighbors; FP_BLOCKS) at width 0.5, B = 2,
N = 128 ShapeNet-like clouds (SSG: xyz and normals; MSG: with the one-hot
shape id). JAX is jitted once per compiled function and model and runs its
CPU formulations; dropout is off on both sides in training.

The helpers below (`Case`, `make_models`, the gradient and trajectory
checks) also serve tests/test_torch_pointnet.py.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.models.shapenet import PointNet2 as JPointNet2
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.evaluate.shapenet import eval as teval
from pvcnn_tpu_torch.models.shapenet import (MODELS, PointNet2,
                                             pointnet2_msg, pointnet2_ssg)
from pvcnn_tpu_torch.models.utils import Dropout
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.trainer import Trainer
from pvcnn_tpu_torch.utils.weights import init_random_, state_dict_from_jax
from test_model_parity import FP_BLOCKS, MSG_SA, SSG_SA, _pointnet2_mapping
from test_torch_pvcnn2 import fp32_selection  # noqa: F401 (fixture)
from test_torch_train import _flat, _inputs, no_dropout  # noqa: F401
from torch_twins import TwinPointNet2

B, N, WIDTH = 2, 128, 0.5
RNGS = {"dropout": jax.random.PRNGKey(1)}


class Case(NamedTuple):
    """A model of the port and its JAX counterpart at test size."""

    jmodel: object                  # the flax module
    port: Callable                  # () -> the port's module
    twin: Callable                  # () -> the reference twin
    mapping: Callable               # () -> checkpoint_import mapping
    inputs: Callable                # seed -> (x [B, N, C], labels [B, N])
    num_classes: int


def _shapenet_inputs(channels):
    def inputs(seed, b=B, n=N):
        x, y = _inputs(seed, b, n)
        return np.ascontiguousarray(x[..., channels]), y
    return inputs


def _pointnet2_case(msg: bool) -> Case:
    sa = MSG_SA if msg else SSG_SA
    kw = dict(with_one_hot_shape_id=msg, extra_feature_channels=3,
              width_multiplier=WIDTH)
    return Case(
        JPointNet2(num_classes=50, num_shapes=16, sa_blocks=sa,
                   fp_blocks=FP_BLOCKS, **kw),
        lambda: PointNet2(50, 16, sa, FP_BLOCKS, **kw),
        lambda: TwinPointNet2(50, 16, sa, FP_BLOCKS, **kw),
        lambda: _pointnet2_mapping(sa),
        _shapenet_inputs(slice(0, 22 if msg else 6)), 50)


CASES = {"ssg": _pointnet2_case(False), "msg": _pointnet2_case(True)}


def make_models(case: Case, seed: int = 1):
    """(flax variables, port model holding the same weights). The port
    draws them (init_random_: BatchNorm statistics included) and
    checkpoint_import moves them into the flax tree, whose shapes come from
    jax.eval_shape (no eager init)."""
    shapes = jax.eval_shape(lambda: case.jmodel.init(
        jax.random.PRNGKey(0), case.inputs(0)[0], train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    port = init_random_(case.port(), seed)
    state = {k: t.numpy() for k, t in port.state_dict().items()}
    params, stats = ci.import_state_dict(state, zeros["params"],
                                         zeros.get("batch_stats", {}),
                                         case.mapping())
    return {"params": params, "batch_stats": stats}, port


def _shapes(model):
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def check_layout(port, twin, mapping=None):
    """The port's keys and shapes are the twin's (the reference's), a twin
    state_dict loads into it, and with a full-size mapping every key but
    BatchNorm's step counters is named by it."""
    assert _shapes(port) == _shapes(twin)
    port.load_state_dict(twin.state_dict())
    if mapping is None:
        return
    named = set()
    for prefix, _, kind in mapping:
        leaves = (("weight", "bias", "running_mean", "running_var")
                  if kind == "bn" else ("weight", "bias"))
        named |= {f"{prefix}.{leaf}" for leaf in leaves}
    keys = {k for k in port.state_dict() if "num_batches_tracked" not in k}
    assert keys == named


def check_round_trip(case: Case, variables, port):
    """JAX variables -> state_dict_from_jax -> the port's state_dict, the
    exact tensors the flax tree was built from."""
    fresh = case.port()
    fresh.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"], case.mapping(),
        fresh.state_dict()))
    want = port.state_dict()
    for k, t in fresh.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(t, want[k]), k


def jax_forward(case: Case):
    fn = jax.jit(lambda v, x: case.jmodel.apply(v, x, train=False))

    def forward(variables, x):
        with jax.default_matmul_precision("float32"):
            return np.asarray(fn(variables, x))
    return forward


def check_forward(case: Case, variables, port, forward, seed):
    """The eval forward at rtol/atol 1e-4."""
    x, _ = case.inputs(seed)
    want = forward(variables, x)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (x.shape[0], x.shape[1], case.num_classes)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _port_train(port):
    for mod in port.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return port.train()


def _grad_tree(case, port, variables):
    named = dict(port.named_parameters())
    grads = {k: (named[k].grad if k in named else torch.zeros_like(t))
             .numpy() for k, t in port.state_dict().items()}
    tree, _ = ci.import_state_dict(grads, variables["params"],
                                   variables["batch_stats"], case.mapping())
    return tree


def _jax_loss_and_grads(case, variables, x, y, dtype):
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)

    def loss_fn(p, stats, x, y):
        logits, _ = case.jmodel.apply({"params": p, "batch_stats": stats}, x,
                                      train=True, rngs=RNGS,
                                      mutable=["batch_stats"])
        return jops.cross_entropy(logits, y)

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            cast(variables["params"]), cast(variables["batch_stats"]),
            jnp.asarray(x, dtype), jnp.asarray(y))
    return float(loss), _flat(grads)


def _port_loss_and_grads(case, port, variables, x, y):
    dtype = next(port.parameters()).dtype
    loss = CrossEntropyLoss()(port(torch.from_numpy(x).to(dtype)),
                              torch.from_numpy(y))
    loss.backward()
    return loss.item(), _flat(_grad_tree(case, port, variables))


def _agreement(got, want):
    flipped = np.abs(got - want) > 5e-3 * np.abs(want).max()
    return flipped.mean(), np.linalg.norm(got - want) / np.linalg.norm(want)


def check_gradients(case: Case, variables, port, seed):
    """Train-mode loss and every parameter gradient against
    jax.value_and_grad of the flax model: port fp32 against JAX fp32 (loss
    rtol 5e-3, rel-L2 < 5e-2) and against JAX fp64 (loss rtol 1e-5, flipped
    fraction < 2e-3 at 5e-3 of the largest gradient, rel-L2 < 5e-2); port
    fp64 against JAX fp64 (loss rtol 1e-7, nothing flipped, rel-L2 <
    1e-6). Returns the measured (fp32 loss rel, fp32 rel-L2, fp64 flipped,
    fp64 rel-L2, port-fp64 rel-L2)."""
    import copy

    port = _port_train(port)
    port64 = copy.deepcopy(port).double()
    x, y = case.inputs(seed)
    loss_t, got = _port_loss_and_grads(case, port, variables, x, y)
    loss_j, want = _jax_loss_and_grads(case, variables, x, y, jnp.float32)
    rel32 = _agreement(got, want)[1]
    assert np.isclose(loss_t, loss_j, rtol=5e-3, atol=1e-5)
    assert rel32 < 5e-2, rel32
    with jax.enable_x64(True):
        loss_64, want = _jax_loss_and_grads(case, variables, x, y,
                                            jnp.float64)
    assert np.isclose(loss_t, loss_64, rtol=1e-5, atol=0)
    flipped, rel_l2 = _agreement(got, want)
    assert flipped < 2e-3 and rel_l2 < 5e-2, (flipped, rel_l2)
    loss_t64, got64 = _port_loss_and_grads(case, port64, variables, x, y)
    assert np.isclose(loss_t64, loss_64, rtol=1e-7, atol=0)
    flipped64, rel64 = _agreement(got64, want)
    assert flipped64 == 0 and rel64 < 1e-6, (flipped64, rel64)
    return abs(loss_t - loss_j) / abs(loss_j), rel32, flipped, rel_l2, rel64


def check_trajectory(case: Case, variables, port, k=3, lr=1e-3):
    """k Adam steps with the StepLR schedule of the configs (gamma 0.5, a
    step of 2 here so that it acts within k steps), the lr set before each
    step: the port's Trainer against the JAX Trainer on the same batches,
    per-step losses within the 3% band of tests/test_torch_train.py, step
    1 within 1e-4."""
    from pvcnn_tpu.nn.loss import CrossEntropyLoss as JCrossEntropyLoss
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import Adam as JAdam
    from pvcnn_tpu.train.optim import StepLR as JStepLR
    from pvcnn_tpu.train.optim import set_learning_rate as jset_lr
    from pvcnn_tpu.train.trainer import Trainer as JTrainer
    from pvcnn_tpu.train.trainer import TrainState

    batches = [case.inputs(10 + i) for i in range(k)]
    tx, _ = JAdam(lr)
    jtrainer = JTrainer(case.jmodel, JCrossEntropyLoss(), tx,
                        mesh=pmesh.make_mesh(1))
    # the state Trainer.init_state builds, from these variables (its own
    # eager model.init would take most of this test's time)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jax.device_put(
        TrainState(params=params, batch_stats=jax.tree.map(
            jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(params)),
        pmesh.replicated(jtrainer.mesh))
    jsched = JStepLR(step_size=2, gamma=0.5, base_lr=lr)
    losses_j = []
    with jax.default_matmul_precision("float32"):
        for i, (x, y) in enumerate(batches):
            jset_lr(state.opt_state, jsched(i))
            batch = pmesh.shard_batch((x, y.astype(np.int32)), jtrainer.mesh)
            state, loss = jtrainer._train_step(state, batch,
                                               jax.random.PRNGKey(0))
            losses_j.append(float(loss))

    port = _port_train(port)
    opt = toptim.Adam(port.parameters(), lr=lr)
    trainer = Trainer(port, CrossEntropyLoss(), opt, "cpu", seed=0)
    sched = toptim.StepLR(step_size=2, gamma=0.5).bind(lr)
    losses_t = []
    for i, (x, y) in enumerate(batches):
        toptim.set_learning_rate(opt, sched(i))
        losses_t.append(float(trainer.train_step(torch.from_numpy(x),
                                                 torch.from_numpy(y))))
    rel = np.abs(np.subtract(losses_t, losses_j)) / np.abs(losses_j)
    assert rel.max() < 3e-2, (losses_t, losses_j)
    assert rel[0] < 1e-4, rel[0]


@pytest.fixture(scope="module", params=sorted(CASES))
def pointnet2(request):
    """(case, flax variables, port model, jitted JAX forward), once per
    model."""
    case = CASES[request.param]
    variables, port = make_models(case)
    return case, variables, port, jax_forward(case)


@pytest.mark.parametrize("msg", [False, True])
@pytest.mark.parametrize("small", [True, False])
def test_state_dict_is_the_reference_layout(msg, small):
    """Keys and shapes equal TwinPointNet2's, so a released `.pth.tar`
    loads as it is; at full size every key but BatchNorm's step counters
    is named by checkpoint_import.pointnet2_shapenet_mapping."""
    case = CASES["msg" if msg else "ssg"]
    if small:
        check_layout(case.port(), case.twin())
        return
    from pvcnn_tpu.models.shapenet import pointnetpp as jpp
    from pvcnn_tpu_torch.models.shapenet import pointnetpp as tpp

    for name in ("SSG_SA_BLOCKS", "SSG_FP_BLOCKS", "MSG_SA_BLOCKS",
                 "MSG_FP_BLOCKS"):
        assert getattr(tpp, name) == getattr(jpp, name), name
    port = pointnet2_msg(50, 16) if msg else pointnet2_ssg(50, 16)
    twin = TwinPointNet2(
        50, 16, tpp.MSG_SA_BLOCKS if msg else tpp.SSG_SA_BLOCKS,
        tpp.MSG_FP_BLOCKS if msg else tpp.SSG_FP_BLOCKS,
        with_one_hot_shape_id=msg)
    check_layout(port, twin, ci.pointnet2_shapenet_mapping(msg))


def test_first_set_abstraction_takes_normals_and_offsets():
    """SA1's first layer reads the 3 normals and the 3 relative
    coordinates, as JAX's (6, 64) kernel does (create_pointnet2_sa_components
    had given it 9 inputs)."""
    port = pointnet2_ssg(50, 16)
    assert tuple(port.sa_layers[0].mlps[0].layers[0].weight.shape) == \
        (64, 6, 1, 1)
    shapes = jax.eval_shape(lambda: JPointNet2(
        num_classes=50, num_shapes=16, sa_blocks=SSG_SA, fp_blocks=FP_BLOCKS,
        with_one_hot_shape_id=False).init(
            jax.random.PRNGKey(0), np.zeros((1, 64, 6), np.float32)))
    kernel = shapes["params"]["PointNetSAModule_0"]["SharedMLP_0"][
        "Dense_0"]["kernel"]
    assert kernel.shape == (6, 64)
    msg = pointnet2_msg(50, 16)
    assert [tuple(m.layers[0].weight.shape[:2])
            for m in msg.sa_layers[0].mlps] == [(32, 6), (64, 6), (64, 6)]


def test_weights_from_jax_round_trip(pointnet2):
    case, variables, port, _ = pointnet2
    check_round_trip(case, variables, port)


@pytest.mark.parametrize("seed", [2, 3])
def test_eval_forward_matches_jax(pointnet2, seed):
    case, variables, port, forward = pointnet2
    check_forward(case, variables, port, forward, seed)


def test_one_step_gradients_match_jax(pointnet2, no_dropout, fp32_selection):
    """check_gradients' criteria, both sides selecting neighbors in fp32
    (as the Pallas kernels and the port's kernels do). Measured (fp32 loss
    rel, fp32 rel-L2, fp64 flipped, fp64 rel-L2, port fp64 rel-L2): SSG
    4.8e-7, 3.8e-4, 0, 1.1e-5, 7.0e-8; MSG 6.1e-8, 5.2e-5, 0, 1.2e-5,
    6.2e-8."""
    case, variables, _, _ = pointnet2
    check_gradients(case, variables, init_random_(case.port(), 1), 5)


def test_three_step_trajectory_matches_jax_trainer(pointnet2, no_dropout):
    case, variables, _, _ = pointnet2
    check_trajectory(case, variables, init_random_(case.port(), 1))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from pvcnn_tpu_torch.data import shapenet as tdata

    root = str(tmp_path_factory.mktemp("shapenet"))
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70)])
    return root


def test_evaluator_on_six_columns_matches_jax_votes(tree):
    """The voting evaluator with model_name pointnet2ssg builds the six
    columns (xyz, normals) SSG takes: the port's evaluate equals the same
    voting fed the JAX model's probabilities."""
    case = CASES["ssg"]
    variables, port = make_models(case)
    fn = jax.jit(lambda x: jax.nn.softmax(case.jmodel.apply(
        variables, x, train=False), -1))

    def jax_probs(x):
        assert x.shape[-1] == 6
        with jax.default_matmul_precision("float32"):
            return np.asarray(fn(x))

    kw = dict(num_points=64, num_votes=2, batch_size=4, seed=0)
    got = teval.evaluate(tree, model=port, model_name="pointnet2ssg",
                         device="cpu", **kw)
    spec = MODELS["pointnet2ssg"]
    want = teval.evaluate_with(jax_probs, tree,
                               with_normal=spec.with_normal,
                               with_one_hot_shape_id=spec
                               .with_one_hot_shape_id, **kw)
    assert got.shape == (16, 2) and got[:, 1].sum() == 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
