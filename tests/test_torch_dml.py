"""The port's deep mutual learning against the JAX package: kl_loss and
KLLoss, DMLTrainer's step (both peers' losses, gradients and BatchNorm
running statistics) and a three-step trajectory against JAX's DMLTrainer
(tests/test_torch_dml_cli.py holds the per-step learning rate, named
losses and the entry point `python -m pvcnn_tpu_torch.train.dml`).

Model size: ShapeNet PVCNN at width 0.25 and voxel_resolution_multiplier
0.5 (PVConv grids at R = 16 and 8), B = 2 clouds of N = 128 points, as
tests/test_torch_train.py. The peers' weights are JAX's DMLTrainer's own
(param seeds 0 and 100) with their BatchNorm scales, biases and statistics
redrawn, carried into the port by state_dict_from_jax. Dropout is off on
both sides. JAX runs its CPU formulations in fp64, jitted once: one run of
its DMLTrainer with SGD serves the gradient and trajectory tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu.models.shapenet import PVCNN as JPVCNN
from pvcnn_tpu.ops import losses as jlosses
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.models.shapenet import PVCNN
from pvcnn_tpu_torch.models.utils import Dropout
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss, KLLoss
from pvcnn_tpu_torch.ops import losses as tlosses
from pvcnn_tpu_torch.train.trainer import STUDENT_SEED_OFFSET, DMLTrainer
from pvcnn_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_train import _flat, _grad_tree, _inputs

B, N = 2, 128
SIZE = dict(width_multiplier=0.25, voxel_resolution_multiplier=0.5)
# the SGD step: JAX's step-1 gradient is (p0 - p1) / LR
LR = 2.0 ** -12
TRAJECTORY = [_inputs(10 + i, B, N) for i in range(3)]
PEERS = ("teacher", "student")
TAGS = {"teacher": "loss/train", "student": "loss/train_student"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module (tests/test_torch_frustum.py: six
    workers' full thread pools oversubscribe the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(5, 50), (2, 7, 13)])
def test_kl_loss_matches_jax(shape):
    """The fp64 value at rtol 1e-12, the gradient with respect to y at rtol
    1e-7, and exactly no gradient with respect to x (detached), on both
    sides; KLLoss is kl_loss."""
    rng = np.random.RandomState(0)
    x, y = rng.randn(*shape) * 3, rng.randn(*shape) * 3
    with jax.enable_x64(True):
        want = float(jlosses.kl_loss(jnp.asarray(x), jnp.asarray(y)))
        gx, gy = jax.grad(jlosses.kl_loss, argnums=(0, 1))(jnp.asarray(x),
                                                           jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    loss = tlosses.kl_loss(xt, yt)
    loss.backward()
    assert np.isclose(loss.item(), want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), rtol=1e-7,
                               atol=1e-15)
    assert xt.grad is None and not np.asarray(gx).any()
    assert KLLoss()(xt, yt).item() == loss.item()


def _randomize_bn(tree, seed):
    """BatchNorm scale and running variance in [0.6, 1.4], bias and
    running mean N(0, 0.1), so every statistic takes part in the forward
    (tests/test_torch_train.py:_models)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def peers():
    """(flax model, {peer: flax variables}) drawn as JAX's
    DMLTrainer.init_state draws them (param seeds 0 and 100; its init,
    jitted here once: eager, it took 21 s a peer), BatchNorms redrawn."""
    jmodel = JPVCNN(num_classes=50, num_shapes=16, extra_feature_channels=3,
                    **SIZE)
    x = TRAJECTORY[0][0][:1]
    init = jax.jit(lambda seed: jmodel.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)}, x, train=False))
    variables = {}
    for k, (peer, seed) in enumerate(zip(PEERS, (0, 100))):
        v = jax.device_get(init(seed))
        variables[peer] = {
            "params": _randomize_bn(v["params"], 10 + k),
            "batch_stats": _randomize_bn(v["batch_stats"], 20 + k)}
    return jmodel, variables


def _port(variables, dtype=torch.float32):
    """The port's PVCNN holding flax variables, train mode, dropout off."""
    port = PVCNN(50, 16, 3, **SIZE)
    port.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"],
        ci.pvcnn_shapenet_mapping(), port.state_dict()))
    for mod in port.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return port.to(dtype).train()


@pytest.fixture(scope="module")
def jax_dml(peers):
    """JAX's DMLTrainer with SGD at LR in fp64 (dropout off) over the three
    TRAJECTORY batches -> ({peer: losses}, {peer: step-1 gradients},
    {peer: BatchNorm statistics after step 1}), flattened in the flax
    trees' order."""
    import flax.linen as fnn

    from pvcnn_tpu.nn.loss import CrossEntropyLoss as JCE
    from pvcnn_tpu.nn.loss import KLLoss as JKL
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import SGD
    from pvcnn_tpu.train.trainer import DMLState as JDMLState
    from pvcnn_tpu.train.trainer import DMLTrainer as JDMLTrainer
    from pvcnn_tpu.train.trainer import TrainState

    jmodel, variables = peers
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
    losses = {p: [] for p in PEERS}
    grads, stats = {}, {}
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), \
            jax.default_matmul_precision("highest"):
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        (tx, _), (tx_s, _) = SGD(LR), SGD(LR)
        jt = JDMLTrainer(jmodel, JCE(), tx, tx_s, JKL(),
                         mesh=pmesh.make_mesh(1))
        one = lambda v, t: TrainState(
            params=cast(v["params"]), batch_stats=cast(v["batch_stats"]),
            opt_state=t.init(cast(v["params"])))
        state = jax.device_put(
            JDMLState(teacher=one(variables["teacher"], tx),
                      student=one(variables["student"], tx_s)),
            pmesh.replicated(jt.mesh))
        before = {p: _flat(getattr(state, p).params) for p in PEERS}
        for x, y in TRAJECTORY:
            data = pmesh.shard_batch(
                (np.asarray(x, np.float64), y.astype(np.int32)), jt.mesh)
            state, loss = jt._train_step(state, data, jax.random.PRNGKey(0))
            for p in PEERS:
                losses[p].append(float(loss[TAGS[p]]))
            if not grads:
                for p in PEERS:
                    s = getattr(state, p)
                    grads[p] = (before[p] - _flat(s.params)) / LR
                    stats[p] = _flat(s.batch_stats)
    return losses, grads, stats


def _dml(peers, dtype):
    _, variables = peers
    t, s = (_port(variables[p], dtype) for p in PEERS)
    return DMLTrainer(t, CrossEntropyLoss(),
                      torch.optim.SGD(t.parameters(), lr=LR), s,
                      torch.optim.SGD(s.parameters(), lr=LR), KLLoss(),
                      "cpu", seed=0)


def _torch(x, y, dtype):
    return torch.from_numpy(x).to(dtype), torch.from_numpy(y)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dml_step_matches_jax(peers, jax_dml, dtype):
    """One DMLTrainer step against JAX's DMLTrainer in fp64. In fp64 both
    peers' losses at rtol 1e-9, every gradient at rel-L2 < 1e-6, and
    every BatchNorm running statistic after the step at rtol 1e-9 (JAX
    keeps only its gradient pass's statistics; a port that ran two
    forwards a peer would move them twice). In fp32 the losses at rtol
    1e-5 and the gradients at rel-L2 < 5e-2 (tests/test_torch_train.py's
    bound against fp64)."""
    _, variables = peers
    losses_j, grads_j, stats_j = jax_dml
    dt = getattr(torch, dtype)
    trainer = _dml(peers, dt)
    got = trainer.train_step(*_torch(*TRAJECTORY[0], dt))
    for p, model in zip(PEERS, (trainer.model, trainer.student.model)):
        grads = _flat(_grad_tree(model, variables[p]))
        loss = got[TAGS[p]].item()
        if dtype == "float64":
            assert np.isclose(loss, losses_j[p][0], rtol=1e-9, atol=0), p
            assert _rel_l2(grads, grads_j[p]) < 1e-6, p
            _, bn = ci.import_state_dict(
                {k: v.numpy() for k, v in model.state_dict().items()},
                variables[p]["params"], variables[p]["batch_stats"],
                ci.pvcnn_shapenet_mapping())
            np.testing.assert_allclose(_flat(bn), stats_j[p], rtol=1e-9,
                                       atol=1e-12, err_msg=p)
        else:
            assert np.isclose(loss, losses_j[p][0], rtol=1e-5, atol=0), p
            assert _rel_l2(grads, grads_j[p]) < 5e-2, p


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dml_trajectory_matches_jax(peers, jax_dml, dtype):
    """Three DMLTrainer steps, both peers' losses against JAX's fp64 run:
    in fp64 within 1e-6 at every step, in fp32 step 1 within 1e-3 and
    steps 2-3 within 3e-2 (the bands of tests/test_torch_frustum.py)."""
    losses_j, _, _ = jax_dml
    dt = getattr(torch, dtype)
    trainer = _dml(peers, dt)
    got = [trainer.train_step(*_torch(x, y, dt)) for x, y in TRAJECTORY]
    for p in PEERS:
        mine = [float(step[TAGS[p]]) for step in got]
        rel = np.abs(np.subtract(mine, losses_j[p])) / np.abs(losses_j[p])
        if dtype == "float64":
            assert rel.max() < 1e-6, (p, mine, losses_j[p])
        else:
            assert rel[0] < 1e-3 and rel.max() < 3e-2, (p, mine, losses_j[p])


def test_dml_peers_are_seeded_apart(peers):
    """The student's dropout and sample generators start from seed +
    STUDENT_SEED_OFFSET, the teacher's from seed."""
    trainer = _dml(peers, torch.float32)
    want = torch.Generator().manual_seed(STUDENT_SEED_OFFSET)
    assert torch.equal(trainer.student.generator.get_state(),
                       want.get_state())
    assert not torch.equal(trainer.generator.get_state(),
                           trainer.student.generator.get_state())
