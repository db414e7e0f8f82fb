"""The port's ShapeNet PVCNN training step against the JAX package: one-step
loss and gradients, and a five-step Adam trajectory against the JAX Trainer
(tests/test_torch_trainer.py covers the optimizer, the meter, the data and
the trainer entry point).

Model size: width 0.25 and voxel_resolution_multiplier 0.5 (PVConv grids at
R = 16 and 8), B = 2, N = 256, as tests/test_torch_model.py. Dropout is off
on both sides. JAX runs its CPU formulations at fp32 matmul precision.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.models.shapenet import PVCNN as JPVCNN
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.models.shapenet import PVCNN
from pvcnn_tpu_torch.models.utils import Dropout
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.trainer import Trainer
from pvcnn_tpu_torch.utils.weights import state_dict_from_jax

B, N = 2, 256
SIZE = dict(width_multiplier=0.25, voxel_resolution_multiplier=0.5)
RNGS = {"dropout": jax.random.PRNGKey(1)}


def _inputs(seed, b=B, n=N):
    """[b, n, 22] inputs and [b, n] labels inside each cloud's part range."""
    rng = np.random.RandomState(seed)
    xyz = rng.randn(b, n, 3) * [1.0, 0.6, 0.3]
    xyz -= xyz.mean(axis=1, keepdims=True)
    xyz /= np.linalg.norm(xyz, axis=-1).max(axis=1)[:, None, None]
    normals = rng.randn(b, n, 3)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    shape = rng.randint(0, 16, b)
    one_hot = np.zeros((b, n, 16))
    one_hot[np.arange(b), :, shape] = 1.0
    x = np.concatenate([xyz, normals, one_hot], -1).astype(np.float32)
    parts = [tdata.SHAPE_PART_CLASSES[s][1] for s in shape]
    y = np.stack([rng.randint(p[0], p[-1] + 1, n) for p in parts])
    return x, y.astype(np.int64)


@pytest.fixture
def no_dropout(monkeypatch):
    import flax.linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)


def _models(seed=1):
    """(flax model, randomized flax variables, port model holding them, in
    train mode with its Dropouts off)."""
    jmodel = JPVCNN(num_classes=50, num_shapes=16, extra_feature_channels=3,
                    **SIZE)
    v = jmodel.init(jax.random.PRNGKey(0), _inputs(0)[0], train=False)
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        return np.asarray(x, np.float32)

    variables = {k: jax.tree_util.tree_map_with_path(leaf, v[k])
                 for k in ("params", "batch_stats")}
    port = PVCNN(50, 16, 3, **SIZE)
    port.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"],
        ci.pvcnn_shapenet_mapping(), port.state_dict()))
    for mod in port.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return jmodel, variables, port.train()


def _grad_tree(port, variables):
    named = dict(port.named_parameters())
    grads = {k: (named[k].grad if k in named else torch.zeros_like(t))
             .numpy() for k, t in port.state_dict().items()}
    tree, _ = ci.import_state_dict(grads, variables["params"],
                                   variables["batch_stats"],
                                   ci.pvcnn_shapenet_mapping())
    return tree


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(g, np.float64))
                           for g in jax.tree.leaves(tree)])


def _jax_loss_and_grads(jmodel, variables, x, y, dtype):
    cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
    params, stats = cast(variables["params"]), cast(variables["batch_stats"])

    def loss_fn(p):
        logits, _ = jmodel.apply({"params": p, "batch_stats": stats},
                                 jnp.asarray(x, dtype), train=True,
                                 rngs=RNGS, mutable=["batch_stats"])
        return jops.cross_entropy(logits, jnp.asarray(y))

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), _flat(grads)


@pytest.mark.parametrize("seed", [2, 3])
def test_one_step_gradients_match_jax(no_dropout, seed):
    """Train-mode loss and every parameter gradient against
    jax.value_and_grad of the flax model.

    The criteria of tests/test_model_parity.py hold against JAX in fp64 (the
    same function without rounding), tightened to what was measured there:
    loss rtol 1e-6, flipped fraction 0 at 5e-3 of the largest gradient,
    rel-L2 < 1e-4 (measured 2.2e-6 and 2.7e-6). Against JAX in fp32 the
    loss holds at rtol 5e-3 and the rel-L2 at 5e-2 (measured 9.5e-3 and
    1.5e-2): that much is JAX fp32's own distance from JAX fp64 (the port
    and JAX agree to 2.5e-8 in fp64), which also flips 0.29% of the
    elements at seed 3, so the flipped-fraction test is held against fp64
    only."""
    jmodel, variables, port = _models()
    x, y = _inputs(seed)
    loss_t = CrossEntropyLoss()(port(torch.from_numpy(x)),
                                torch.from_numpy(y))
    loss_t.backward()
    got = _flat(_grad_tree(port, variables))
    loss_j, want = _jax_loss_and_grads(jmodel, variables, x, y, jnp.float32)
    assert np.isclose(loss_t.item(), loss_j, rtol=5e-3, atol=1e-5)
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 5e-2, rel_l2
    with jax.enable_x64(True):
        loss_64, want = _jax_loss_and_grads(jmodel, variables, x, y,
                                            jnp.float64)
    assert np.isclose(loss_t.item(), loss_64, rtol=1e-6, atol=0)
    flipped = np.abs(got - want) > 5e-3 * np.abs(want).max()
    assert not flipped.any(), flipped.mean()
    rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel_l2 < 1e-4, rel_l2


def test_five_step_trajectory_matches_jax_trainer(no_dropout):
    """Five Adam steps (weight decay on) with a cosine lr set before each
    step, the port's Trainer against the JAX Trainer on the same batches:
    per-step losses within the 3% band of tests/test_trajectory_parity.py
    (measured drift: 2.6e-6 at step 1, at most 2.9e-3 by step 4; JAX's
    fp32 gradients differ from its own fp64 ones by about 1%, and Adam
    carries that into the later steps)."""
    from pvcnn_tpu.nn.loss import CrossEntropyLoss as JCrossEntropyLoss
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import Adam as JAdam
    from pvcnn_tpu.train.optim import CosineAnnealingLR as JCosine
    from pvcnn_tpu.train.optim import set_learning_rate as jset_lr
    from pvcnn_tpu.train.trainer import Trainer as JTrainer

    k, lr, wd = 5, 1e-3, 1e-4
    batches = [_inputs(10 + i) for i in range(k)]
    jmodel, variables, port = _models()
    tx, _ = JAdam(lr, weight_decay=wd)
    jtrainer = JTrainer(jmodel, JCrossEntropyLoss(), tx,
                        mesh=pmesh.make_mesh(1))
    state = jtrainer.init_state(batches[0][0][:1])
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"])
    jsched = JCosine(t_max=k, base_lr=lr)
    losses_j = []
    with jax.default_matmul_precision("float32"):
        for i, (x, y) in enumerate(batches):
            jset_lr(state.opt_state, jsched(i))
            batch = pmesh.shard_batch((x, y.astype(np.int32)), jtrainer.mesh)
            state, loss = jtrainer._train_step(state, batch,
                                               jax.random.PRNGKey(0))
            losses_j.append(float(loss))

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
    assert losses_t[-1] < losses_t[0]
