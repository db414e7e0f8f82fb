"""S3DIS PVCNN2 with bf16 activations (dtype="bfloat16") against the JAX
package's PVCNN2(dtype="bfloat16") and its fp32 PVCNN2: the eval forward,
the train-mode gradients, 3-step Adam trajectories and the dtypes of what
a step keeps.

Model size as tests/test_torch_pvcnn2.py: the shrunk blocks of
tests/test_model_parity.py at width 0.5, B = 2, N = 128 S3DIS-like
windows, dropout off. JAX runs its XLA formulations on the CPU at fp32
matmul precision, one compile a function and dtype.

The rule is tests/test_torch_bf16_model.py's: `own` is JAX bf16's rel-L2
distance from JAX fp32; the port in bf16 lies within [own / 2, 2 own +
1e-3] of JAX fp32 and within sqrt(2) own + 1e-3 of JAX bf16, where it
compares many numbers (the logits, the gradients); the losses are held to
its bound (check_train_gradients, check_trajectory say how). The JAX side's loss widens the
logits to f32 first, as the port's does (pvcnn_tpu_torch/ops/losses.py):
JAX's own cross_entropy runs its log-softmax in bf16 and returns a bf16
scalar, a rounding of ~2^-9 that the port deliberately leaves out and that
would stand in the losses' comparison (3 PVCNN2 losses sat 1.3e-2 from
JAX bf16's against an own of 7.6e-3 with it).
The helpers here (`Bf16Case` and the three checks) serve
tests/test_torch_bf16_s3dis_pvcnn.py and tests/test_torch_bf16_pointnetpp.py
too.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.models.utils import Dropout
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.trainer import Trainer
from pvcnn_tpu_torch.utils.weights import init_random_
from test_model_parity import _pvcnn2_mapping
from test_torch_bf16_model import _rel, _within_rule
from test_torch_pvcnn2 import _SmallJPVCNN2, _SmallPVCNN2, WIDTH, windows
from test_torch_train import _flat, no_dropout  # noqa: F401 (fixture)

RNGS = {"dropout": jax.random.PRNGKey(1)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module and the files that import it
    (tests/test_torch_cli.py: six workers' full thread pools oversubscribe
    the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_loss(logits, labels):
    """JAX's cross entropy of the logits widened to f32 (the port's)."""
    return jops.cross_entropy(logits.astype(jnp.float32), labels)


class Bf16Case(NamedTuple):
    """A model of the port in bf16 beside its JAX counterparts."""

    jmodels: dict                   # None / "bfloat16" -> flax module
    variables: dict                 # flax params and batch_stats
    port: Callable                  # () -> the port's bf16 model, dropout off
    mapping: list                   # checkpoint_import entries
    inputs: Callable                # seed -> (x [B, N, C], labels [B, N])
    num_classes: int
    jitted: dict                    # the JAX functions compiled so far


def jax_grad_fn(case: Bf16Case, dtype):
    """The JAX model's train-mode ((loss, f32 logits), parameter
    gradients) at params, x, y, in `dtype` (None: fp32), jitted once a case
    and dtype: the gradient test and the trajectories share the compile."""
    if dtype not in case.jitted:
        jmodel = case.jmodels[dtype]

        def loss_fn(p, xx, yy):
            logits, _ = jmodel.apply(
                {"params": p, "batch_stats": case.variables["batch_stats"]},
                xx, train=True, rngs=RNGS, mutable=["batch_stats"])
            return jax_loss(logits, yy), logits.astype(jnp.float32)

        case.jitted[dtype] = jax.jit(jax.value_and_grad(loss_fn,
                                                        has_aux=True))
    return case.jitted[dtype]


def make_case(jmodel_of, port_of, mapping, inputs, num_classes, seed=1):
    """jmodel_of(dtype) -> flax module, port_of(dtype) -> the port's. The
    port draws the weights (init_random_: BatchNorm statistics included)
    and checkpoint_import moves them into the flax tree, whose shapes come
    from jax.eval_shape (no eager init)."""
    jmodels = {dt: jmodel_of(dt) for dt in (None, "bfloat16")}
    shapes = jax.eval_shape(lambda: jmodels[None].init(
        jax.random.PRNGKey(0), inputs(0)[0], train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    state = init_random_(port_of(None), seed).state_dict()
    params, stats = ci.import_state_dict(
        {k: t.numpy() for k, t in state.items()}, zeros["params"],
        zeros.get("batch_stats", {}), mapping)

    def port():
        model = port_of("bfloat16")
        model.load_state_dict(state)
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        return model
    return Bf16Case(jmodels, {"params": params, "batch_stats": stats}, port,
                    mapping, inputs, num_classes, {})


def check_eval_forward(case: Bf16Case, seed: int):
    """Eval-mode logits: bf16 out, the rule against JAX bf16 and fp32."""
    x, _ = case.inputs(seed)
    want = {}
    for dt, jmodel in case.jmodels.items():
        fn = jax.jit(lambda v, xx, m=jmodel: m.apply(v, xx, train=False))
        with jax.default_matmul_precision("float32"):
            want[dt] = np.asarray(jnp.asarray(fn(case.variables, x),
                                              jnp.float32))
    model = case.port().eval()
    assert model.act_dtype == torch.bfloat16
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    assert got.shape == x.shape[:2] + (case.num_classes,)
    assert torch.isfinite(got).all()
    return _within_rule(got.float().numpy(), want["bfloat16"], want[None])


def _grad_tree(case, model):
    named = dict(model.named_parameters())
    grads = {k: (named[k].grad if k in named else torch.zeros_like(t))
             .numpy() for k, t in model.state_dict().items()}
    tree, _ = ci.import_state_dict(grads, case.variables["params"],
                                   case.variables["batch_stats"],
                                   case.mapping)
    return tree


def check_train_gradients(case: Bf16Case, seed: int):
    """Train-mode logits (the batch statistics' BatchNorms), loss and every
    parameter gradient: the loss f32, the gradients float32 (the
    parameters' dtype); the rule against JAX bf16 and fp32 for the logits
    and the gradients. The loss is one number, which two bf16 runs may
    miss by amounts far apart: it is held within the rule's bound of the
    logits, 2 own + 1e-3 of JAX fp32's loss, own being the logits'."""
    x, y = case.inputs(seed)
    want = {}
    for dt in case.jmodels:
        with jax.default_matmul_precision("float32"):
            (loss, logits), grads = jax_grad_fn(case, dt)(
                case.variables["params"], x, y.astype(np.int32))
        want[dt] = (float(loss), np.asarray(logits), _flat(grads))
    model = case.port().train()
    logits = model(torch.from_numpy(x))
    loss = CrossEntropyLoss()(logits, torch.from_numpy(y))
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    got = _flat(_grad_tree(case, model))
    _, own = _within_rule(logits.detach().float().numpy(),
                          want["bfloat16"][1], want[None][1])
    dist = abs(loss.item() - want[None][0]) / abs(want[None][0])
    assert dist <= 2 * own + 1e-3, (dist, own)
    return _within_rule(got, want["bfloat16"][2], want[None][2])


def check_trajectory(case: Bf16Case, weight_decay: float, k: int = 3,
                     runs: int = 4, lr: float = 1e-3):
    """`runs` trajectories of k Adam steps (the recipe's weight decay) from
    the same weights on batches of their own, the port's Trainer against
    the JAX Trainer's step in bf16 and in fp32 (the model's jitted
    value_and_grad, shared with check_train_gradients, then the JAX
    package's Adam as the Trainer applies it; BatchNorm in train mode
    normalizes by the batch, so the running statistics the Trainer also
    carries do not enter the losses): the runs * k losses within 2 own +
    1e-3 of JAX fp32's (the rule's bound); after the steps the
    parameters, BatchNorm statistics and Adam moments are float32.

    A bf16 trajectory is a noisy sample: at these sizes bf16's step-1
    gradients lie 0.2-0.7 (rel-L2) from fp32's in both packages (gate
    flips, max-pool winners; MSG 0.67 in the port and 0.65 in JAX, 18.9%
    and 18.4% of the elements of another sign), and Adam's first step
    moves a parameter by a full step whatever its gradient's size, so the
    losses after it scatter around fp32's. One run's 3 losses are too few
    for the band (MSG's: the port 8.5e-3 from JAX fp32, JAX bf16 2.2e-3);
    several runs sample it. The rule's floor and its third clause (within
    sqrt(2) own + 1e-3 of JAX bf16) are held where they compare many
    numbers, the logits and the gradients."""
    from pvcnn_tpu.train.optim import Adam as JAdam

    trajectories = [[case.inputs(20 + 10 * r + i) for i in range(k)]
                    for r in range(runs)]
    tx, _ = JAdam(lr, weight_decay=weight_decay)

    @jax.jit
    def update(params, opt_state, grads):
        # the JAX Trainer's step after its value_and_grad
        # (pvcnn_tpu/train/trainer.py:_train_step_impl)
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree.map(lambda p, u: p + u, params, updates), opt_state

    want = {}
    for dt in case.jmodels:
        losses = []
        for batches in trajectories:
            params = jax.tree.map(jnp.asarray, case.variables["params"])
            opt_state = tx.init(params)
            for x, y in batches:
                with jax.default_matmul_precision("float32"):
                    (loss, _), grads = jax_grad_fn(case, dt)(
                        params, x, y.astype(np.int32))
                params, opt_state = update(params, opt_state, grads)
                losses.append(float(loss))
        want[dt] = losses

    got = []
    for batches in trajectories:
        model = case.port()
        opt = toptim.Adam(model.parameters(), lr=lr,
                          weight_decay=weight_decay)
        trainer = Trainer(model, CrossEntropyLoss(), opt, "cpu", seed=0)
        got += [float(trainer.train_step(torch.from_numpy(x),
                                         torch.from_numpy(y)))
                for x, y in batches]
    assert np.isfinite(got).all()
    assert {t.dtype for t in model.state_dict().values()
            if t.is_floating_point()} == {torch.float32}
    moments = [v for s in opt.state.values() for v in s.values()
               if torch.is_tensor(v) and v.is_floating_point() and v.dim()]
    assert moments and {t.dtype for t in moments} == {torch.float32}
    dist, own = _rel(got, want[None]), _rel(want["bfloat16"], want[None])
    assert dist <= 2 * own + 1e-3, (dist, own)
    return dist, own


@pytest.fixture(scope="module")
def case():
    return make_case(
        lambda dt: _SmallJPVCNN2(num_classes=13, extra_feature_channels=6,
                                 width_multiplier=WIDTH, dtype=dt),
        lambda dt: _SmallPVCNN2(13, 6, width_multiplier=WIDTH, dtype=dt),
        _pvcnn2_mapping(), windows, 13)


def test_eval_forward(case):
    check_eval_forward(case, 5)


def test_train_gradients(case, no_dropout):
    check_train_gradients(case, 2)


def test_three_step_trajectory(case, no_dropout):
    check_trajectory(case, weight_decay=1e-5)


def test_take_rows_backwards_run_in_bf16(case, monkeypatch):
    """Every take_rows backward of a training step gets a bf16 cotangent
    (the groupings and interpolations of bf16 features), so K1's bf16 sum
    mode serves them all: 4 groupings and 4 interpolations."""
    from pvcnn_tpu_torch.ops import gather_utils

    seen = []
    scatter_sum = gather_utils.scatter_sum
    monkeypatch.setattr(gather_utils, "scatter_sum", lambda g, i, m: (
        seen.append(g.dtype), scatter_sum(g, i, m))[1])
    x, y = case.inputs(7)
    model = case.port().train()
    CrossEntropyLoss()(model(torch.from_numpy(x)),
                       torch.from_numpy(y)).backward()
    assert seen == [torch.bfloat16] * 8
