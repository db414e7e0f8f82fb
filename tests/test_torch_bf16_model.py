"""ShapeNet PVCNN with bf16 activations (dtype="bfloat16") against the JAX
package's PVCNN(dtype="bfloat16") and its fp32 PVCNN: the eval forward,
the train-mode gradients, a 3-step Adam trajectory, the dtypes of what
a step keeps, and --configs.model.dtype through the config entry points.

Model size as tests/test_torch_train.py: width 0.25, voxel resolution x0.5
(grids at R = 16 and 8), B = 2, N = 256, dropout off. JAX runs its XLA
formulations on the CPU at fp32 matmul precision, one compile a function.

The rule: bf16 rounds at other places in the two packages (the JAX CPU
formulations round some sums the port keeps in f32, and XLA may keep
excess precision), so the port is not held to JAX bf16 element by
element. It is held to the distance bf16 itself costs, `own`, JAX bf16's
rel-L2 distance from JAX fp32:
  - the port's distance from JAX fp32 is at most 2 * own + 1e-3;
  - its distance from JAX bf16 is at most sqrt(2) * own + 1e-3, the
    distance of two bf16 runs that round as often as JAX does, each at
    own from fp32, in independent places;
  - its distance from JAX fp32 is at least own / 2: the port does round
    (a port that kept fp32 activations would sit ~1e-6 from JAX fp32).
The gradients' own is large: rounding the activations flips LeakyReLU /
ReLU gates whose inputs lie within a rounding of zero, and the gradient
of a flipped element moves by its whole size, so the distance grows layer
by layer down the backward pass (the classifier's last weight moves
least, the PVConv convs' weights most). Rounding only the input normals
of the fp32 model moves its gradients by a large share of that too; the
card's readings are in PERF.md (chip_smoke.py phase 29).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvcnn_tpu import ops as jops
from pvcnn_tpu.models.shapenet import PVCNN as JPVCNN
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.data import shapenet as tdata
from pvcnn_tpu_torch.evaluate.__main__ import main as evaluate_main
from pvcnn_tpu_torch.models.shapenet import PVCNN
from pvcnn_tpu_torch.models.utils import Dropout
from pvcnn_tpu_torch.nn.loss import CrossEntropyLoss
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.cli import prepare, run
from pvcnn_tpu_torch.train.trainer import Trainer
from pvcnn_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_train import (_flat, _grad_tree, _inputs,  # noqa: F401
                              no_dropout)

B, N = 2, 256
SIZE = dict(width_multiplier=0.25, voxel_resolution_multiplier=0.5)
RNGS = {"dropout": jax.random.PRNGKey(1)}
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pvcnn_tpu_torch", "configs")


def _rel(a, b):
    a, b = (np.asarray(v, np.float64).ravel() for v in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _within_rule(port, jax_bf16, jax_fp32, floor=True):
    """The port's bf16 against JAX bf16 and fp32 by the module's rule;
    floor=False leaves out the floor (the step-1 loss: JAX rounds the loss
    scalar itself to bf16, the port keeps it f32, ops/losses.py)."""
    got, own = _rel(port, jax_fp32), _rel(jax_bf16, jax_fp32)
    apart = _rel(port, jax_bf16)
    assert got <= 2 * own + 1e-3, (got, own)
    assert not floor or got >= own / 2, (got, own)
    assert apart <= np.sqrt(2) * own + 1e-3, (apart, own)
    return got, own


@pytest.fixture(scope="module")
def models():
    """(JAX fp32 model, JAX bf16 model, randomized flax variables, a
    function that builds the port's bf16 model holding them, dropout
    off)."""
    jmodels = {dt: JPVCNN(num_classes=50, num_shapes=16,
                          extra_feature_channels=3, dtype=dt, **SIZE)
               for dt in (None, "bfloat16")}
    # the variables' shapes without running flax's eager init; kernels are
    # drawn with lecun-normal scales, as that init draws them
    v = jax.eval_shape(lambda x: jmodels[None].init(
        jax.random.PRNGKey(0), x, train=False), _inputs(0)[0])
    rng = np.random.RandomState(1)

    def leaf(path, x):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.6, 1.4, x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)

    variables = {k: jax.tree_util.tree_map_with_path(leaf, v[k])
                 for k in ("params", "batch_stats")}

    def port():
        model = PVCNN(50, 16, 3, dtype="bfloat16", **SIZE)
        model.load_state_dict(state_dict_from_jax(
            variables["params"], variables["batch_stats"],
            ci.pvcnn_shapenet_mapping(), model.state_dict()))
        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        return model
    return jmodels, variables, port


def test_eval_forward(models):
    """Eval-mode logits: bf16 out, the rule against JAX bf16 and fp32."""
    jmodels, variables, port = models
    x, _ = _inputs(5)
    want = {}
    for dt, jmodel in jmodels.items():
        fn = jax.jit(lambda v, xx, m=jmodel: m.apply(v, xx, train=False))
        with jax.default_matmul_precision("float32"):
            want[dt] = np.asarray(jnp.asarray(fn(variables, x), jnp.float32))
    model = port().eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, 50)
    assert torch.isfinite(got).all()
    _within_rule(got.float().numpy(), want["bfloat16"], want[None])


def test_train_gradients(models, no_dropout):
    """Train-mode loss and every parameter gradient: the gradients are
    float32 (the parameters' dtype), and the rule holds against JAX bf16
    and fp32 for the gradients and the loss."""
    jmodels, variables, port = models
    x, y = _inputs(2)
    want = {}
    for dt, jmodel in jmodels.items():
        def loss_fn(p, xx, yy, m=jmodel):
            logits, _ = m.apply({"params": p,
                                 "batch_stats": variables["batch_stats"]},
                                xx, train=True, rngs=RNGS,
                                mutable=["batch_stats"])
            return jops.cross_entropy(logits, yy).astype(jnp.float32)

        with jax.default_matmul_precision("float32"):
            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
                variables["params"], x, y.astype(np.int32))
        want[dt] = (float(loss), _flat(grads))
    model = port().train()
    loss = CrossEntropyLoss()(model(torch.from_numpy(x)), torch.from_numpy(y))
    assert loss.dtype == torch.float32
    loss.backward()
    assert {p.grad.dtype for p in model.parameters()} == {torch.float32}
    got = _flat(_grad_tree(model, variables))
    _within_rule(got, want["bfloat16"][1], want[None][1])
    _within_rule([loss.item()], [want["bfloat16"][0]], [want[None][0]],
                 floor=False)


def test_three_step_trajectory(models, no_dropout):
    """Three Adam steps (weight decay on), the port's Trainer against the
    JAX Trainer in bf16 and in fp32 on the same batches: the rule on the
    losses; after the steps the parameters, BatchNorm statistics and Adam
    moments are float32."""
    from pvcnn_tpu.nn.loss import CrossEntropyLoss as JCrossEntropyLoss
    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import Adam as JAdam
    from pvcnn_tpu.train.trainer import Trainer as JTrainer
    from pvcnn_tpu.train.trainer import TrainState

    jmodels, variables, port = models
    k, lr, wd = 3, 1e-3, 1e-4
    batches = [_inputs(20 + i) for i in range(k)]
    want = {}
    for dt, jmodel in jmodels.items():
        tx, _ = JAdam(lr, weight_decay=wd)
        jtrainer = JTrainer(jmodel, JCrossEntropyLoss(), tx,
                            mesh=pmesh.make_mesh(1))
        # init_state's state without its eager flax init
        state = jax.device_put(
            TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"])),
            pmesh.replicated(jtrainer.mesh))
        losses = []
        with jax.default_matmul_precision("float32"):
            for x, y in batches:
                batch = pmesh.shard_batch((x, y.astype(np.int32)),
                                          jtrainer.mesh)
                state, loss = jtrainer._train_step(state, batch,
                                                   jax.random.PRNGKey(0))
                losses.append(float(jnp.asarray(loss, jnp.float32)))
        want[dt] = losses

    model = port()
    opt = toptim.Adam(model.parameters(), lr=lr, weight_decay=wd)
    trainer = Trainer(model, CrossEntropyLoss(), opt, "cpu", seed=0)
    got = [float(trainer.train_step(torch.from_numpy(x),
                                    torch.from_numpy(y)))
           for x, y in batches]
    _within_rule(got, want["bfloat16"], want[None])
    assert np.isfinite(got).all()
    assert {t.dtype for t in model.state_dict().values()
            if t.is_floating_point()} == {torch.float32}
    moments = [v for s in opt.state.values() for v in s.values()
               if torch.is_tensor(v) and v.is_floating_point() and v.dim()]
    assert moments and {t.dtype for t in moments} == {torch.float32}


def test_config_dtype_reaches_the_model(tmp_path):
    """--configs.model.dtype=bfloat16 builds the bf16 PVCNN through
    prepare, in training and in evaluation; a train run of the config on
    the CPU and its evaluator complete, with finite results."""
    root = str(tmp_path)
    tdata.write_synthetic(root, [(0, 96), (0, 130), (3, 110), (3, 70)])
    config = os.path.join(CONFIGS, "shapenet", "pvcnn", "c0p25.py")
    args = [config, "--devices", "cpu", "--configs.model.dtype=bfloat16",
            f"--configs.dataset.root={root}",
            "--configs.dataset.num_points=64",
            "--configs.model.width_multiplier=0.125",
            "--configs.train.batch_size=2", "--configs.train.num_epochs=1",
            f"--configs.train.save_path={tmp_path / 'run'}"]
    configs = prepare(args)
    assert configs.model.dtype == "bfloat16"
    assert configs.model().act_dtype == torch.bfloat16
    meters = run(configs)
    assert all(np.isfinite(v) for v in meters.values()), meters
    stats = evaluate_main(args + ["--configs.evaluate.num_votes=1"])
    assert np.isfinite(stats).all() and stats[:, 1].sum() > 0


@pytest.mark.parametrize("name", [
    "shapenet/pointnet.py", "s3dis/pointnet/area5.py",
    "kitti/frustum/pointnet.py", "kitti/frustum/pointnet2.py",
    "kitti/frustum/pvcnne.py"])
def test_other_models_refuse_bf16(name):
    """The models whose bf16 activations are not ported yet (the PointNets
    and the Frustum family; ShapeNet PVCNN, S3DIS PVCNN2 and PVCNN and
    ShapeNet PointNet++ SSG / MSG run bf16) raise NotImplementedError
    naming ROADMAP.md, rather than run fp32 quietly."""
    configs = prepare([os.path.join(CONFIGS, name), "--devices", "cpu",
                       "--configs.model.dtype=bfloat16"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        configs.model()


@pytest.mark.parametrize("knob,value", [
    ("PVCNN_TPU_CONV_ROWS", "0"), ("PVCNN_TPU_CONV_BN_FUSED", "0"),
    ("PVCNN_TPU_DENSE_BN_FUSED", "auto")])
def test_switches_refuse_bf16(monkeypatch, knob, value):
    """The switches' branches, which refused bf16 until their kernels' bf16
    modes were ported, run it now (the NDHWC branch, the unfused rows
    branch, the fused SharedMLP; tests/test_torch_bf16_optin_*.py hold
    them to JAX): ShapeNet PVCNN's train-mode logits under the switch are
    bf16 and no further from the fp32 model's under the same switch than
    twice the default bf16 path's distance from fp32 plus 1e-3 (this
    module's rule, rel-L2), and every parameter's gradient is float32 and
    finite."""
    x, y = (torch.from_numpy(a) for a in _inputs(3, b=2, n=1024))
    model = PVCNN(50, 16, 3, dtype="bfloat16", **SIZE).train()
    fp32 = PVCNN(50, 16, 3, **SIZE).train()
    fp32.load_state_dict(model.state_dict())
    for mod in (*model.modules(), *fp32.modules()):
        if isinstance(mod, Dropout):
            mod.p = 0.0
    with torch.no_grad():
        own = _rel(model(x).float().numpy(), fp32(x).numpy())
    monkeypatch.setenv(knob, value)
    logits = model(x)
    assert logits.dtype == torch.bfloat16
    got = _rel(logits.detach().float().numpy(), fp32(x).detach().numpy())
    assert got <= 2 * own + 1e-3, (got, own)
    CrossEntropyLoss()(logits, y).backward()
    grads = [p.grad for p in model.parameters()]
    assert {g.dtype for g in grads} == {torch.float32}
    assert all(torch.isfinite(g).all() for g in grads)
