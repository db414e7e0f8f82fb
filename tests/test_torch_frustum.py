"""The port's KITTI Frustum family (FrustumPVCNNE, FrustumPointNet2,
FrustumPointNet) against the JAX package: the state_dict layout (the
reference's, so released checkpoints load), weights carried across by
state_dict_from_jax with checkpoint_import.frustum_mapping, the eval
forward, one-step gradients, a three-step trajectory against the JAX
Trainer with its sample stream; FrustumPointNetLoss, huber_loss and the
foreground sampler `logits_mask`; the recipes against the JAX configs.
The parity tests run here for FrustumPVCNNE and in
tests/test_torch_frustum_{pointnet2,pointnet}.py for the other two.

Model size: width 0.5 (PVCNNE's grids at voxel_resolution_multiplier 0.5:
R = 8 and 6), B = 4 synthetic frustums (data/kitti/frustum.py) of N = 128
points, M = 128 points an object (PointNet2's SA1 takes all 128 as
centers). B = 4 because the center-regression and box heads run
BatchNorm over the batch axis, and at B = 2 JAX's own fp32 gradients drift
far from its fp64 ones. Where outputs or gradients are compared across the
packages, both samplers are patched to the deterministic cyclic law of
tests/test_trajectory_parity.py (candidate p of k taken floor(M/k) + (p <
M mod k) times, in index order): their random streams differ. JAX is
jitted once per compiled function and model and runs its CPU
formulations; dropout is off on both sides in training.
"""

import copy
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pvcnn_tpu.ops.sampling as jsampling
from pvcnn_tpu.data.kitti import attributes as jattributes
from pvcnn_tpu.models.kitti import frustum as kf
from pvcnn_tpu.nn.frustum import FrustumPointNetLoss as JFrustumLoss
from pvcnn_tpu.ops import losses as jlosses
from pvcnn_tpu.utils import checkpoint_import as ci
from pvcnn_tpu_torch.data.kitti import attributes
from pvcnn_tpu_torch.data.kitti.frustum import synthetic_batch
from pvcnn_tpu_torch.models.kitti import frustum as tf
from pvcnn_tpu_torch.models.utils import Dropout
from pvcnn_tpu_torch.ops import losses as tlosses
from pvcnn_tpu_torch.ops import sampling as tsampling
from pvcnn_tpu_torch.train import optim as toptim
from pvcnn_tpu_torch.train.predict import predict
from pvcnn_tpu_torch.train.trainer import SAMPLE_SEED_OFFSET, Trainer
from pvcnn_tpu_torch.utils.weights import init_random_, state_dict_from_jax
from test_torch_pointnet2 import check_layout
from test_torch_train import _flat, no_dropout  # noqa: F401 (fixture)
from torch_twins import TwinFrustumNet

B, N, M, WIDTH, NH = 4, 128, 128, 0.5, 12
TEMPLATES = attributes.size_templates()
NS = len(TEMPLATES)
JTEMPLATES = tuple(map(tuple, TEMPLATES.tolist()))
SAMPLE = jax.random.PRNGKey(2)
RNGS = {"dropout": jax.random.PRNGKey(1), "sample": SAMPLE}


class Case(NamedTuple):
    """A Frustum model of the port and its JAX counterpart at test size."""

    jmodel: object
    port: object                    # () -> the port's module
    twin: object                    # () -> the reference twin
    variant: str                    # checkpoint_import.frustum_mapping's


def _case(variant, jfactory, tfactory, **extra):
    kw = dict(num_classes=3, num_heading_angle_bins=NH,
              num_size_templates=NS, num_points_per_object=M,
              width_multiplier=WIDTH)
    return Case(jfactory(size_templates=JTEMPLATES, **kw, **extra),
                lambda: tfactory(size_templates=TEMPLATES, **kw, **extra),
                lambda: TwinFrustumNet(variant, size_templates=TEMPLATES,
                                       **kw, **extra), variant)


CASES = {
    "pvcnne": _case("pvcnne", kf.FrustumPVCNNE, tf.FrustumPVCNNE,
                    voxel_resolution_multiplier=0.5),
    "pointnet2": _case("pointnet2", kf.FrustumPointNet2, tf.FrustumPointNet2),
    "pointnet": _case("pointnet", kf.FrustumPointNet, tf.FrustumPointNet),
}


def batch(seed, b=B, n=N):
    """A synthetic frustum batch (numpy dicts of inputs and targets)."""
    return synthetic_batch(np.random.RandomState(seed), b, n, NH)


def _jax_targets(targets):
    return {k: (v.astype(np.int32) if v.dtype == np.int64 else v)
            for k, v in targets.items()}


def _torch(tree, dtype=None):
    out = {k: torch.from_numpy(v) for k, v in tree.items()}
    if dtype is not None:
        out = {k: (v.to(dtype) if v.is_floating_point() else v)
               for k, v in out.items()}
    return out


def det_indices_jax(mask, m, rng):
    b, n = mask.shape
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    order = jnp.argsort(jnp.where(mask, idx, idx + n), axis=-1).astype(
        jnp.int32)
    count = jnp.maximum(jnp.sum(mask, -1), 1).astype(jnp.int32)
    j = jax.lax.broadcasted_iota(jnp.int32, (b, m), 1)
    return jnp.take_along_axis(order, j % count[:, None], axis=1)


def det_indices_torch(mask, m, generator=None):
    b, n = mask.shape
    idx = torch.arange(n)[None, :]
    order = torch.argsort(torch.where(mask, idx, idx + n), dim=-1)
    count = mask.sum(-1, keepdim=True).clamp(min=1)
    return torch.gather(order, 1, torch.arange(m)[None, :] % count).to(
        torch.int32)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this module: the parallel run's workers share
    the machine's cores, and the CPU kernels of six workers' full thread
    pools oversubscribe it (a 3-step trajectory took 83 s there, 3 s
    alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def deterministic_sampler(monkeypatch):
    """Both packages' logits_mask_indices on the deterministic law."""
    monkeypatch.setattr(jsampling, "logits_mask_indices", det_indices_jax)
    monkeypatch.setattr(tsampling, "logits_mask_indices", det_indices_torch)


def make_models(case: Case, seed: int = 1):
    """(flax variables, port model holding the same weights): the port
    draws them (init_random_, BatchNorm statistics included) and
    checkpoint_import moves them into the flax tree, whose shapes come from
    jax.eval_shape."""
    inputs, _ = batch(0)
    shapes = jax.eval_shape(lambda: case.jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": SAMPLE}, inputs,
        train=False))
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    port = init_random_(case.port(), seed)
    state = {k: t.numpy() for k, t in port.state_dict().items()}
    params, stats = ci.import_state_dict(
        state, zeros["params"], zeros["batch_stats"],
        ci.frustum_mapping(case.variant))
    return {"params": params, "batch_stats": stats}, port


def model_parity_setup(name):
    """(name, case, flax variables, port model, jitted JAX eval forward)
    for the parity tests below, which run here for FrustumPVCNNE and in
    tests/test_torch_frustum_{pointnet2,pointnet}.py for the others (one
    file a model: the parallel run spreads their JAX compiles)."""
    case = CASES[name]
    variables, port = make_models(case)
    forward = jax.jit(lambda v, x: case.jmodel.apply(
        v, x, train=False, rngs={"sample": SAMPLE}))
    return name, case, variables, port, forward


@pytest.fixture(scope="module")
def frustum():
    return model_parity_setup("pvcnne")


def test_attributes_are_the_jax_packages():
    assert attributes.class_names == jattributes.class_names
    np.testing.assert_array_equal(TEMPLATES, jattributes.size_templates())
    assert TEMPLATES.dtype == np.float32 and TEMPLATES.shape == (8, 3)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("small", [True, False])
def test_state_dict_is_the_reference_layout(name, small):
    """Keys and shapes equal TwinFrustumNet's (the size_templates buffer
    included), so a released `.pth.tar` loads as it is; at full size (the
    configs' models) every key but BatchNorm's step counters and the
    templates is named by frustum_mapping."""
    if small:
        check_layout(CASES[name].port(), CASES[name].twin())
        return
    port = tf.MODELS[name].build(1.0)
    twin = TwinFrustumNet(name, 3, NH, NS, 512, TEMPLATES)
    check_layout(port, twin)
    assert torch.equal(port.size_templates[0], torch.from_numpy(TEMPLATES))
    named = set()
    for prefix, _, kind in ci.frustum_mapping(name):
        leaves = (("weight", "bias", "running_mean", "running_var")
                  if kind == "bn" else ("weight", "bias"))
        named |= {f"{prefix}.{leaf}" for leaf in leaves}
    keys = {k for k in port.state_dict()
            if "num_batches_tracked" not in k and k != "size_templates"}
    assert keys == named


def test_weights_from_jax_round_trip(frustum):
    """JAX variables -> state_dict_from_jax -> the port's state_dict, the
    exact tensors the flax tree was built from."""
    _, case, variables, port, _ = frustum
    fresh = case.port()
    fresh.load_state_dict(state_dict_from_jax(
        variables["params"], variables["batch_stats"],
        ci.frustum_mapping(case.variant), fresh.state_dict()))
    want = port.state_dict()
    for k, t in fresh.state_dict().items():
        if "num_batches_tracked" not in k:
            assert torch.equal(t, want[k]), k


def _compare_outputs(got, want, tol):
    """Every output key of the port's dict against JAX's at rtol = tol,
    atol = tol x the largest |entry| of that key (at least tol)."""
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].detach().numpy()
        assert g.shape == w.shape, key
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * max(1.0, np.abs(w).max()),
                                   err_msg=key)


@pytest.mark.parametrize("seed", [2, 3])
def test_eval_forward_matches_jax(frustum, deterministic_sampler, seed):
    """Every output of the eval forward at rtol 1e-4 (atol 1e-4 of each
    output's largest entry), the foreground masks equal."""
    _, case, variables, port, forward = frustum
    inputs, _ = batch(seed)
    with jax.default_matmul_precision("float32"):
        want = jax.tree.map(np.asarray, forward(variables, inputs))
    port.eval()
    with torch.no_grad():
        got = port(_torch(inputs))
    np.testing.assert_array_equal(
        got["mask_logits"].numpy().argmax(-1),
        want["mask_logits"].argmax(-1))
    _compare_outputs(got, want, 1e-4)


def _port_train(port):
    for mod in port.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    return port.train()


# the trajectory's SGD step, exact in fp32 and fp64: JAX's step-1 gradient
# is (p0 - p1) / LR
LR = 2.0 ** -12
TRAJECTORY = [batch(10 + i) for i in range(3)]


@pytest.fixture(scope="module")
def jax_sgd(frustum):
    """The JAX Trainer (has_sample_rng=True, SGD at LR, fp64, dropout off,
    the deterministic sampler) over the three TRAJECTORY batches, once per
    model -> (its losses, its step-1 gradients flattened in the flax tree's
    order). One JAX compile serves both tests below: fp64 throughout,
    because JAX's fp32 is a poor reference for FrustumPointNet2 (its
    BatchNorm takes the variance as E[y^2] - E[y]^2, which cancels where
    the first layer's bias dwarfs its input: the box head's SA1 groups
    coordinates within 0.2 of their center)."""
    import flax.linen as fnn

    from pvcnn_tpu.parallel import mesh as pmesh
    from pvcnn_tpu.train.optim import SGD
    from pvcnn_tpu.train.trainer import Trainer as JTrainer
    from pvcnn_tpu.train.trainer import TrainState

    _, case, variables, _, _ = frustum
    cast = lambda t: jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64) if a.dtype.kind == "f" else a,
        t)
    losses = []
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True), \
            jax.default_matmul_precision("highest"):
        mp.setattr(jsampling, "logits_mask_indices", det_indices_jax)
        mp.setattr(fnn.Dropout, "__call__",
                   lambda self, x, deterministic=None, rng=None: x)
        tx, _ = SGD(LR)
        jtrainer = JTrainer(case.jmodel, JFrustumLoss(NH, NS, TEMPLATES), tx,
                            mesh=pmesh.make_mesh(1), has_sample_rng=True)
        params = cast(variables["params"])
        before = _flat(params)
        # the running statistics stay fp32, as the step returns them (an
        # fp64 copy would recompile the step once)
        state = jax.device_put(
            TrainState(params=params, batch_stats=variables["batch_stats"],
                       opt_state=tx.init(params)),
            pmesh.replicated(jtrainer.mesh))
        for inputs, targets in TRAJECTORY:
            data = pmesh.shard_batch(
                (cast(inputs), cast(_jax_targets(targets))), jtrainer.mesh)
            state, loss = jtrainer._train_step(state, data,
                                               jax.random.PRNGKey(0))
            losses.append(float(loss))
            if len(losses) == 1:
                grads = (before - _flat(state.params)) / LR
    return losses, grads


def _port_loss_and_grads(case, port, variables):
    inputs, targets = TRAJECTORY[0]
    dtype = next(port.parameters()).dtype
    port.zero_grad(set_to_none=True)
    loss = tf.criterion()(port(_torch(inputs, dtype)), _torch(targets, dtype))
    loss.backward()
    named = dict(port.named_parameters())
    grads = {k: (named[k].grad if k in named else torch.zeros_like(t))
             .numpy() for k, t in port.state_dict().items()}
    tree, _ = ci.import_state_dict(grads, variables["params"],
                                   variables["batch_stats"],
                                   ci.frustum_mapping(case.variant))
    return loss.item(), _flat(tree)


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_one_step_gradients_match_jax(frustum, jax_sgd,
                                      deterministic_sampler, no_dropout):
    """Train-mode FrustumPointNetLoss and every parameter gradient against
    the JAX Trainer's first step in fp64 (jax_sgd): the port in fp64 (its
    plain versions run in fp64 on the CPU) at loss rtol 1e-9 and rel-L2 <
    1e-6 (measured 7.5e-16 / 2.6e-8 PVCNNE, 8.6e-12 / 2.5e-8 PointNet2,
    1.5e-15 / 2.6e-8 PointNet), and in fp32 at loss rtol 1e-5 and rel-L2
    < 5e-2, the bound of tests/test_torch_pointnet2.py (measured 2.4e-8 /
    2.2e-5 and 9.2e-8 / 1.1e-5). PointNet2's fp32 gradients are held to
    nothing: the BatchNorms over the box head's small relative coordinates
    leave fp32 few digits there (the port's fp32 gradients sit near the
    5e-2 bound from fp64); its fp64 gradients hold the function."""
    name, case, variables, _, _ = frustum
    losses, want = jax_sgd
    port = _port_train(init_random_(case.port(), 1))
    port64 = copy.deepcopy(port).double()
    loss_t64, got64 = _port_loss_and_grads(case, port64, variables)
    assert np.isclose(loss_t64, losses[0], rtol=1e-9, atol=0), \
        (loss_t64, losses[0])
    assert _rel_l2(got64, want) < 1e-6, _rel_l2(got64, want)
    if name == "pointnet2":
        return
    loss_t, got = _port_loss_and_grads(case, port, variables)
    assert np.isclose(loss_t, losses[0], rtol=1e-5, atol=0), \
        (loss_t, losses[0])
    assert _rel_l2(got, want) < 5e-2, _rel_l2(got, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_three_step_trajectory_matches_jax_trainer(frustum, jax_sgd,
                                                   deterministic_sampler,
                                                   no_dropout, dtype):
    """Three SGD steps of the port's Trainer (its public train_step, dict
    batches) against the JAX Trainer's with has_sample_rng=True in fp64
    (jax_sgd): the port in fp64 within 1e-6 at every step (measured at
    most 7.2e-9), in fp32 step 1 within 1e-3 and steps 2-3 within 3e-2
    (the band of tests/test_torch_train.py; measured under 5e-5).
    FrustumPointNet2 in fp32: finite losses, step 1 within 1e-2; its fp32
    trajectory is held to no band, because fp32 keeps few digits through
    its BatchNorms over small relative coordinates: with 8 torch threads
    it measured 1.4e-4 / 1.6e-2 (steps 1 / 3) from fp64, with 2 threads
    7.5e-4 / 8.4e-2."""
    name, case, _, _, _ = frustum
    losses_j, _ = jax_sgd
    dt = getattr(torch, dtype)
    port = _port_train(init_random_(case.port(), 1)).to(dt)
    trainer = Trainer(port, tf.criterion(),
                      torch.optim.SGD(port.parameters(), lr=LR), "cpu",
                      seed=0)
    losses_t = [float(trainer.train_step(_torch(x, dt), _torch(y, dt)))
                for x, y in TRAJECTORY]
    rel = np.abs(np.subtract(losses_t, losses_j)) / np.abs(losses_j)
    if dtype == "float64":
        assert rel.max() < 1e-6, (losses_t, losses_j)
    elif name == "pointnet2":
        assert np.isfinite(losses_t).all() and rel[0] < 1e-2, \
            (losses_t, losses_j)
    else:
        assert rel[0] < 1e-3 and rel.max() < 3e-2, (losses_t, losses_j)


def _loss_inputs(rng, b, flip):
    """Random model outputs and synthetic targets for the loss; with flip,
    the predicted heading sits near the target's + pi, where the flipped
    target corners are the nearer."""
    _, targets = synthetic_batch(rng, b, 64, NH)
    out = {"mask_logits": rng.randn(b, 64, 2),
           "center_reg": targets["center"] + rng.randn(b, 3),
           "center": targets["center"] + rng.randn(b, 3) * 2.0,
           "heading_scores": rng.randn(b, NH),
           "heading_residuals_normalized": rng.randn(b, NH) * 0.3,
           "size_scores": rng.randn(b, NS),
           "size_residuals_normalized": rng.randn(b, NS, 3) * 0.1}
    if flip:
        # the predicted heading bin's residual turns the box by pi
        rows = np.arange(b)
        out["heading_residuals_normalized"][rows, targets["heading_bin_id"]] \
            = (targets["heading_residual"] + np.pi) / (np.pi / NH)
        out["center"] = targets["center"] + rng.randn(b, 3) * 0.05
    out["heading_residuals"] = out["heading_residuals_normalized"] * (
        np.pi / NH)
    out["size_residuals"] = out["size_residuals_normalized"] * TEMPLATES
    return ({k: v.astype(np.float32) for k, v in out.items()}, targets)


@pytest.mark.parametrize("flip", [False, True])
def test_frustum_loss_matches_jax(flip):
    """FrustumPointNetLoss against JAX's: in fp64 on both sides its value
    (rtol 1e-12) and its gradient in every model output (rtol 1e-7, atol
    1e-12 of the output's largest); in fp32 its value (rtol 1e-5). With
    flip, the flipped target corners are the nearer for every box (the
    corner term's min picks them); without, not for every box. The fp32
    gradients are not compared: the corner distances subtract corners some
    30 m out, so near a match fp32 keeps few digits of them (fp64 keeps
    some 9: hence rtol 1e-7)."""
    from pvcnn_tpu.nn.frustum import get_box_corners_3d as jcorners

    out, targets = _loss_inputs(np.random.RandomState(4 + flip), 8, flip)
    jloss = JFrustumLoss(NH, NS, TEMPLATES)
    loss_fn = lambda o, t: jloss(o, t)
    want32 = float(jax.jit(loss_fn)(out, _jax_targets(targets)))
    np.testing.assert_allclose(tf.criterion()(_torch(out), _torch(targets))
                               .item(), want32, rtol=1e-5)
    out64 = {k: v.astype(np.float64) for k, v in out.items()}
    t64 = {k: (v.astype(np.float64) if v.dtype.kind == "f" else v)
           for k, v in targets.items()}
    with jax.enable_x64(True):
        want, want_g = jax.jit(jax.value_and_grad(loss_fn))(
            out64, _jax_targets(t64))
        want, want_g = float(want), jax.tree.map(np.asarray, want_g)
    got_in = {k: torch.from_numpy(v).requires_grad_()
              for k, v in out64.items()}
    got = tf.criterion()(got_in, _torch(t64))
    got.backward()
    np.testing.assert_allclose(got.item(), want, rtol=1e-12)
    for k, v in got_in.items():
        w = want_g[k]
        np.testing.assert_allclose(v.grad.numpy(), w, rtol=1e-7,
                                   atol=1e-12 * np.abs(w).max(), err_msg=k)
    # the corners the loss compares, and which of the two is the nearer
    rows = np.arange(8)
    bins = np.arange(0, 2 * np.pi, 2 * np.pi / NH, dtype=np.float32)
    hid, sid = targets["heading_bin_id"], targets["size_template_id"]
    heading = out["heading_residuals"][rows, hid] + bins[hid]
    size = out["size_residuals"][rows, sid] + TEMPLATES[sid]
    box = np.asarray(jcorners(out["center"], heading, size))
    tgt, tgt_flip = (np.asarray(a) for a in jcorners(
        targets["center"], bins[hid] + targets["heading_residual"],
        TEMPLATES[sid] + targets["size_residual"], with_flip=True))
    near_flip = (np.linalg.norm(box - tgt_flip, axis=1)
                 < np.linalg.norm(box - tgt, axis=1))
    assert near_flip.all() if flip else not near_flip.all()


@pytest.mark.parametrize("delta", [1.0, 2.0])
def test_huber_loss_matches_jax(delta):
    """huber_loss's value and gradient against JAX's at fp32 (rtol 1e-6),
    on errors on both sides of the knee."""
    err = np.random.RandomState(int(delta)).randn(64).astype(np.float32) * 3
    assert (np.abs(err) < delta).any() and (np.abs(err) > delta).any()
    want, want_g = jax.value_and_grad(
        lambda e: jlosses.huber_loss(e, delta))(err)
    e = torch.from_numpy(err).requires_grad_()
    got = tlosses.huber_loss(e, delta)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-9)


def _masks(rng, n, counts):
    mask = np.zeros((len(counts), n), bool)
    for i, k in enumerate(counts):
        mask[i, rng.choice(n, k, replace=False)] = True
    return mask


@pytest.mark.parametrize("counts", [(40, 64, 33), (5, 1, 31), (0, 0, 7)],
                         ids=["count>=M", "0<count<M", "count=0"])
def test_logits_mask_matches_jax_on_the_same_draws(monkeypatch, counts):
    """Fed the same uniform draws, logits_mask_indices selects exactly
    JAX's indices, and logits_mask's selected coords, mean and mask equal
    JAX's (atol 1e-6), with count >= M (M = 32), 0 < count < M and count
    = 0."""
    rng = np.random.RandomState(sum(counts))
    n, m = 64, 32
    mask = _masks(rng, n, counts)
    logits = rng.randn(len(counts), n, 2).astype(np.float32)
    logits[..., 1] = np.where(mask, logits[..., 0] + 0.5,
                              logits[..., 0] - 0.5)
    coords = rng.randn(len(counts), n, 3).astype(np.float32)
    u = rng.rand(len(counts), n).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: u)
    want = jsampling.logits_mask(jnp.asarray(coords), jnp.asarray(logits), m,
                                 jax.random.PRNGKey(0))
    want_idx = jsampling.logits_mask_indices(jnp.asarray(mask), m, None)
    rand = torch.rand
    monkeypatch.setattr(torch, "rand", lambda shape, generator=None,
                        device=None: torch.from_numpy(u))
    got_idx = tsampling.logits_mask_indices(torch.from_numpy(mask), m)
    got = tsampling.logits_mask(torch.from_numpy(coords),
                                torch.from_numpy(logits), m)
    monkeypatch.setattr(torch, "rand", rand)
    assert got_idx.dtype == torch.int32
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    empty = mask.sum(-1) == 0
    assert not got[0][empty].abs().sum() and not got[1][empty].abs().sum()


class TestLogitsMaskDistribution:
    """The port's sampler under its own torch.Generator against the
    reference host sampler in distribution, as tests/test_ops.py:
    TestLogitsMaskDistribution holds JAX's: each draw's counts in
    {floor(M/k), floor(M/k) + 1} summing to M, no non-candidate drawn,
    total-variation distance of the marginals < 0.03, every marginal
    within 10% of M/k (4,000 draws)."""

    N = 32

    def _ours(self, mask, m, draws):
        gen = torch.Generator().manual_seed(42)
        sel = tsampling.logits_mask_indices(
            torch.from_numpy(np.broadcast_to(mask, (draws, self.N)).copy()),
            m, gen).long().numpy()
        counts = np.zeros((draws, self.N), np.int64)
        np.add.at(counts, (np.arange(draws)[:, None], sel), 1)
        return counts

    def _reference(self, cand, m, rs):
        counts = np.zeros(self.N, np.int64)
        k = len(cand)
        if k >= m:
            sel = cand[rs.choice(k, m, replace=False)]
        else:
            sel = cand[np.concatenate([np.arange(k).repeat(m // k),
                                       rs.choice(k, m % k, replace=False)])]
        np.add.at(counts, sel, 1)
        return counts

    @pytest.mark.parametrize("k,m", [(24, 8), (5, 8)],
                             ids=["count>=M", "0<count<M"])
    def test_regime(self, k, m, draws=4000):
        rng = np.random.RandomState(k)
        cand = np.sort(rng.choice(self.N, k, replace=False))
        mask = np.zeros(self.N, bool)
        mask[cand] = True
        ours = self._ours(mask, m, draws)
        rs = np.random.RandomState(7)
        ref = np.stack([self._reference(cand, m, rs) for _ in range(draws)])
        assert ours[:, ~mask].sum() == 0
        for counts in (ours, ref):
            assert set(np.unique(counts[:, mask])) <= {m // k, m // k + 1}
            np.testing.assert_array_equal(counts[:, mask].sum(-1), m)
        p, q = ours[:, mask].mean(0) / m, ref[:, mask].mean(0) / m
        assert 0.5 * np.abs(p - q).sum() < 0.03
        np.testing.assert_allclose(ours[:, mask].mean(0), m / k, rtol=0.1)


def test_trainer_owns_the_sample_generator():
    """The Trainer gives the model's sampler a generator of its own, apart
    from dropout's: the sampler draws in evaluation too (predict) and not
    from the dropout generator, and re-seeding it replays the draw. M = 16
    points an object here, fewer than the candidates, so the draw shows
    in the outputs."""
    port = init_random_(CASES["pointnet"].port(), 1)
    port.num_points_per_object = 16
    trainer = Trainer(port, tf.criterion(), toptim.Adam(port.parameters()),
                      "cpu", seed=0)
    assert port.sample_generator is trainer.sample_generator
    assert trainer.sample_generator is not trainer.generator
    dropout_state = trainer.generator.get_state()
    x = trainer._to_device(batch(6)[0])
    assert set(x) == {"features", "one_hot_vectors"}
    first = predict(port, x)
    again = predict(port, x)
    trainer.sample_generator.manual_seed(SAMPLE_SEED_OFFSET)
    replay = predict(port, x)
    assert torch.equal(trainer.generator.get_state(), dropout_state)
    assert torch.equal(first["center"], replay["center"])
    assert not torch.equal(first["center"], again["center"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_recipes_match_jax_configs(monkeypatch, name):
    """Each MODELS entry restates its JAX config: the model's class, batch
    size, points, points an object, heading bins, size templates, the
    loss's weights, the epochs and the schedule of the learning rate."""
    import os

    from pvcnn_tpu.utils.config import configs

    monkeypatch.chdir(os.path.dirname(os.path.dirname(__file__)))
    saved = dict(configs)
    configs.clear()
    try:
        configs.update_from_file(f"configs/kitti/frustum/{name}.py")
        jname = configs.model.func.__name__
        model_kw = {k: configs.model[k] for k in (
            "num_classes", "num_heading_angle_bins", "num_size_templates",
            "num_points_per_object", "extra_feature_channels")}
        loss_kw = {k: configs.train.criterion[k] for k in (
            "box_loss_weight", "corners_loss_weight",
            "heading_residual_loss_weight", "size_residual_loss_weight")}
        want = (configs.train.batch_size, configs.dataset.num_points,
                configs.train.num_epochs, configs.train.optimizer.lr,
                tuple(configs.data.classes))
        epochs, lr = configs.train.num_epochs, configs.train.optimizer.lr
        jsched = configs.train.scheduler().bind(lr)
    finally:
        configs.clear()
        configs.update(saved)
    spec = tf.MODELS[name]
    model = spec.build(0.125)
    assert type(model).__name__ == "FrustumNet"
    assert getattr(tf, jname).__name__ == jname
    assert (spec.batch_size, tf.NUM_POINTS, tf.EPOCHS, tf.LR,
            tf.CLASSES) == want
    assert model_kw == {"num_classes": len(tf.CLASSES),
                        "num_heading_angle_bins": model.num_heading_angle_bins,
                        "num_size_templates": model.num_size_templates,
                        "num_points_per_object": model.num_points_per_object,
                        "extra_feature_channels": tf.EXTRA_FEATURE_CHANNELS}
    loss = tf.criterion()
    assert loss_kw == {k: getattr(loss, k) for k in loss_kw}
    mine = spec.scheduler(epochs).bind(lr)
    assert [mine(e) for e in range(epochs)] == \
        [jsched(e) for e in range(epochs)]


def test_synthetic_batch_is_a_frustum():
    """The synthetic batch in the dataset's layout: the mask targets mark
    30-60% of the points, all inside the target box (the box's own rotation
    undone), the rest beyond it in depth or off it; the heading's bin and
    residual are the JAX dataset's angle_to_bin_id's; the size residual
    within 10% of its template."""
    from pvcnn_tpu.data.kitti.frustum import _FrustumKittiDataset
    from pvcnn_tpu_torch.data.kitti.frustum import angle_to_bin_id

    inputs, targets = batch(7, b=6, n=256)
    assert inputs["features"].shape == (6, 256, 4)
    assert inputs["one_hot_vectors"].sum(-1).tolist() == [1.0] * 6
    frac = targets["mask_logits"].mean(-1)
    assert ((frac >= 0.29) & (frac <= 0.61)).all()
    for angle in np.random.RandomState(0).uniform(-7, 7, 50):
        got, want = angle_to_bin_id(angle, NH), \
            _FrustumKittiDataset.angle_to_bin_id(angle, NH)
        assert got[0] == want[0] and np.isclose(got[1], want[1])
    bins = 2 * np.pi / NH * targets["heading_bin_id"]
    heading = bins + targets["heading_residual"]
    sid = targets["size_template_id"]
    size = TEMPLATES[sid] + targets["size_residual"]
    assert (np.abs(targets["size_residual"]) <= 0.1 * TEMPLATES[sid]
            + 1e-6).all()
    for i in range(6):
        fg = inputs["features"][i, targets["mask_logits"][i] == 1, :3]
        d = fg - targets["center"][i]
        c, s = np.cos(heading[i]), np.sin(heading[i])
        local = np.stack([c * d[:, 0] - s * d[:, 2], d[:, 1],
                          s * d[:, 0] + c * d[:, 2]], -1)
        assert (np.abs(local) <= 0.5 * size[i][[0, 2, 1]] + 1e-4).all()


def test_trainer_epoch_and_evaluate_on_dict_batches():
    """Trainer.train_epoch and Trainer.evaluate through the DataLoader over
    Frustum items (dicts of arrays): the loader stacks each key, the
    losses are finite, and each meter sees every batch's output dict as
    numpy."""
    from pvcnn_tpu_torch.data.loader import DataLoader

    inputs, targets = batch(8, b=6)
    items = [({k: v[i] for k, v in inputs.items()},
              {k: v[i] for k, v in targets.items()}) for i in range(6)]
    port = init_random_(CASES["pointnet"].port(), 1)
    trainer = Trainer(port, tf.criterion(), toptim.Adam(port.parameters()),
                      "cpu", seed=0)
    loss = trainer.train_epoch(DataLoader(items, 4, shuffle=True), 0,
                               tf.MODELS["pointnet"].scheduler(tf.EPOCHS)
                               .bind(tf.LR))
    assert np.isfinite(loss)

    class Keys:
        seen = []

        def update(self, outputs, targets):
            assert isinstance(outputs["center"], np.ndarray)
            self.seen.append((len(outputs["center"]),
                              targets["mask_logits"].shape))

        def compute(self):
            return float(len(self.seen))

    assert trainer.evaluate(DataLoader(items, 4), {"n": Keys()}) == \
        {"n": 2.0}
    assert Keys.seen == [(4, (4, N)), (2, (2, N))]
