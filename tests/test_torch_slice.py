"""The whole slice: the regularized MNIST Neural-ODE training step of the
port against the JAX package's, at a small width.

``ClassifierNODE(None, NeuralODE(MLPDynamics(16, 12), fused="step"),
Dense(10))`` at rtol=atol=1e-4, batch 8. The JAX parameters come from its
own ``init`` and reach the port through ``convert.py``; the JAX step runs
its interpret-mode kernels K1/K2 under ``jax.jit``. Loss: cross-entropy +
100 * error_estimate(mean); optimizer: InvDecay(1e-5) then Momentum(0.1,
0.9), as ``bench.py`` trains the flagship.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.models import ClassifierNODE as JClassifier
from regneuralde_tpu.models import MLPDynamics as JMLP
from regneuralde_tpu.models import NeuralODE as JNODE
from regneuralde_tpu.training import mnist_node_optimizer as j_optimizer
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.convert import classifier_node_state_dict
from regneuralde_tpu_torch.models import ClassifierNODE, MLPDynamics, NeuralODE
from regneuralde_tpu_torch.training import (
    create_train_state,
    make_train_step,
    mnist_node_optimizer,
)

torch.set_num_threads(1)

DIM, HIDDEN, BATCH, TOL, MAX_STEPS = 16, 12, 8, 1e-4, 48


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.uniform(0.0, 1.0, (BATCH, DIM)).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, BATCH)]
        out.append((x, y))
    return out


def _jax_model():
    node = JNODE(JMLP(dim=DIM, hidden=HIDDEN), rtol=TOL, atol=TOL,
                 max_steps=MAX_STEPS, fused="step")
    return JClassifier(None, node, fnn.Dense(10))


def _jax_loss(clf, reg_weight):
    def loss(params, x, y):
        out = clf(params, x)
        ce = optax.softmax_cross_entropy(out.logits, y).mean()
        return ce + reg_weight * jreg.error_estimate(out.telemetry, "mean"), out
    return loss


def _torch_loss(reg_weight):
    def loss(clf, x, y):
        out = clf(x)
        ce = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1).mean()
        return ce + reg_weight * treg.error_estimate(out.telemetry, "mean"), out
    return loss


def _torch_model(jparams):
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, device="cpu"), rtol=TOL, atol=TOL,
                     max_steps=MAX_STEPS, fused="step")
    clf = ClassifierNODE(None, node, torch.nn.Linear(DIM, 10))
    numpy_tree = jax.tree_util.tree_map(np.asarray, jparams)
    clf.load_state_dict(classifier_node_state_dict(numpy_tree))
    return clf


def _torch_grads_in_jax_layout(clf):
    g = {n: p.grad.numpy() for n, p in clf.named_parameters()}
    return [g["node.dynamics.dense_1.weight"].T, g["node.dynamics.dense_1.bias"],
            g["node.dynamics.dense_2.weight"].T, g["node.dynamics.dense_2.bias"],
            g["post.weight"].T, g["post.bias"]]


def _jax_flat(tree):
    d, p = tree["de"]["params"], tree["post"]["params"]
    return [np.asarray(a) for a in (
        d["dense_1"]["kernel"], d["dense_1"]["bias"], d["dense_2"]["kernel"],
        d["dense_2"]["bias"], p["kernel"], p["bias"])]


REG_WEIGHTS = [0.0, 100.0]


@pytest.fixture(scope="module")
def jax_runs():
    """JAX, for the cross-entropy alone and for the regularized loss: init,
    the first step's loss and gradients, and the parameters after three
    training steps on three batches."""
    clf = _jax_model()
    batches = _batches()
    x0 = jnp.asarray(batches[0][0])
    params = jax.jit(clf.init)(jax.random.PRNGKey(2), x0)
    runs = {}
    for w in REG_WEIGHTS:
        grad_fn = jax.jit(jax.value_and_grad(_jax_loss(clf, w), has_aux=True))
        (loss, out), grads = grad_fn(params, x0, jnp.asarray(batches[0][1]))
        run = dict(params=params, loss=float(loss), logits=np.asarray(out.logits),
                   nfe=int(out.nfe), accepted=np.asarray(out.telemetry.accepted),
                   grads=_jax_flat(grads))
        opt = j_optimizer()
        state = opt.init(params)
        p = params
        for x, y in batches:
            (_, _), g = grad_fn(p, jnp.asarray(x), jnp.asarray(y))
            updates, state = opt.update(g, state, p)
            p = optax.apply_updates(p, updates)
        run["params_after"] = _jax_flat(p)
        runs[w] = run
    return runs


NAMES = ["W1", "b1", "W2", "b2", "post_W", "post_b"]

# At rtol=atol=1e-4 this small model's embedded error estimate sits at its
# float32 rounding floor: ATen's and XLA's exp differ by an ulp in about one
# argument in ten, and error_estimate differs by about 1% between the two
# packages (2.728e-4 against 2.761e-4 here), while everything else agrees
# to about 1e-6. So the regularized loss and its gradients are held to
# bounds at that floor, and the cross-entropy alone to the JAX package's
# own tolerances.
NOISE_FLOOR = 5e-2


@pytest.mark.parametrize("reg_weight", REG_WEIGHTS)
def test_first_step_matches_jax(jax_runs, reg_weight):
    """Same logits, NFE and accept mask (rtol=1e-5). Cross-entropy: loss at
    rtol=1e-5, gradients at rtol=2e-3, atol=1e-5 (the JAX package's
    fast-adjoint tolerance, tests/test_pallas_fused.py:316-317).
    CE + 100 * error_estimate: loss at rtol=5e-4, each gradient leaf within
    NOISE_FLOOR relative (Frobenius)."""
    run = jax_runs[reg_weight]
    clf = _torch_model(run["params"])
    x, y = (torch.from_numpy(a) for a in _batches()[0])
    loss, out = _torch_loss(reg_weight)(clf, x, y)
    loss.backward()
    assert out.success
    assert out.nfe == run["nfe"]
    np.testing.assert_array_equal(out.telemetry.accepted.numpy(), run["accepted"])
    np.testing.assert_allclose(out.logits.detach().numpy(), run["logits"],
                               rtol=1e-5, atol=1e-6)
    grads = _torch_grads_in_jax_layout(clf)
    if reg_weight == 0.0:
        np.testing.assert_allclose(loss.item(), run["loss"], rtol=1e-5)
        for name, a, b in zip(NAMES, grads, run["grads"]):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(loss.item(), run["loss"], rtol=5e-4)
        for name, a, b in zip(NAMES, grads, run["grads"]):
            assert np.linalg.norm(a - b) <= NOISE_FLOOR * np.linalg.norm(b), name


@pytest.mark.parametrize("reg_weight", REG_WEIGHTS)
def test_three_training_steps_match_jax(jax_runs, reg_weight):
    """Three InvDecay+Momentum steps on three distinct batches. Cross-
    entropy: the same parameters at rtol=1e-4, atol=1e-6. Regularized: each
    leaf's distance to JAX's within NOISE_FLOOR of the distance it moved."""
    run = jax_runs[reg_weight]
    clf = _torch_model(run["params"])
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(_torch_loss(reg_weight), optimizer)
    for x, y in _batches():
        state, loss, out = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert out.success and torch.isfinite(loss)
    assert state.step == 3
    got = [p.detach().numpy() for p in clf.parameters()]
    # parameters() order: W1, b1, W2, b2, post W, post b (nn.Linear layout)
    got = [got[0].T, got[1], got[2].T, got[3], got[4].T, got[5]]
    start = _jax_flat(run["params"])
    for name, a, b, b0 in zip(NAMES, got, run["params_after"], start):
        if reg_weight == 0.0:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=name)
        else:
            assert np.linalg.norm(a - b) <= NOISE_FLOOR * np.linalg.norm(b - b0), name


def test_init_sizes_the_post_net_and_counts_no_launch():
    """``init`` runs the node in ``"while"`` mode to size a lazy post-net;
    on the CPU no kernel is launched."""
    from regneuralde_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(0)
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, generator=gen, device="cpu"), rtol=TOL,
                     atol=TOL, max_steps=MAX_STEPS, fused="step")
    clf = ClassifierNODE(None, node, torch.nn.LazyLinear(10))
    fm.reset_launches()
    clf.init(torch.from_numpy(_batches(1)[0][0]), generator=gen)
    assert clf.post.weight.shape == (10, DIM)
    out = clf(torch.from_numpy(_batches(1)[0][0]), mode="while")
    assert out.logits.shape == (BATCH, 10) and out.success
    assert out.nfe == 2 + 6 * int(out.telemetry.live.sum())
    assert fm.LAUNCHES == {k: 0 for k in fm.LAUNCHES} and len(fm.LAUNCHES) == 4


@pytest.mark.parametrize("agg", ["mean", "max", "sum"])
def test_regularizers_match_jax_on_the_same_telemetry(agg):
    """error_estimate and stiffness_estimate on identical telemetry streams,
    NaN entries and an empty mask included (rtol=1e-6)."""
    from regneuralde_tpu.ops.ode import StepTelemetry as JTel

    from regneuralde_tpu_torch.ops.ode import StepTelemetry as TTel

    rng = np.random.default_rng(0)
    n = 32
    cols = [rng.uniform(0, 1, n), rng.uniform(0, 0.1, n), rng.uniform(0, 2, n),
            rng.normal(0, 3, n)]
    cols = [c.astype(np.float32) for c in cols]
    cols[2][5] = np.nan
    for mask in (rng.uniform(size=n) < 0.6, np.zeros(n, bool)):
        live = mask | (rng.uniform(size=n) < 0.5)
        jt = JTel(*(jnp.asarray(c) for c in cols), jnp.asarray(mask), jnp.asarray(live))
        tt = TTel(*(torch.from_numpy(c) for c in cols), torch.from_numpy(mask),
                  torch.from_numpy(live))
        np.testing.assert_allclose(treg.error_estimate(tt, agg).numpy(),
                                   np.asarray(jreg.error_estimate(jt, agg)), rtol=1e-6)
        np.testing.assert_allclose(treg.stiffness_estimate(tt, 3.5068, agg).numpy(),
                                   np.asarray(jreg.stiffness_estimate(jt, 3.5068, agg)),
                                   rtol=1e-6)
    with pytest.raises(ValueError):
        treg.aggregate(torch.ones(3), torch.ones(3, dtype=torch.bool), "median")
