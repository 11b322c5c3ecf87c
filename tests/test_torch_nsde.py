"""The port's MNIST Neural SDE (``NeuralSDE``, ``ClassifierNSDE``,
``mnist_nsde_optimizer``) against the JAX package's on JAX's own draws,
narrowed: 784 -> 16 pre-net, drift 16 -> 24 tanh -> 16, diffusion 16 -> 16,
10 classes, batch 8, rtol=atol=1.4e-1 (the experiment's), max_steps 32.

Each solve's draws are ``regneuralde_tpu.ops.pallas_sde.presample_noise(key,
...)`` of the key JAX's solve consumed, handed to the port as ``noise=``;
parameters go through ``convert.classifier_nsde_state_dict``. Both routes of
the port are held to JAX: ``fused=False`` (``ops.sde.sdeint`` over the
modules) and ``fused=True`` (on the CPU the plain versions of K9/K10).

Tolerances (float32): logits at 1e-5 relative; the same NFE, accepts and
success; the training loss at 1e-5 relative each step, the first step's
gradient within 2e-3 relative (Frobenius), the parameters after three
InvDecay(1e-5) -> Adam(0.01) steps within 2e-3 relative (Frobenius) of
JAX's, for ``stiff_est`` (SOSRI2, 0.1 * stiffness_estimate) and
``error_est`` (SOSRI, 10 * error_estimate).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.models import MLP as JMLP
from regneuralde_tpu.models import ClassifierNSDE as JClassifierNSDE
from regneuralde_tpu.models import NeuralSDE as JNeuralSDE
from regneuralde_tpu.ops import sri as jsri
from regneuralde_tpu.ops.pallas_sde import presample_noise as jax_presample_noise
from regneuralde_tpu.training import mnist_nsde_optimizer as jax_mnist_nsde_optimizer
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.convert import classifier_nsde_state_dict
from regneuralde_tpu_torch.models import MLP, ClassifierNSDE, NeuralSDE
from regneuralde_tpu_torch.ops import sde_whole_solve as sw
from regneuralde_tpu_torch.ops.sri import get_tableau, stability_size
from regneuralde_tpu_torch.training import (
    create_train_state,
    make_train_step,
    mnist_nsde_optimizer,
)

torch.set_num_threads(1)

BATCH, IN, LATENT, HIDDEN, CLASSES, MAX_STEPS = 8, 784, 16, 24, 10, 32
TOL = 1.4e-1
# regularizer: (solver, weight)
REGS = {"stiff_est": ("sosri2", 0.1), "error_est": ("sosri", 10.0)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(BATCH, IN)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, size=BATCH)]
    return x, y


def _jax_model(solver):
    nsde = JNeuralSDE(JMLP(features=(HIDDEN, LATENT)), JMLP(features=(LATENT,)),
                      tspan=(0.0, 1.0), solver=solver, rtol=TOL, atol=TOL, max_steps=MAX_STEPS)
    return JClassifierNSDE(fnn.Dense(LATENT), nsde, fnn.Dense(CLASSES))


def _torch_model(params, solver, fused):
    nsde = NeuralSDE(MLP(LATENT, (HIDDEN, LATENT), device="cpu"),
                     MLP(LATENT, (LATENT,), device="cpu"), tspan=(0.0, 1.0), solver=solver,
                     rtol=TOL, atol=TOL, max_steps=MAX_STEPS, fused=fused)
    clf = ClassifierNSDE(torch.nn.Linear(IN, LATENT), nsde, torch.nn.Linear(LATENT, CLASSES))
    clf.load_state_dict(classifier_nsde_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return clf


def _draws(key, rows):
    xi = jax_presample_noise(key, (rows, LATENT), jnp.float32, MAX_STEPS)
    return tuple(torch.from_numpy(np.array(a)) for a in xi)


@pytest.fixture(scope="module")
def jax_params():
    x, _ = _data()
    return _jax_model("sosri2").init(jax.random.PRNGKey(0), jnp.asarray(x))


def test_mlp_matches_flax():
    """``MLP((16,))``: one layer, no activation; ``MLP((24, 16))``: tanh
    between, linear out."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, LATENT)).astype(np.float32)
    for feats in ((LATENT,), (HIDDEN, LATENT)):
        jm = JMLP(features=feats)
        p = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
        m = MLP(LATENT, feats, device="cpu")
        m.load_state_dict({f"{name}.{k}": torch.from_numpy(np.array(
            np.asarray(v["kernel"]).T if k == "weight" else np.asarray(v["bias"])))
            for name, v in p["params"].items() for k in ("weight", "bias")})
        np.testing.assert_allclose(m(torch.from_numpy(x)).detach().numpy(),
                                   np.asarray(jm.apply(p, jnp.asarray(x))), rtol=2e-5, atol=5e-7)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("trajectories", [1, 3])
def test_classifier_matches_jax(jax_params, trajectories, fused):
    x, _ = _data()
    key = jax.random.PRNGKey(5)
    out = _jax_model("sosri2")(jax_params, jnp.asarray(x), key, trajectories=trajectories)
    clf = _torch_model(jax_params, "sosri2", fused)
    got = clf(torch.from_numpy(x), trajectories=trajectories,
              noise=_draws(key, trajectories * BATCH))
    assert got.logits.shape == (BATCH, CLASSES)
    assert _rel(got.logits.detach(), out.logits) <= 1e-5
    assert got.nfe1 == int(out.nfe1) and got.nfe2 == int(out.nfe2)
    assert got.success == bool(out.success)
    np.testing.assert_array_equal(got.telemetry.accepted.numpy(),
                                  np.asarray(out.telemetry.accepted))


_JAX_RUNS = {}


def _jax_train(params, reg_type, steps):
    """JAX's training steps (cached per regularizer: both of the port's
    routes are held to the same run)."""
    if reg_type not in _JAX_RUNS:
        _JAX_RUNS[reg_type] = _jax_train_run(params, reg_type, steps)
    return _JAX_RUNS[reg_type]


def _jax_train_run(params, reg_type, steps):
    solver, lam = REGS[reg_type]
    clf = _jax_model(solver)
    stab = jsri.stability_size(jsri.get_tableau(solver))
    reg_fn = ((lambda tel: jreg.stiffness_estimate(tel, stab, agg="mean"))
              if reg_type == "stiff_est" else (lambda tel: jreg.error_estimate(tel, agg="mean")))
    opt = jax_mnist_nsde_optimizer()
    x, y = _data()

    def loss_fn(p, sk):
        out = clf(p, jnp.asarray(x), sk, trajectories=1)
        return optax.softmax_cross_entropy(out.logits, jnp.asarray(y)).mean() + lam * reg_fn(
            out.telemetry)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    state = opt.init(params)
    key = jax.random.PRNGKey(13)
    losses, grads, keys = [], [], []
    for _ in range(steps):
        key, sk = jax.random.split(key)
        loss, g = grad_fn(params, sk)
        losses.append(float(loss))
        grads.append(g)
        keys.append(sk)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return losses, grads, keys, params


def _flat_sd(params):
    return {k: v.numpy() for k, v in classifier_nsde_state_dict(
        jax.tree_util.tree_map(np.asarray, params)).items()}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("reg_type", list(REGS))
def test_training_steps_match_jax(jax_params, reg_type, fused):
    solver, lam = REGS[reg_type]
    steps = 3
    losses, grads, keys, params_after = _jax_train(jax_params, reg_type, steps)
    clf = _torch_model(jax_params, solver, fused)
    stab = stability_size(get_tableau(solver))
    x, y = (torch.from_numpy(a) for a in _data())

    def loss_fn(model, noise):
        out = model(x, noise=noise)
        ce = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1).mean()
        r = (treg.stiffness_estimate(out.telemetry, stab, "mean") if reg_type == "stiff_est"
             else treg.error_estimate(out.telemetry, "mean"))
        return ce + lam * r, out

    optimizer = mnist_nsde_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(loss_fn, optimizer)
    names = [n for n, _ in clf.named_parameters()]
    for i in range(steps):
        noise = _draws(keys[i], BATCH)
        if i == 0:
            clf.zero_grad(set_to_none=True)
            loss, _ = loss_fn(clf, noise)
            loss.backward()
            want = _flat_sd(grads[0])
            got = np.concatenate([p.grad.numpy().ravel() for p in clf.parameters()])
            assert _rel(got, np.concatenate([want[n].ravel() for n in names])) <= 2e-3
        state, loss, out = step(state, noise)
        assert abs(loss.item() - losses[i]) <= 1e-5 * abs(losses[i])
        assert out.success
    want = _flat_sd(params_after)
    for n, p in clf.named_parameters():
        assert _rel(p.detach().numpy(), want[n]) <= 2e-3, n


def test_routing_and_refusals(monkeypatch):
    """``fused=True``/``"solve"`` in adjoint mode with the collapse bridge
    take the whole solve for an MLP pair; ``True`` takes ``sdeint`` for
    another pair (and in ``"while"`` mode), ``"solve"`` raises there; the
    option checks and per-sample stepping."""
    calls = []
    orig = sw.whole_solve_sdeint

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(sw, "whole_solve_sdeint", spy)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, LATENT, generator=gen)
    noise = tuple(torch.randn(MAX_STEPS, 6, LATENT, generator=gen) for _ in range(2))
    pair = lambda: (MLP(LATENT, (HIDDEN, LATENT), device="cpu",
                        generator=torch.Generator().manual_seed(1)),
                    MLP(LATENT, (LATENT,), device="cpu",
                        generator=torch.Generator().manual_seed(2)))
    kw = dict(rtol=TOL, atol=TOL, max_steps=MAX_STEPS)
    plain = NeuralSDE(*pair(), **kw)(x, noise=noise)
    for fused in (True, "solve"):
        calls.clear()
        out = NeuralSDE(*pair(), fused=fused, **kw)(x, noise=noise)
        assert calls and out.nfe1 == plain.nfe1 and out.nfe2 == plain.nfe2
        assert _rel(out.value.detach(), plain.value.detach()) <= 1e-5
    calls.clear()
    NeuralSDE(*pair(), fused=True, **kw)(x, noise=noise, mode="while")
    other = (torch.nn.Linear(LATENT, LATENT), MLP(LATENT, (LATENT,), device="cpu"))
    out = NeuralSDE(*other, fused=True, **kw)(x, noise=noise)
    assert not calls and out.value.shape == x.shape
    with pytest.raises(ValueError, match="solve"):
        NeuralSDE(*other, fused="solve", **kw)(x, noise=noise)
    with pytest.raises(ValueError, match="solve"):
        NeuralSDE(MLP(LATENT, (LATENT,), torch.sigmoid, device="cpu"),
                  MLP(LATENT, (LATENT,), device="cpu"), fused="solve", **kw)(x, noise=noise)
    with pytest.raises(ValueError, match="fused"):
        NeuralSDE(*pair(), fused="tiled")
    with pytest.raises(ValueError, match="per_sample"):
        NeuralSDE(*pair(), per_sample="lanes")
    with pytest.raises(ValueError, match="incompatible"):
        NeuralSDE(*pair(), fused=True, per_sample=True)
    for per_sample in (True, "batched"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            NeuralSDE(*pair(), per_sample=per_sample)
    with pytest.raises(ValueError, match="exactly one"):
        NeuralSDE(*pair(), fused=True, **kw)(x)


def test_fused_gradients_match_plain_route():
    """``fused=True`` (the plain K9/K10 here) against ``fused=False`` on the
    same draws, with saves: the value and the gradients of ``sum(v^2) + 0.1
    * stiffness_estimate + 10 * error_estimate`` within 1e-4 relative."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(6, LATENT, generator=gen)
    noise = tuple(torch.randn(64, 6, LATENT, generator=gen) for _ in range(2))
    res = []
    for fused in (False, True):
        m = NeuralSDE(MLP(LATENT, (HIDDEN, LATENT), device="cpu",
                          generator=torch.Generator().manual_seed(1)),
                      MLP(LATENT, (LATENT,), device="cpu",
                          generator=torch.Generator().manual_seed(2)),
                      solver="sosri2", rtol=1e-2, atol=1e-2, max_steps=64, fused=fused)
        out = m(x, noise=noise, saveat=torch.tensor([0.0, 0.5, 1.0]))
        loss = (out.value.square().sum() + 0.1 * treg.stiffness_estimate(out.telemetry, 11.0)
                + 10 * treg.error_estimate(out.telemetry))
        res.append((out, torch.autograd.grad(loss, list(m.parameters()))))
    (a, ga), (b, gb) = res
    assert a.nfe1 == b.nfe1 and a.solution.stats == b.solution.stats
    assert a.value.shape == (6, 3, LATENT)
    assert _rel(a.value.detach(), b.value.detach()) <= 1e-5
    for u, v in zip(ga, gb):
        assert _rel(u.numpy(), v.numpy()) <= 1e-4
