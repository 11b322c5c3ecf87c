"""The port's tuple Tsit5 step of MLPDynamics (``ops.fused_mlp``: K13/K14's
plain versions, ``StageSweepFn``, ``mlp_dynamics_stage_sweep``) against the
JAX package's (``regneuralde_tpu.ops.pallas_mlp``), and ``odeint`` with that
sweep against JAX's in its three modes.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
K13/K14 in interpret mode, ``_reference_sweep`` as the plain reference.
Both packages get the same numpy arrays from a seeded generator. The CUDA
kernels themselves run only on the card: see ``test_torch_kernels_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import ode as jode
from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import ode as tode

torch.set_num_threads(1)

NAMES = ["y_new", "k7", "err", "k6", "g6"]
GRAD_NAMES = ["t", "dt", "y", "k1", "W1", "b1", "W2", "b2"]


def _case(batch, dim, hidden, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(hidden, dim + 1)) / np.sqrt(dim + 1)),
        b1=f32(rng.normal(size=hidden) * 0.1),
        W2=f32(rng.normal(size=(dim, hidden + 1)) / np.sqrt(hidden + 1)),
        b2=f32(rng.normal(size=dim) * 0.1),
        y=f32(rng.normal(size=(batch, dim)) * 0.5),
        k1=f32(rng.normal(size=(batch, dim)) * 0.3),
        cts=[f32(rng.normal(size=(batch, dim))) for _ in range(5)],
    )


def _flax_params(c):
    """The same weights as a flax MLPDynamics tree: kernels (in, out)."""
    return {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}


def _leaves(c, dtype=torch.float32):
    return tuple(torch.tensor(c[k], dtype=dtype) for k in ("W1", "b1", "W2", "b2"))


def _flat_jax_grads(g):
    """(ct_t, ct_dt, ct_y, ct_k1, split parts) -> the port's layout."""
    ct_t, ct_dt, cy, ck1, (cw1x, cw1t, cb1, cw2h, cw2t, cb2) = g
    cw1 = np.concatenate([np.asarray(cw1x), np.asarray(cw1t)], 0).T
    cw2 = np.concatenate([np.asarray(cw2h), np.asarray(cw2t)], 0).T
    return [np.asarray(ct_t), np.asarray(ct_dt), np.asarray(cy), np.asarray(ck1),
            cw1, np.asarray(cb1).reshape(-1), cw2, np.asarray(cb2).reshape(-1)]


def _flat_torch_grads(g):
    ct_t, ct_dt, cy, ck1, leaves = g
    return [x.detach().numpy() for x in (ct_t, ct_dt, cy, ck1, *leaves)]


@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_sweep_matches_jax_stage_sweep(seed, dt):
    """K13's plain version, its CPU wrapper and the differentiable sweep
    against JAX's interpret-mode K13 at MLPDynamics(16, 12), batch 8, at
    the JAX package's own tolerance (tests/test_pallas_fused.py:33-43)."""
    c = _case(8, 16, 12, seed)
    want = jmlp.mlp_dynamics_stage_sweep(jnp.float32(0.1), jnp.float32(dt),
                                         jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
                                         _flax_params(c))
    t, dt_ = torch.tensor(0.1), torch.tensor(dt)
    y, k1 = torch.tensor(c["y"]), torch.tensor(c["k1"])
    fm.reset_launches()
    got = fm._reference_sweep(t, dt_, y, k1, fm._split_params(*_leaves(c)))
    for other in (fm.stage_sweep_fwd(t, dt_, y, k1, _leaves(c)),
                  fm.mlp_dynamics_stage_sweep(t, dt_, y, k1, _leaves(c)),
                  fm.plain_mlp_stage_sweep(t, dt_, y, k1, _leaves(c))):
        assert all(torch.equal(a, b) for a, b in zip(got, other))
    for a, b, name in zip(got, want, NAMES):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=1e-6,
                                   err_msg=name)
    assert fm.LAUNCHES == {k: 0 for k in fm.LAUNCHES}


@pytest.mark.parametrize("seed", [0, 1])
def test_bwd_math_matches_jax_vjp(seed):
    """K14's plain version against ``jax.vjp`` of JAX's ``_fused_step``
    (interpret-mode K14) and of its ``_reference_sweep`` on five random row
    cotangents, batch 6, dim 10, hidden 7 (tests/test_pallas_fused.py:
    78-103)."""
    c = _case(6, 10, 7, seed)
    parts = jmlp._split_params(_flax_params(c))
    t, dt = jnp.float32(0.2), jnp.float32(0.07)
    y, k1 = jnp.asarray(c["y"]), jnp.asarray(c["k1"])
    cts = tuple(jnp.asarray(x) for x in c["cts"])
    _, vjp_kern = jax.vjp(jmlp._fused_step, t, dt, y, k1, parts)
    _, vjp_ref = jax.vjp(jmlp._reference_sweep, t, dt, y, k1, parts)
    got = _flat_torch_grads(fm.stage_sweep_bwd(
        torch.tensor(0.2), torch.tensor(0.07), torch.tensor(c["y"]), torch.tensor(c["k1"]),
        _leaves(c), [torch.tensor(x) for x in c["cts"]]))
    for want in (vjp_kern(cts), vjp_ref(cts)):
        for a, b, name in zip(got, _flat_jax_grads(want), GRAD_NAMES):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-5, err_msg=name)


def _f64_inputs(c):
    f64 = torch.float64
    t = torch.tensor(0.2, dtype=f64, requires_grad=True)
    dt = torch.tensor(0.07, dtype=f64, requires_grad=True)
    y = torch.tensor(c["y"], dtype=f64, requires_grad=True)
    k1 = torch.tensor(c["k1"], dtype=f64, requires_grad=True)
    return t, dt, y, k1, [x.requires_grad_(True) for x in _leaves(c, f64)]


@pytest.mark.parametrize("shape", [(6, 10, 7), (5, 8, 4)])
def test_bwd_math_matches_autograd_float64(shape):
    """The hand chain equals autograd of K13's plain version in float64."""
    c = _case(*shape)
    t, dt, y, k1, leaves = _f64_inputs(c)
    out = fm._reference_sweep(t, dt, y, k1, fm._split_params(*leaves))
    cts = [torch.tensor(x, dtype=torch.float64) for x in c["cts"]]
    want = torch.autograd.grad(out, (t, dt, y, k1, *leaves), grad_outputs=cts)
    got = fm._bwd_math(t.detach(), dt.detach(), y.detach(), k1.detach(),
                       fm._split_params(*[x.detach() for x in leaves]), cts)
    for a, b, name in zip(_flat_torch_grads(got), want, GRAD_NAMES):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-10, atol=1e-10, err_msg=name)


def test_stage_sweep_fn_gradcheck():
    """``StageSweepFn`` (K14's plain version as the backward of K13's)
    passes ``torch.autograd.gradcheck`` in float64."""
    c = _case(3, 4, 3, 2)
    t, dt, y, k1, leaves = _f64_inputs(c)
    assert torch.autograd.gradcheck(fm.StageSweepFn.apply, (t, dt, y, k1, *leaves))


# ---------------------------------------------------------------------------
# Solves with the tuple sweep.
# ---------------------------------------------------------------------------

TOL = 1e-5
MAX_STEPS = 48


def _jax_f(t, y, p):
    return jmlp._mlp_k(y, t, *jmlp._split_params(p))


def _torch_f(t, y, leaves):
    return fm._mlp_k(y, t, fm._split_params(*leaves))[0]


@pytest.fixture(scope="module")
def jax_solves():
    """JAX's solves with its interpret-mode K13/K14 in each mode: the
    solution and, but for ``"while"``, the gradients of sum(y1^2) with
    respect to the weights and y0 (tests/test_pallas_fused.py:46-76)."""
    c = _case(8, 16, 12, 0)
    sweep = lambda t, dt, y, f0, p: jmlp.mlp_dynamics_stage_sweep(t, dt, y, f0, p)
    out = {}
    for mode in ("while", "adjoint", "scan"):
        def loss(p, y0, mode=mode):
            sol = jode.odeint(_jax_f, y0, 0.0, 1.0, p, rtol=TOL, atol=TOL,
                              max_steps=MAX_STEPS, mode=mode, stage_sweep=sweep)
            return jnp.sum(sol.y1 ** 2), sol

        args = (_flax_params(c), jnp.asarray(c["y"]))
        if mode == "while":
            out[mode] = (jax.jit(loss)(*args)[1], None)
            continue
        (_, sol), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(*args)
        gp = g[0]["params"]
        out[mode] = (sol, [np.asarray(gp["dense_1"]["kernel"]).T,
                           np.asarray(gp["dense_1"]["bias"]),
                           np.asarray(gp["dense_2"]["kernel"]).T,
                           np.asarray(gp["dense_2"]["bias"]), np.asarray(g[1])])
    return c, out


@pytest.mark.parametrize("mode", ["while", "adjoint", "scan"])
def test_odeint_with_tuple_sweep_matches_jax(jax_solves, mode):
    """``odeint(stage_sweep=mlp_dynamics_stage_sweep)`` against JAX's at
    rtol=atol=1e-5: the same NFE and accept sequence, y1 at rtol=1e-4 /
    atol=1e-6 and the gradients at rtol=5e-3 / atol=1e-5 (the JAX package's
    own bounds between its kernel and generic solves)."""
    c, out = jax_solves
    jsol, jgrads = out[mode]
    leaves = [x.requires_grad_(True) for x in _leaves(c)]
    y0 = torch.tensor(c["y"], requires_grad=True)
    sol = tode.odeint(_torch_f, y0, 0.0, 1.0, tuple(leaves), rtol=TOL, atol=TOL,
                      max_steps=MAX_STEPS, mode=mode, stage_sweep=fm.mlp_dynamics_stage_sweep)
    assert sol.stats.success and bool(jsol.stats.success)
    assert (sol.stats.nfe, sol.stats.naccept, sol.stats.nreject) == (
        int(jsol.stats.nfe), int(jsol.stats.naccept), int(jsol.stats.nreject))
    np.testing.assert_array_equal(sol.telemetry.accepted.numpy(),
                                  np.asarray(jsol.telemetry.accepted))
    np.testing.assert_allclose(sol.y1.detach().numpy(), np.asarray(jsol.y1), rtol=1e-4,
                               atol=1e-6)
    if jgrads is None:
        return
    grads = torch.autograd.grad(torch.sum(sol.y1 ** 2), [*leaves, y0])
    for name, a, b in zip(["W1", "b1", "W2", "b2", "y0"], grads, jgrads):
        np.testing.assert_allclose(a.numpy(), b, rtol=5e-3, atol=1e-5, err_msg=name)


def test_tuple_sweep_solve_takes_the_generic_solves_steps():
    """The same solve through K13's plain version and through ``odeint``'s
    generic sweep over the MLP: the same NFE and accepts, y1 within 1e-5,
    and the replay adjoint's gradients within 1e-4 (both float32; the two
    differ by the order of the lincombs' zero terms and by rounding)."""
    c = _case(8, 16, 12, 3)
    sols, grads = [], []
    for sweep in (fm.mlp_dynamics_stage_sweep, None):
        leaves = [x.requires_grad_(True) for x in _leaves(c)]
        sol = tode.odeint(_torch_f, torch.tensor(c["y"]), 0.0, 1.0, tuple(leaves), rtol=TOL,
                          atol=TOL, max_steps=MAX_STEPS, mode="adjoint", stage_sweep=sweep)
        sols.append(sol)
        grads.append(torch.autograd.grad(torch.sum(sol.y1 ** 2), leaves))
    (a, b), (ga, gb) = sols, grads
    assert a.stats == b.stats
    assert torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    np.testing.assert_allclose(a.y1.detach().numpy(), b.y1.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    for u, v in zip(ga, gb):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-4, atol=1e-6)
