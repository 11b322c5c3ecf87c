"""The port's solver core (regneuralde_tpu_torch.ops) against the JAX
package's (regneuralde_tpu.ops): controller, initial step, norm scalars,
the golden Tsit5 traces, and the fast adjoint solve.

Both packages get the same numpy arrays from a seeded generator. The JAX
solves use the normed MLP trial step as its own tests run it on the CPU:
the Pallas kernels K1/K2 in interpret mode (``mlp_dynamics_normed_sweep``
and ``mlp_dynamics_normed_sweep_bwd``), under ``jax.jit``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import controller as jctrl
from regneuralde_tpu.ops import ode as jode
from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import controller as tctrl
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import ode as tode

torch.set_num_threads(1)

GOLDEN = json.loads(
    (Path(__file__).parent / "golden" / "tsit5_traces.json").read_text())


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("qsteady_max", [1.0, 1.2])
@pytest.mark.parametrize("seed", [0, 1])
def test_controller_propose_matches_jax(seed, qsteady_max):
    rng = np.random.default_rng(seed)
    n = 512
    dt = rng.uniform(1e-4, 0.5, n).astype(np.float32)
    # spans the floor, the deadband, accepts and rejects
    eest = np.exp(rng.uniform(np.log(1e-12), np.log(50.0), n)).astype(np.float32)
    qold = np.exp(rng.uniform(np.log(1e-4), 0.0, n)).astype(np.float32)
    accept = eest <= 1.0
    kw = dict(beta1=7 / 50, beta2=2 / 25, qsteady_max=qsteady_max)
    want = jctrl.PIController(**kw).propose(
        jnp.asarray(dt), jnp.asarray(eest), jnp.asarray(qold), jnp.asarray(accept))
    got = tctrl.PIController(**kw).propose(_t(dt), _t(eest), _t(qold),
                                           _t(accept, torch.bool))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_controller_for_order_matches_jax():
    j, t = jctrl.PIController.for_order(5), tctrl.PIController.for_order(5)
    assert (t.beta1, t.beta2, t.qmin, t.qmax, t.gamma, t.qoldinit, t.qsteady_max) == (
        j.beta1, j.beta2, j.qmin, j.qmax, j.gamma, j.qoldinit, j.qsteady_max)


def _mlp_arrays(batch, dim, hidden, seed):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(hidden, dim + 1)) / np.sqrt(dim + 1)),
        b1=f32(rng.normal(size=hidden) * 0.1),
        W2=f32(rng.normal(size=(dim, hidden + 1)) / np.sqrt(hidden + 1)),
        b2=f32(rng.normal(size=dim) * 0.1),
        y0=f32(rng.normal(size=(batch, dim)) * 0.5),
    )


def _jax_params(c):
    return {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}


def _jax_f(t, y, p):
    return jmlp._mlp_k(y, t, *jmlp._split_params(p))


def _torch_f(t, y, leaves):
    return fm._mlp_k(y, t, fm._split_params(*leaves))[0]


@pytest.mark.parametrize("t1", [1.0, -0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_initial_step_size_matches_jax(seed, t1):
    c = _mlp_arrays(6, 8, 5, seed)
    p = _jax_params(c)
    leaves = tuple(_t(c[k]) for k in ("W1", "b1", "W2", "b2"))
    y0 = c["y0"]
    f0_j = _jax_f(jnp.float32(0.0), jnp.asarray(y0), p)
    want = jctrl.initial_step_size(_jax_f, jnp.float32(0.0), jnp.asarray(y0), f0_j,
                                   p, 5, 1e-5, 1e-5, jnp.float32(t1))
    f0_t = _torch_f(torch.tensor(0.0), _t(y0), leaves)
    got = tctrl.initial_step_size(_torch_f, torch.tensor(0.0), _t(y0), f0_t,
                                  leaves, 5, 1e-5, 1e-5, torch.tensor(t1))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-5,
                               atol=5e-7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_normed_scalars_match_jax(seed):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0.0, 10.0, (3, 64)).astype(np.float32)
    vals[:, :8] = 0.0  # the zero guards
    vals[1, 8:16] = 0.0
    vals[2, 16:24] = 0.0
    for e, n, d in zip(*vals):
        want = jode._normed_scalars(jnp.float32(e), jnp.float32(n), jnp.float32(d),
                                    jnp.float32(784.0), jnp.float32)
        got = tode._normed_scalars(torch.tensor(e), torch.tensor(n),
                                   torch.tensor(d), 784.0)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


GOLDEN_PROBLEMS = {
    "exp_decay": (lambda t, y, a: -1.2 * y, [1.5], 0.0, 2.0),
    "oscillator": (lambda t, y, a: torch.stack([y[1], -9.0 * y[0]]),
                   [1.0, 0.0], 0.0, 4.0),
    "lotka_volterra": (
        lambda t, y, a: torch.stack([1.5 * y[0] - y[0] * y[1],
                                     -3.0 * y[1] + y[0] * y[1]]),
        [1.0, 1.0], 0.0, 8.0),
}


@pytest.mark.parametrize("controller", ["exact", "deadband"])
@pytest.mark.parametrize("tol", [1e-4, 1e-6, 1e-8])
@pytest.mark.parametrize("pname", sorted(GOLDEN_PROBLEMS))
def test_golden_traces(pname, tol, controller):
    """The float64 NumPy oracle's accepted/rejected step counts exactly,
    with the plain normed sweep over a callable; in exact mode
    (qsteady_max=1.0) also its accepted-dt sequence and final state, at
    the JAX package's own tolerances (tests/test_nfe_parity.py:100-106)."""
    f, y0, t0, t1 = GOLDEN_PROBLEMS[pname]
    ctrl = tctrl.PIController(beta1=7 / 50, beta2=2 / 25,
                              qsteady_max=1.0 if controller == "exact" else 1.2)
    sol = tode.odeint(f, torch.tensor(y0, dtype=torch.float64), t0, t1, (),
                      rtol=tol, atol=tol, max_steps=2048, controller=ctrl,
                      mode="while")
    want = GOLDEN[f"{pname}/{tol:g}/{controller}"]
    assert sol.stats.success
    assert (sol.stats.naccept, sol.stats.nreject, sol.stats.nfe) == (
        want["naccept"], want["nreject"], want["nfe"])
    if controller == "exact":
        tel = sol.telemetry
        acc = (tel.accepted & tel.live).numpy()
        np.testing.assert_allclose(tel.dt.numpy()[acc], want["accepted_dts"],
                                   rtol=3e-5, atol=1e-12)
        np.testing.assert_allclose(sol.y1.numpy(), want["final_y"], rtol=1e-7,
                                   atol=1e-10)


RTOL = ATOL = 1e-4
MAX_STEPS = 48
REG_W = 0.3


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _jax_normed_sweep_f64(t, dt, y, k1, p, rtol, atol):
    """The normed MLP trial step in plain jnp at the inputs' precision (the
    JAX package's own normed sweeps compute their products in float32)."""
    from regneuralde_tpu.ops.math import tanh
    from regneuralde_tpu.ops.tableaus import TSIT5 as tab

    w1x, w1t, b1, w2h, w2t, b2 = jmlp._split_params(p)

    def k(ti, yi):
        h = tanh(yi @ w1x + ti * w1t + b1)
        return tanh(h @ w2h + ti * w2t + b2)

    ks, g6 = [k1], y
    for i in range(1, 7):
        acc = sum(c * kk for c, kk in zip(tab.a[i - 1], ks) if c != 0.0)
        y_stage = y + dt * acc
        ks.append(k(t + tab.c[i] * dt, y_stage))
        if i == 5:
            g6 = y_stage
    err = dt * sum(c * (kk - ks[0]) for c, kk in zip(tab.btilde[1:], ks[1:]))
    scaled = err / (atol + jnp.maximum(jnp.abs(y), jnp.abs(y_stage)) * rtol)
    return jode.NormedSweep(y_stage, ks[-1], jnp.sum(scaled ** 2),
                            jnp.sum((ks[-1] - ks[-2]) ** 2),
                            jnp.sum((y_stage - g6) ** 2))


def _loss_parts(y1, tel, where, sum_):
    reg = sum_(where(tel.accepted, tel.eest * tel.dt, 0.0 * tel.eest))
    return sum_(y1 ** 2) + REG_W * reg


def _jax_solve(c, t1, kernels=True):
    """JAX fast adjoint: value and gradients of sum(y1^2) + 0.3 *
    sum_accepted(eest * dt). ``kernels``: the interpret-mode K1/K2 in
    float32; otherwise the plain normed sweep at the inputs' precision."""
    if kernels:
        sweep = lambda t, dt, y, f0, p: jmlp.mlp_dynamics_normed_sweep(
            t, dt, y, f0, p, RTOL, ATOL)
        sweep_bwd = lambda t, dt, y, k1, p, cts: jmlp.mlp_dynamics_normed_sweep_bwd(
            t, dt, y, k1, p, cts, RTOL, ATOL)
        func = _jax_f
    else:
        sweep = lambda t, dt, y, f0, p: _jax_normed_sweep_f64(
            t, dt, y, f0, p, RTOL, ATOL)

        def sweep_bwd(t, dt, y, k1, p, cts):
            _, vjp = jax.vjp(lambda *a: tuple(sweep(*a)), t, dt, y, k1, p)
            return vjp(tuple(cts))

        func = lambda t, y, p: sweep(t, 0.0 * t, y, y, p).k_last  # f(t, y)

    def loss(p, y0, t1):
        sol = jode.odeint(func, y0, 0.0, t1, p, rtol=RTOL, atol=ATOL,
                          max_steps=MAX_STEPS, mode="adjoint",
                          stage_sweep=sweep, stage_sweep_bwd=sweep_bwd)
        return _loss_parts(sol.y1, sol.telemetry, jnp.where, jnp.sum), sol

    dtype = np.float32 if kernels else np.float64
    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), _jax_params(c))
    (val, sol), grads = fn(p, jnp.asarray(c["y0"], dtype), jnp.asarray(t1, dtype))
    gp = grads[0]["params"]
    flat = [np.asarray(gp["dense_1"]["kernel"]).T, np.asarray(gp["dense_1"]["bias"]),
            np.asarray(gp["dense_2"]["kernel"]).T, np.asarray(gp["dense_2"]["bias"]),
            np.asarray(grads[1]), np.asarray(grads[2])]
    return float(val), sol, flat


def _torch_solve(c, t1, sweep, dtype=torch.float32):
    leaves = [_t(c[k], dtype).requires_grad_(True) for k in ("W1", "b1", "W2", "b2")]
    y0 = _t(c["y0"], dtype).requires_grad_(True)
    t1_ = torch.tensor(t1, dtype=dtype, requires_grad=True)
    kw = {}
    if sweep == "mlp":
        kw = dict(
            stage_sweep=lambda t, dt, y, k1, a: fm.mlp_dynamics_normed_sweep(
                t, dt, y, k1, a, RTOL, ATOL),
            stage_sweep_bwd=lambda t, dt, y, k1, a, cts: fm.mlp_dynamics_normed_sweep_bwd(
                t, dt, y, k1, a, cts, RTOL, ATOL))
    sol = tode.odeint(_torch_f, y0, 0.0, t1_, tuple(leaves), rtol=RTOL,
                      atol=ATOL, max_steps=MAX_STEPS, mode="adjoint", **kw)
    val = _loss_parts(sol.y1, sol.telemetry, torch.where, torch.sum)
    grads = torch.autograd.grad(val, [*leaves, y0, t1_])
    return val.item(), sol, [g.numpy() for g in grads]


def _assert_same_decisions(tsol, jsol):
    assert tsol.stats.success and bool(jsol.stats.success)
    assert (tsol.stats.nfe, tsol.stats.naccept, tsol.stats.nreject) == (
        int(jsol.stats.nfe), int(jsol.stats.naccept), int(jsol.stats.nreject))
    np.testing.assert_array_equal(tsol.telemetry.accepted.numpy(),
                                  np.asarray(jsol.telemetry.accepted))
    np.testing.assert_array_equal(tsol.telemetry.live.numpy(),
                                  np.asarray(jsol.telemetry.live))


@pytest.mark.parametrize("t1", [1.0, -0.7])
@pytest.mark.parametrize("sweep", ["generic", "mlp"])
@pytest.mark.parametrize("seed", [0, 3])
def test_odeint_adjoint_matches_jax_float64(x64, seed, sweep, t1):
    """The solver itself, free of float32 noise: JAX's fast adjoint (the
    one ``ops/ode.py:_make_fast_adjoint_solve`` builds for a normed sweep)
    against the port's, both in float64. ``generic``: the port's plain
    normed sweep over a callable with its autograd reverse; ``mlp``: the
    plain versions of K1/K2. Same NFE and accept sequence; y1 and telemetry
    at rtol=1e-5, atol=1e-7; value and gradients of sum(y1^2) + 0.3 *
    sum(eest * dt) at rtol=2e-3, atol=1e-5 (tests/test_pallas_fused.py:
    316-317). t1 < 0 integrates backwards in time."""
    c = _mlp_arrays(8, 16, 12, seed)
    jval, jsol, jgrads = _jax_solve(c, t1, kernels=False)
    tval, tsol, tgrads = _torch_solve(c, t1, sweep, torch.float64)
    _assert_same_decisions(tsol, jsol)
    np.testing.assert_allclose(tsol.y1.detach().numpy(), np.asarray(jsol.y1),
                               rtol=1e-5, atol=1e-7)
    for name in ("t", "dt", "eest", "eigen_est"):
        np.testing.assert_allclose(getattr(tsol.telemetry, name).detach().numpy(),
                                   np.asarray(getattr(jsol.telemetry, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    for name, a, b in zip(["W1", "b1", "W2", "b2", "y0", "t1"], tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def jax_kernel_solves():
    return {seed: _jax_solve(_mlp_arrays(8, 16, 12, seed), 1.0) for seed in (0, 3)}


@pytest.mark.parametrize("sweep", ["generic", "mlp"])
@pytest.mark.parametrize("seed", [0, 3])
def test_odeint_adjoint_matches_jax_kernels(jax_kernel_solves, seed, sweep):
    """float32, the JAX side through its interpret-mode kernels K1/K2.
    Same NFE and accept sequence. The two frameworks' exp differ by an ulp
    in about one argument in ten, and at rtol=1e-4 on these smooth
    dynamics the embedded error sits within a few times its float32
    rounding floor, so dt, and with it the trajectory, moves by a share of
    the solver tolerance: y1 is held to the solve's own tolerance, the
    telemetry streams to 5e-2 relative (Frobenius), the value to 1e-5, and
    each gradient leaf to 2e-3 relative (Frobenius; the elementwise form of
    that bound trips on single near-zero entries that carry the noise)."""
    c = _mlp_arrays(8, 16, 12, seed)
    jval, jsol, jgrads = jax_kernel_solves[seed]
    tval, tsol, tgrads = _torch_solve(c, 1.0, sweep)
    _assert_same_decisions(tsol, jsol)
    np.testing.assert_allclose(tsol.y1.detach().numpy(), np.asarray(jsol.y1),
                               rtol=RTOL, atol=ATOL)
    for name in ("t", "dt", "eest", "eigen_est"):
        a = getattr(tsol.telemetry, name).detach().numpy()
        b = np.asarray(getattr(jsol.telemetry, name))
        assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b), name
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    for name, a, b in zip(["W1", "b1", "W2", "b2", "y0", "t1"], tgrads, jgrads):
        assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b), name


@pytest.mark.parametrize("sweep", ["generic", "mlp"])
def test_fast_adjoint_matches_autograd_through_the_loop(sweep):
    """The oracle without JAX: autograd straight through the trial-step
    loop (``_solve_forward`` with grad on; the sweep's own backward for
    each step), float64. The fast adjoint must give the same gradients."""
    c = _mlp_arrays(6, 8, 5, 1)
    dtype = torch.float64
    tval, tsol, tgrads = _torch_solve(c, 1.0, sweep, dtype)
    leaves = [_t(c[k], dtype).requires_grad_(True) for k in ("W1", "b1", "W2", "b2")]
    y0 = _t(c["y0"], dtype).requires_grad_(True)
    t0 = torch.tensor(0.0, dtype=dtype)
    t1 = torch.tensor(1.0, dtype=dtype, requires_grad=True)
    f0 = _torch_f(t0, y0, leaves)
    dt0, _ = tctrl.initial_step_size(_torch_f, t0, y0, f0, leaves, 5, RTOL, ATOL, t1)
    if sweep == "mlp":
        step = lambda t, dt, y, k1, a: fm.mlp_dynamics_normed_sweep(
            t, dt, y, k1, a, RTOL, ATOL)
    else:
        step = lambda t, dt, y, k1, a: tode.plain_normed_sweep(
            _torch_f, t, dt, y, k1, a, RTOL, ATOL)
    y1, rows, accepted, done, _ = tode._solve_forward(
        step, tctrl.PIController.for_order(5), MAX_STEPS, t0, t1, dt0, y0, f0,
        tuple(leaves), keep_history=False)
    tel = tode._telemetry(rows, accepted, MAX_STEPS, t0)
    val = _loss_parts(y1, tel, torch.where, torch.sum)
    grads = torch.autograd.grad(val, [*leaves, y0, t1])
    assert done and accepted == tsol.telemetry.accepted[tsol.telemetry.live].tolist()
    np.testing.assert_allclose(val.item(), tval, rtol=1e-12)
    for name, a, b in zip(["W1", "b1", "W2", "b2", "y0", "t1"], tgrads, grads):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-9, atol=1e-12, err_msg=name)


def test_odeint_while_matches_adjoint_forward():
    c = _mlp_arrays(8, 16, 12, 0)
    leaves = tuple(_t(c[k]) for k in ("W1", "b1", "W2", "b2"))
    kw = dict(rtol=RTOL, atol=ATOL, max_steps=MAX_STEPS)
    a = tode.odeint(_torch_f, _t(c["y0"]), 0.0, 1.0, leaves, mode="adjoint", **kw)
    w = tode.odeint(_torch_f, _t(c["y0"]), 0.0, 1.0, leaves, mode="while", **kw)
    assert a.stats == w.stats
    assert torch.equal(a.y1, w.y1)
    for x, y in zip(a.telemetry, w.telemetry):
        assert torch.equal(x, y)


def test_odeint_reports_failure_when_steps_run_out():
    c = _mlp_arrays(8, 16, 12, 0)
    leaves = tuple(_t(c[k]) for k in ("W1", "b1", "W2", "b2"))
    sol = tode.odeint(_torch_f, _t(c["y0"]), 0.0, 1.0, leaves, rtol=1e-8,
                      atol=1e-8, max_steps=3, mode="while")
    assert not sol.stats.success
    assert sol.stats.naccept + sol.stats.nreject == 3
    assert torch.isfinite(sol.y1).all()


def test_odeint_rejects_unported_options():
    f = lambda t, y, a: -y
    with pytest.raises(NotImplementedError):
        tode.odeint(f, torch.ones(3), 0.0, 1.0, solver="dopri5")
    with pytest.raises(NotImplementedError):
        tode.odeint(f, torch.ones(3), 0.0, 1.0, mode="scan")
    with pytest.raises(ValueError):
        tode.odeint(f, torch.ones(3), 0.0, 1.0, mode="bogus")
