"""The port's generic solve engine (``regneuralde_tpu_torch.ops.ode``: the
tuple-protocol step over any FSAL tableau, the replay adjoint, the
checkpointed ``mode="scan"``, ``dt0``) against the JAX package's.

The solver itself is compared in float64 (the ``x64`` fixture), free of
float32 noise, over an MLP written out in each framework at the inputs'
precision; the routes of ``NeuralODE`` in float32, as the JAX package runs
them on the CPU (its step kernels in interpret mode). Both packages get the
same numpy arrays from a seeded generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from regneuralde_tpu.models import MLPDynamics as JMLP
from regneuralde_tpu.models import NeuralODE as JNODE
from regneuralde_tpu.ops import ode as jode
from regneuralde_tpu.ops.math import tanh as jtanh
from regneuralde_tpu_torch.models import MLPDynamics, NeuralODE
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import ode as tode

torch.set_num_threads(1)

TOL = 1e-6
MAX_STEPS = 64
REG_W = 0.3
LEAF_NAMES = ["W1", "b1", "W2", "b2"]


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _case(batch=4, dim=6, hidden=5, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return dict(
        W1=rng.normal(size=(hidden, dim + 1)) * scale / np.sqrt(dim + 1),
        b1=rng.normal(size=hidden) * 0.1,
        W2=rng.normal(size=(dim, hidden + 1)) * scale / np.sqrt(hidden + 1),
        b2=rng.normal(size=dim) * 0.1,
        y0=rng.normal(size=(batch, dim)) * 0.5,
    )


def _flax_params(c, dtype):
    return {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T, dtype), "bias": jnp.asarray(c["b1"], dtype)},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T, dtype), "bias": jnp.asarray(c["b2"], dtype)},
    }}


def _jax_grads_flat(gp):
    d1, d2 = gp["params"]["dense_1"], gp["params"]["dense_2"]
    return [np.asarray(d1["kernel"]).T, np.asarray(d1["bias"]), np.asarray(d2["kernel"]).T,
            np.asarray(d2["bias"])]


def _jax_f(t, y, p):
    """MLPDynamics at the inputs' precision (the package's own dynamics
    compute their products in float32)."""
    d1, d2 = p["params"]["dense_1"], p["params"]["dense_2"]
    ty = jnp.full(y.shape[:-1] + (1,), t, y.dtype)
    h = jtanh(jnp.concatenate([y, ty], -1) @ d1["kernel"] + d1["bias"])
    return jtanh(jnp.concatenate([h, ty], -1) @ d2["kernel"] + d2["bias"])


def _torch_f(t, y, leaves):
    return fm._mlp_k(y, t, fm._split_params(*leaves))[0]


def _stamps(t1):
    return t1 * np.array([0.0, 0.2, 0.45, 0.8, 1.0])


def _loss(sol, where, sum_):
    tel = sol.telemetry
    val = sum_(sol.y1 ** 2) + REG_W * sum_(where(tel.accepted, tel.eest * tel.dt,
                                                 0.0 * tel.eest))
    if sol.ys is not None:
        val = val + 0.5 * sum_(sol.ys ** 2)
    return val


def _jax_solve(c, solver, t1, saveat, mode="adjoint", **kw):
    """JAX's solve in float64 and the gradients of ``_loss`` with respect to
    the weights, y0, t1 and the ``saveat`` stamps (when given)."""
    def loss(p, y0, t1_, sa):
        sol = jode.odeint(_jax_f, y0, 0.0, t1_, p, solver=solver, rtol=TOL, atol=TOL,
                          max_steps=MAX_STEPS, mode=mode, saveat=sa, **kw)
        return _loss(sol, jnp.where, jnp.sum), sol

    sa = None if saveat is None else jnp.asarray(saveat)
    argnums = (0, 1, 2) if saveat is None else (0, 1, 2, 3)
    fn = jax.jit(jax.value_and_grad(loss, argnums=argnums, has_aux=True))
    (val, sol), g = fn(_flax_params(c, jnp.float64), jnp.asarray(c["y0"]), jnp.float64(t1), sa)
    return float(val), sol, _jax_grads_flat(g[0]) + [np.asarray(x) for x in g[1:]]


def _torch_solve(c, solver, t1, saveat, mode, dtype=torch.float64, **kw):
    leaves = [torch.tensor(c[k], dtype=dtype, requires_grad=True) for k in LEAF_NAMES]
    y0 = torch.tensor(c["y0"], dtype=dtype, requires_grad=True)
    t1_ = torch.tensor(t1, dtype=dtype, requires_grad=True)
    wrt = [*leaves, y0, t1_]
    sa = None
    if saveat is not None:
        sa = torch.tensor(saveat, dtype=dtype, requires_grad=True)
        wrt.append(sa)
    sol = tode.odeint(_torch_f, y0, 0.0, t1_, tuple(leaves), solver=solver, rtol=TOL,
                      atol=TOL, max_steps=MAX_STEPS, mode=mode, saveat=sa, **kw)
    val = _loss(sol, torch.where, torch.sum)
    grads = torch.autograd.grad(val, wrt)
    return val.item(), sol, [g.numpy() for g in grads]


def _assert_same_decisions(tsol, jsol):
    assert tsol.stats.success and bool(jsol.stats.success)
    assert (tsol.stats.nfe, tsol.stats.naccept, tsol.stats.nreject) == (
        int(jsol.stats.nfe), int(jsol.stats.naccept), int(jsol.stats.nreject))
    np.testing.assert_array_equal(tsol.telemetry.accepted.numpy(),
                                  np.asarray(jsol.telemetry.accepted))
    np.testing.assert_array_equal(tsol.telemetry.live.numpy(), np.asarray(jsol.telemetry.live))


_JAX_CACHE = {}


@pytest.mark.parametrize("mode", ["adjoint", "scan"])
@pytest.mark.parametrize("n_save", [0, 5])
@pytest.mark.parametrize("t1", [1.0, -0.7])
@pytest.mark.parametrize("solver", ["tsit5", "dopri5", "bosh3"])
def test_generic_sweep_matches_jax_float64(x64, solver, t1, n_save, mode):
    """The generic sweep over the MLP under the replay adjoint and under
    the scan, against JAX's replay adjoint in float64 (JAX's own tests pin
    its adjoint to its scan): the same NFE and accept sequence; y1, the
    saves and the telemetry at rtol=1e-5 / atol=1e-7; the gradients of
    sum(y1^2) + 0.3 * sum(eest * dt) (+ 0.5 * sum(ys^2)) with respect to
    the weights, y0, t1 and the stamps at rtol=2e-3 / atol=1e-5. t1 < 0
    integrates backwards in time; the first stamp is t0 (it holds y0)."""
    c = _case(seed=1)
    saveat = _stamps(t1) if n_save else None
    key = (solver, t1, n_save)
    if key not in _JAX_CACHE:
        _JAX_CACHE[key] = _jax_solve(c, solver, t1, saveat)
    jval, jsol, jgrads = _JAX_CACHE[key]
    tval, tsol, tgrads = _torch_solve(c, solver, t1, saveat, mode)
    _assert_same_decisions(tsol, jsol)
    np.testing.assert_allclose(tsol.y1.detach().numpy(), np.asarray(jsol.y1), rtol=1e-5,
                               atol=1e-7)
    if n_save:
        np.testing.assert_allclose(tsol.ys.detach().numpy(), np.asarray(jsol.ys), rtol=1e-5,
                                   atol=1e-7)
    for name in ("t", "dt", "eest", "eigen_est"):
        np.testing.assert_allclose(getattr(tsol.telemetry, name).detach().numpy(),
                                   np.asarray(getattr(jsol.telemetry, name)), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    assert len(tgrads) == len(jgrads) == 6 + (n_save > 0)
    for name, a, b in zip(LEAF_NAMES + ["y0", "t1", "saveat"], tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("solver", ["tsit5", "dopri5", "bosh3"])
def test_dt0_matches_jax(x64, solver):
    """With ``dt0`` the first step is dt0 towards t1 and Hairer's probe is
    not taken: NFE = 1 + (stages - 1) * trial steps, as JAX counts it; the
    same accepts and y1 as JAX's."""
    c = _case(seed=2)
    kw = dict(solver=solver, rtol=TOL, atol=TOL, max_steps=MAX_STEPS, dt0=0.05, mode="while")
    jsol = jode.odeint(_jax_f, jnp.asarray(c["y0"]), 0.0, -1.0,
                       _flax_params(c, jnp.float64), **kw)
    leaves = tuple(torch.tensor(c[k]) for k in LEAF_NAMES)
    tsol = tode.odeint(_torch_f, torch.tensor(c["y0"]), 0.0, -1.0, leaves, **kw)
    _assert_same_decisions(tsol, jsol)
    stages = {"tsit5": 7, "dopri5": 7, "bosh3": 4}[solver]
    assert tsol.stats.nfe == 1 + (stages - 1) * (tsol.stats.naccept + tsol.stats.nreject)
    assert tsol.telemetry.dt[0].item() == -0.05
    np.testing.assert_allclose(tsol.y1.numpy(), np.asarray(jsol.y1), rtol=1e-5, atol=1e-7)


def _sweep_kwargs(sweep):
    if sweep == "tuple":
        return dict(stage_sweep=fm.mlp_dynamics_stage_sweep)
    if sweep == "normed":
        return dict(stage_sweep=lambda t, dt, y, k1, a: fm.mlp_dynamics_normed_sweep(
            t, dt, y, k1, a, 1e-4, 1e-4),
                    stage_sweep_bwd=lambda t, dt, y, k1, a, cts: fm.mlp_dynamics_normed_sweep_bwd(
            t, dt, y, k1, a, cts, 1e-4, 1e-4))
    return {}


@pytest.mark.parametrize("sweep", ["generic", "tuple", "normed"])
def test_scan_forward_is_bitwise_the_adjoints(sweep):
    """The scan's forward is the adjoint's bit for bit on the same sweep
    (tests/test_pallas_fused.py:292-299), in float32 with saves: the
    generic sweep and K13's plain version under the replay adjoint, K1's
    under the fast adjoint."""
    c = _case(8, 16, 12, seed=3)
    leaves = tuple(torch.tensor(c[k], dtype=torch.float32, requires_grad=True)
                   for k in LEAF_NAMES)
    y0 = torch.tensor(c["y0"], dtype=torch.float32)
    sols = {mode: tode.odeint(_torch_f, y0, 0.0, 1.0, leaves, rtol=1e-4, atol=1e-4,
                              max_steps=MAX_STEPS, mode=mode, saveat=_stamps(1.0),
                              **_sweep_kwargs(sweep))
            for mode in ("adjoint", "scan", "while")}
    a = sols["adjoint"]
    for other in (sols["scan"], sols["while"]):
        assert a.stats == other.stats and a.stats.success
        assert torch.equal(a.y1, other.y1) and torch.equal(a.ys, other.ys)
        for u, v in zip(a.telemetry, other.telemetry):
            assert torch.equal(u, v)


def test_scan_hessian_vector_product_matches_jax(x64):
    """``mode="scan"`` through the generic sweep is twice differentiable:
    the Hessian-vector product of the loss with respect to W1 along a
    random direction, against JAX's scan (``jax.jvp`` of ``jax.grad``), in
    float64 at rtol=1e-6."""
    c = _case(seed=4)
    v = np.random.default_rng(5).normal(size=c["W1"].shape)
    kw = dict(rtol=1e-4, atol=1e-4, max_steps=24, mode="scan")

    def jloss(w1t):
        p = _flax_params(c, jnp.float64)
        p["params"]["dense_1"]["kernel"] = w1t
        sol = jode.odeint(_jax_f, jnp.asarray(c["y0"]), 0.0, 1.0, p, **kw)
        return _loss(sol, jnp.where, jnp.sum)

    w1t = jnp.asarray(c["W1"].T)
    _, want = jax.jit(lambda w, d: jax.jvp(jax.grad(jloss), (w,), (d,)))(w1t, jnp.asarray(v.T))

    leaves = [torch.tensor(c[k], requires_grad=True) for k in LEAF_NAMES]
    sol = tode.odeint(_torch_f, torch.tensor(c["y0"]), 0.0, 1.0, tuple(leaves), **kw)
    (g,) = torch.autograd.grad(_loss(sol, torch.where, torch.sum), leaves[:1],
                               create_graph=True)
    (hv,) = torch.autograd.grad(torch.sum(g * torch.tensor(v)), leaves[:1])
    np.testing.assert_allclose(hv.numpy(), np.asarray(want).T, rtol=1e-6, atol=1e-10)


def test_replay_adjoint_raises_on_a_flipped_accept():
    """A sweep whose replay decides otherwise than its forward (planted: its
    error grows a million times after the forward's calls) makes the
    replay adjoint's backward raise, and never hand back gradients."""
    c = _case(seed=6)
    leaves = tuple(torch.tensor(c[k], requires_grad=True) for k in LEAF_NAMES)
    calls = []

    def sweep(t, dt, y, k1, a):
        y_new, k_last, err, k_prev, g_prev = tode.generic_sweep(
            _torch_f, tode.TSIT5, t, dt, y, k1, a)
        calls.append(torch.is_grad_enabled())
        return y_new, k_last, err * (1e6 if torch.is_grad_enabled() else 1.0), k_prev, g_prev

    sol = tode.odeint(_torch_f, torch.tensor(c["y0"]), 0.0, 1.0, leaves, rtol=TOL, atol=TOL,
                      max_steps=MAX_STEPS, mode="adjoint", stage_sweep=sweep)
    assert sol.stats.success and not any(calls)
    with pytest.raises(RuntimeError, match="replay"):
        torch.autograd.grad(torch.sum(sol.y1 ** 2), leaves)


class _MatmulPrecisions(TorchDispatchMode):
    """Records the global float32 matmul precision at every matrix product
    the dispatcher runs (the backward's too: the engine runs under the
    caller's dispatch modes)."""

    OPS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.seen.append(torch.get_float32_matmul_precision())
        return func(*args, **(kwargs or {}))


def _backward_precisions(mode, caller="high", **kw):
    """The precision every product saw in the forward and in the backward
    of a float32 solve with saves (the caller's set to ``caller``), the
    caller's after the backward, and the solution and gradients."""
    c = _case(seed=7)
    leaves = tuple(torch.tensor(c[k], dtype=torch.float32, requires_grad=True)
                   for k in LEAF_NAMES)
    y0 = torch.tensor(c["y0"], dtype=torch.float32, requires_grad=True)
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(caller)
        with _MatmulPrecisions() as fwd:
            sol = tode.odeint(_torch_f, y0, 0.0, 1.0, leaves, rtol=1e-4, atol=1e-4,
                              max_steps=MAX_STEPS, mode=mode, saveat=_stamps(1.0), **kw)
        with _MatmulPrecisions() as bwd:
            grads = torch.autograd.grad(_loss(sol, torch.where, torch.sum), (*leaves, y0))
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(old)
    return set(fwd.seen), bwd.seen, after, sol, grads


def test_matmul_precision_holds_in_the_replay_backward():
    """The replay backward and the prologue's pullback run every product at
    the solve's ``matmul_precision``, not the caller's, and the caller's
    holds again after the backward."""
    fwd, bwd, after, _, _ = _backward_precisions("adjoint", matmul_precision="highest")
    assert fwd == {"highest"} and after == "high"
    assert len(bwd) > 0 and set(bwd) == {"highest"}


@pytest.mark.parametrize("remat", [True, False])
def test_matmul_precision_holds_in_the_scan_backward(remat):
    """The scan's backward, with and without the checkpointed steps, runs
    every product at the solve's ``matmul_precision``; the caller's holds
    again after it."""
    fwd, bwd, after, _, _ = _backward_precisions("scan", matmul_precision="highest",
                                                 remat=remat)
    assert fwd == {"highest"} and after == "high"
    assert len(bwd) > 0 and set(bwd) == {"highest"}


def test_matmul_precision_restored_when_only_closed_over_tensors_need_grad():
    """Dynamics that close over their weights give the solve no input
    that needs a gradient: the backward still runs its products at the
    solve's precision and restores the caller's at its end."""
    c = _case(seed=8)
    leaves = tuple(torch.tensor(c[k], dtype=torch.float32, requires_grad=True)
                   for k in LEAF_NAMES)
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        sol = tode.odeint(lambda t, y, a: _torch_f(t, y, leaves),
                          torch.tensor(c["y0"], dtype=torch.float32), 0.0, 1.0, rtol=1e-4,
                          atol=1e-4, max_steps=MAX_STEPS, mode="scan")
        with _MatmulPrecisions() as bwd:
            torch.autograd.grad(torch.sum(sol.y1 ** 2), leaves)
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(old)
    assert after == "high" and len(bwd.seen) > 0 and set(bwd.seen) == {"highest"}


@pytest.mark.parametrize("mode", ["adjoint", "scan"])
def test_matmul_precision_none_keeps_the_callers(mode):
    """``matmul_precision=None`` leaves the caller's precision to every
    product of the solve and its backward."""
    fwd, bwd, after, _, _ = _backward_precisions(mode, caller="medium", matmul_precision=None)
    assert fwd == {"medium"} and after == "medium"
    assert len(bwd) > 0 and set(bwd) == {"medium"}


def test_scan_without_remat_is_the_checkpointed_scan():
    """``remat=False`` (plain autograd through the steps) gives the
    checkpointed scan's forward and gradients bit for bit."""
    _, _, _, a, ga = _backward_precisions("scan", caller="highest", remat=True)
    _, _, _, b, gb = _backward_precisions("scan", caller="highest", remat=False)
    assert a.stats == b.stats and a.stats.success
    assert torch.equal(a.y1, b.y1) and torch.equal(a.ys, b.ys)
    for u, v in zip(a.telemetry, b.telemetry):
        assert torch.equal(u, v)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


# ---------------------------------------------------------------------------
# NeuralODE's routes against JAX's, float32.
# ---------------------------------------------------------------------------

NODE_TOL = 1e-4
ROUTES = [dict(fused="step", mode="scan"), dict(fused=False, mode="scan"),
          dict(solver="dopri5", mode="adjoint"), dict(solver="bosh3", mode="adjoint"),
          dict(solver="dopri5", mode="scan")]


@pytest.mark.parametrize("route", ROUTES, ids=lambda r: "-".join(map(str, r.values())))
def test_neural_ode_routes_match_jax(route):
    """``NeuralODE(MLPDynamics(16, 12))`` at rtol=atol=1e-4, batch 8, on
    ``mode="scan"`` (the normed step pair on ``fused="step"``, its plain
    version on ``False``) and with ``solver="dopri5"``/``"bosh3"`` (the
    generic sweep), against JAX's ``NeuralODE`` on the same weights and
    route (its step kernels in interpret mode): the same NFE and accepts,
    the value within 1e-4 and the gradients of sum(value^2) + 0.3 *
    sum(eest * dt) within 2e-3 (relative, Frobenius; float32 on both)."""
    mode = route["mode"]
    kw = {k: v for k, v in route.items() if k != "mode"}
    c = _case(8, 16, 12, seed=8)
    c = {k: np.asarray(v, np.float32) for k, v in c.items()}
    x = c["y0"]

    jnode = JNODE(JMLP(dim=16, hidden=12), rtol=NODE_TOL, atol=NODE_TOL, max_steps=MAX_STEPS,
                  **kw)

    def jloss(p):
        out = jnode(p, jnp.asarray(x), mode=mode)
        tel = out.telemetry
        reg = jnp.sum(jnp.where(tel.accepted, tel.eest * tel.dt, 0.0))
        return jnp.sum(out.value ** 2) + REG_W * reg, out

    (jval, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        _flax_params(c, jnp.float32))

    node = NeuralODE(MLPDynamics(16, 12, device="cpu"), rtol=NODE_TOL, atol=NODE_TOL,
                     max_steps=MAX_STEPS, **kw)
    node.dynamics.load_state_dict({
        "dense_1.weight": torch.tensor(c["W1"]), "dense_1.bias": torch.tensor(c["b1"]),
        "dense_2.weight": torch.tensor(c["W2"]), "dense_2.bias": torch.tensor(c["b2"])})
    out = node(torch.tensor(x), mode=mode)
    tel = out.telemetry
    val = torch.sum(out.value ** 2) + REG_W * torch.sum(
        torch.where(tel.accepted, tel.eest * tel.dt, torch.zeros_like(tel.eest)))
    grads = torch.autograd.grad(val, list(node.dynamics.parameters()))

    assert out.nfe == int(jout.nfe) and out.solution.stats.success
    np.testing.assert_array_equal(tel.accepted.numpy(), np.asarray(jout.telemetry.accepted))
    np.testing.assert_allclose(out.value.detach().numpy(), np.asarray(jout.value), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-4)
    for name, a, b in zip(LEAF_NAMES, grads, _jax_grads_flat(jg)):
        assert np.linalg.norm(a.numpy() - b) <= 2e-3 * np.linalg.norm(b), name
