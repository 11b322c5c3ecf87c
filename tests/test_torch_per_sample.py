"""Per-sample adaptive stepping: the port's batched per-lane engine, its
lane-wise trial step (K11/K12's plain versions) and the per-sample MNIST
classifier against the JAX package, on the CPU at small sizes.

The same numpy-seeded inputs go through both packages. JAX's lane kernels
run as its own tests run them: ``NeuralODE(per_sample="batched",
fused=True)`` takes ``_pallas_sweep_lanes`` in interpret mode. Dynamics run
at 3x LeCun's weight scale, so that each lane's error estimate sits well
above its float32 rounding floor: at LeCun's scale and rtol 1e-4 the
estimate of MLPDynamics(16, 12) is ~4e-5 of the tolerance, rounding noise,
and the two packages (and JAX's own fused and traced sweeps) part by one
trial step on some lanes. Tolerances are stated at each test.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.models import AlternatingMLP as JAltMLP
from regneuralde_tpu.models import ClassifierNODE as JClassifier
from regneuralde_tpu.models import MLPDynamics as JMLP
from regneuralde_tpu.models import NeuralODE as JNODE
from regneuralde_tpu.ops import odeint_per_sample as j_odeint_per_sample
from regneuralde_tpu.ops.pallas_mlp import _fused_step_lanes, _split_params
from regneuralde_tpu.training import mnist_node_optimizer as j_optimizer
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.convert import classifier_node_state_dict
from regneuralde_tpu_torch.models import (
    AlternatingMLP,
    ClassifierNODE,
    MLPDynamics,
    NeuralODE,
)
from regneuralde_tpu_torch.models.basic import _t_col
from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl
from regneuralde_tpu_torch.ops import odeint_per_sample, odeint_per_sample_batched
from regneuralde_tpu_torch.training import (
    create_train_state,
    make_train_step,
    mnist_node_optimizer,
)

torch.set_num_threads(1)

DIM, HIDDEN, BATCH = 16, 12, 8
TOL, MAX_STEPS = 1e-5, 32
SCALE = 3.0  # times LeCun's weight scale
T1_LANES = [0.55, 0.8, 1.0, 1.2, 0.9, 1.35, 0.7, 1.05]
GRID = [0.0, 0.2, 0.45, 0.7, 1.0]


def _f32(a):
    return np.asarray(a, np.float32)


def _x(seed=0, scale=0.5):
    return _f32(np.random.default_rng(seed).normal(size=(BATCH, DIM)) * scale)


def _jax_mlp_params(seed=1):
    """JAX's MLPDynamics init at DIM x HIDDEN, kernels scaled by SCALE."""
    p = JMLP(dim=DIM, hidden=HIDDEN).init(jax.random.PRNGKey(seed), jnp.zeros((1, DIM)),
                                          jnp.float32(0.0))
    return jax.tree_util.tree_map(lambda a: a * SCALE if a.ndim == 2 else a, p)


def _torch_mlp(jparams):
    """The port's MLPDynamics with JAX's weights (``nn.Linear`` layout)."""
    m = MLPDynamics(DIM, HIDDEN, device="cpu")
    p = jparams["params"]
    with torch.no_grad():
        for name in ("dense_1", "dense_2"):
            layer = getattr(m, name)
            layer.weight.copy_(torch.tensor(np.asarray(p[name]["kernel"]).T))
            layer.bias.copy_(torch.tensor(np.asarray(p[name]["bias"])))
    return m


def _leaves_from_jax(jparams):
    p = jparams["params"]
    return [torch.tensor(np.asarray(p["dense_1"]["kernel"]).T.copy()),
            torch.tensor(np.asarray(p["dense_1"]["bias"])),
            torch.tensor(np.asarray(p["dense_2"]["kernel"]).T.copy()),
            torch.tensor(np.asarray(p["dense_2"]["bias"]))]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ---------------------------------------------------------------------------
# _t_col: a per-lane time vector.
# ---------------------------------------------------------------------------


def test_t_col_takes_a_per_lane_time_vector():
    """MLPDynamics on a ``(batch,)`` time vector and on a scalar against
    JAX's module (``_t_row``) at rtol=1e-6, atol=1e-6; the column is the
    vector itself, the scalar broadcast."""
    jp = _jax_mlp_params()
    m = _torch_mlp(jp)
    x = _x()
    t = _f32(np.linspace(0.1, 0.9, BATCH))
    for tt in (t, _f32(0.3)):
        want = JMLP(dim=DIM, hidden=HIDDEN).apply(jp, jnp.asarray(x), jnp.asarray(tt))
        got = m(torch.tensor(x), torch.tensor(tt))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    col = _t_col(torch.zeros(BATCH, 3), torch.tensor(t))
    assert col.shape == (BATCH, 1) and torch.equal(col[:, 0], torch.tensor(t))
    assert torch.equal(_t_col(torch.zeros(BATCH, 3), 0.25), torch.full((BATCH, 1), 0.25))


def test_alternating_mlp_runs_on_the_per_sample_engine():
    """AlternatingMLP (time-free: the engine's per-lane time never reaches
    it) through ``NeuralODE(per_sample="batched")``, the traced per-lane
    sweep, against JAX's at rtol=atol=1e-4: the same per-lane NFE and
    accepts, y1 within rtol=1e-3, atol=1e-4, the solve's tolerance. (The time-free network's
    error estimate meets its float32 floor sooner: at 1e-5 JAX and the port
    part by one trial step on a lane or two.)"""
    dim, hidden, depth = 6, 10, 2
    x = _f32(np.random.default_rng(3).normal(size=(BATCH, dim)) * 0.5)
    jm = JAltMLP(dim=dim, hidden=hidden, depth=depth)
    jp = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))
    jp = jax.tree_util.tree_map(lambda a: a * SCALE if a.ndim == 2 else a, jp)
    kw = dict(time_dep=False, rtol=1e-4, atol=1e-4, max_steps=MAX_STEPS)
    jout = JNODE(jm, per_sample="batched", **kw)(jp, jnp.asarray(x))
    m = AlternatingMLP(dim, hidden, depth, device="cpu")
    with torch.no_grad():
        for i in range(depth):
            for name in (f"up_{i}", f"down_{i}"):
                layer = getattr(m, name)
                layer.weight.copy_(torch.tensor(np.asarray(jp["params"][name]["kernel"]).T))
                layer.bias.copy_(torch.tensor(np.asarray(jp["params"][name]["bias"])))
    out = NeuralODE(m, per_sample="batched", **kw)(torch.tensor(x))
    np.testing.assert_array_equal(out.nfe.numpy(), np.asarray(jout.nfe))
    np.testing.assert_array_equal(out.telemetry.accepted.numpy(),
                                  np.asarray(jout.telemetry.accepted))
    np.testing.assert_allclose(out.value.detach().numpy(), np.asarray(jout.value),
                               rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# K11/K12's plain versions.
# ---------------------------------------------------------------------------


def _lane_inputs(seed=5):
    """Per-lane (t, dt) spread over [0, 1.2] x [0, 0.3] with a dt = 0 lane,
    y, a random k1 (the embedded error far from rounding) and the five
    cotangents."""
    rng = np.random.default_rng(seed)
    t = _f32(rng.uniform(0.0, 1.2, BATCH))
    dt = _f32(rng.uniform(0.01, 0.3, BATCH))
    dt[3] = 0.0
    y = _f32(rng.normal(size=(BATCH, DIM)) * 0.5)
    k1 = _f32(rng.normal(size=(BATCH, DIM)) * 0.3)
    cts = [_f32(rng.normal(size=(BATCH, DIM))) for _ in range(5)]
    return t, dt, y, k1, cts


def test_lane_step_plain_versions_match_jax_interpret_kernels():
    """K11's plain version against JAX's interpret-mode ``_fused_step_lanes``
    (rtol=1e-4, atol=2e-6: ATen's and XLA's exp differ by an ulp, the port
    sums the affine maps in float64, and at 3x LeCun's scale six stages
    carry a stage's ulp into a few; the worst reading is 1.1e-6); K12's plain version against the
    interpret-mode K12 through ``jax.vjp`` (rtol=2e-3, atol=1e-5, the JAX
    package's tolerance for a hand backward against its vjp in float32).
    The dt = 0 lane: y_new = g6 = y, err exactly zero, all finite."""
    jp = _jax_mlp_params()
    parts = _split_params(jp)
    t, dt, y, k1, cts = _lane_inputs()
    jargs = (jnp.asarray(t)[:, None], jnp.asarray(dt)[:, None], jnp.asarray(y),
             jnp.asarray(k1), parts)
    jout, vjp = jax.vjp(_fused_step_lanes, *jargs)
    jct = vjp(tuple(jnp.asarray(c) for c in cts))
    leaves = _leaves_from_jax(jp)
    tt, tdt, ty, tk1 = map(torch.tensor, (t, dt, y, k1))
    fl.reset_launches()
    out = fl.sweep_lanes_fwd(tt, tdt, ty, tk1, leaves)
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=2e-6)
    assert torch.equal(out[0][3], ty[3]) and torch.equal(out[4][3], ty[3])
    assert not out[2][3].any() and all(torch.isfinite(o).all() for o in out)
    ct_t, ct_dt, ct_y, ct_k1, ct_leaves = fl.sweep_lanes_bwd(
        tt, tdt, ty, tk1, leaves, [torch.tensor(c) for c in cts])
    jc_t, jc_dt, jc_y, jc_k1, jc_parts = jct
    w1x, w1t, b1, w2h, w2t, b2 = (np.asarray(a) for a in jc_parts)
    want = [np.asarray(jc_t)[:, 0], np.asarray(jc_dt)[:, 0], jc_y, jc_k1,
            np.concatenate([w1x, w1t], 0).T, b1[0], np.concatenate([w2h, w2t], 0).T, b2[0]]
    got = [ct_t, ct_dt, ct_y, ct_k1, *ct_leaves]
    for name, a, b in zip(["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"],
                          got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=1e-5,
                                   err_msg=name)
    assert fl.LAUNCHES == {"mlp_lanes_tsit5_fwd": 0, "mlp_lanes_tsit5_bwd": 0}


@pytest.mark.parametrize("seed", [5, 6])
def test_lane_step_hand_backward_matches_autograd_float64(seed):
    """K12's plain version (the hand reverse chain) against
    ``torch.autograd`` of K11's plain version in float64, at 1e-10; so is
    the backward of ``mlp_dynamics_sweep_lanes`` (``SweepLanesFn``: K11
    forward, K12 backward, their plain versions on the CPU)."""
    t, dt, y, k1, cts = _lane_inputs(seed)
    rng = np.random.default_rng(seed + 10)
    leaves = [torch.tensor(rng.normal(size=s) * SCALE / np.sqrt(s[-1]))
              for s in ((HIDDEN, DIM + 1), (HIDDEN,), (DIM, HIDDEN + 1), (DIM,))]
    prim = [torch.tensor(a, dtype=torch.float64, requires_grad=True) for a in (t, dt, y, k1)]
    lv = [x.clone().requires_grad_(True) for x in leaves]
    c64 = [torch.tensor(c, dtype=torch.float64) for c in cts]
    out = fl.plain_mlp_sweep_lanes(*prim, lv)
    want = torch.autograd.grad(out, [*prim, *lv], grad_outputs=c64)
    got = fl.plain_mlp_sweep_lanes_bwd(*[p.detach() for p in prim], leaves, c64)
    for a, b in zip([*got[:4], *got[4]], want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)
    fn_out = fl.mlp_dynamics_sweep_lanes(*prim, lv)
    for a, b in zip(fn_out, out):
        assert torch.equal(a, b)
    for a, b in zip(torch.autograd.grad(fn_out, [*prim, *lv], grad_outputs=c64), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# The engine against JAX's.
# ---------------------------------------------------------------------------


def _linear_problem(seed=7):
    """dy/dt = y A with A skew-symmetric (an oscillator: |y| stays bounded)
    and its eigenvalues' scale ~2, so the error estimate is truncation,
    not rounding."""
    S = np.random.default_rng(seed).normal(size=(DIM, DIM)) / np.sqrt(DIM)
    return _f32((S - S.T) * 2.0), _x(seed)


def _saveat(kind):
    if kind == "shared":
        return _f32(GRID)
    if kind == "per_sample":
        rng = np.random.default_rng(11)
        return _f32(np.sort(rng.uniform(0.0, 0.5, (BATCH, 4)), axis=1))
    return None


def _check_solutions(sol, jsol, saveat):
    """Per-lane NFE, accepts and success equal; y1 and ys within the
    solve's tolerance (rtol=1e-4, atol=1e-5); the telemetry relative
    (Frobenius) within 1e-2 (t) and 5e-2 (dt; eest and eigen_est but on
    each lane's last trial step). The error estimate differs between the
    packages by float32 rounding (up to ~5%) and the controller carries that
    into every later dt; each lane's last step is the sliver left before
    its t1, whose length follows the rounding of t (0.0022 against 0.0002
    in one case here) and whose eigen_est is then a ratio of rounding."""
    np.testing.assert_array_equal(sol.stats.nfe.numpy(), np.asarray(jsol.stats.nfe))
    np.testing.assert_array_equal(sol.stats.success.numpy(), np.asarray(jsol.stats.success))
    assert sol.stats.success.all()
    for name in ("accepted", "live"):
        np.testing.assert_array_equal(getattr(sol.telemetry, name).numpy(),
                                      np.asarray(getattr(jsol.telemetry, name)), err_msg=name)
    np.testing.assert_allclose(sol.y1.detach().numpy(), np.asarray(jsol.y1), rtol=1e-4,
                               atol=1e-5)
    if saveat is not None:
        assert sol.ys.shape == jsol.ys.shape
        np.testing.assert_allclose(sol.ys.detach().numpy(), np.asarray(jsol.ys), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(sol.ts.numpy(), np.asarray(jsol.ts))
    live = sol.telemetry.live.numpy()
    inner = live.copy()
    inner[np.arange(BATCH), live.sum(1) - 1] = False
    for name, tol, mask in (("t", 1e-2, live), ("dt", 5e-2, live), ("eest", 5e-2, inner),
                            ("eigen_est", 5e-2, inner)):
        a = getattr(sol.telemetry, name).detach().numpy()[mask]
        assert _rel(a, np.asarray(getattr(jsol.telemetry, name))[mask]) <= tol, name


@pytest.mark.parametrize("saveat", [None, "shared", "per_sample"])
@pytest.mark.parametrize("t1", ["scalar", "lanes"])
def test_engine_matches_jax_on_a_linear_ode(t1, saveat):
    """``odeint_per_sample_batched`` on dy/dt = y A against JAX's, with a
    scalar and a per-lane ``t1``, without saveat and on a shared and a
    per-sample grid (``_check_solutions``)."""
    A, x = _linear_problem()
    t1v = 1.0 if t1 == "scalar" else _f32(T1_LANES)
    sa = _saveat(saveat)
    kw = dict(rtol=TOL, atol=TOL, max_steps=MAX_STEPS)
    jsol = j_odeint_per_sample(lambda t, y, a: y @ a[0], jnp.asarray(x), 0.0,
                               jnp.asarray(t1v), (jnp.asarray(A),), engine="batched",
                               saveat=None if sa is None else jnp.asarray(sa), **kw)
    sol = odeint_per_sample_batched(lambda t, y, a: y @ a[0], torch.tensor(x), 0.0,
                                    torch.tensor(t1v), (torch.tensor(A),),
                                    saveat=None if sa is None else torch.tensor(sa), **kw)
    _check_solutions(sol, jsol, sa)


MLP_CASES = [(False, "scalar", None), (False, "lanes", "shared"), (True, "scalar", None),
             (True, "lanes", "shared"), (True, "lanes", "per_sample")]


@pytest.mark.parametrize("fused,t1,saveat", MLP_CASES)
def test_engine_matches_jax_on_mlp_dynamics(fused, t1, saveat):
    """``NeuralODE(MLPDynamics, per_sample="batched")`` against JAX's: on
    ``fused=True`` the port's K11/K12 plain versions against JAX's
    interpret-mode lane kernels, on ``False`` the plain versions against
    JAX's traced sweep (``_check_solutions``)."""
    jp = _jax_mlp_params()
    x = _x()
    t1v = 1.0 if t1 == "scalar" else _f32(T1_LANES)
    sa = _saveat(saveat)
    kw = dict(rtol=TOL, atol=TOL, max_steps=MAX_STEPS, per_sample="batched", fused=fused)
    jout = JNODE(JMLP(dim=DIM, hidden=HIDDEN), **kw)(
        jp, jnp.asarray(x), tspan=(0.0, jnp.asarray(t1v)),
        saveat=None if sa is None else jnp.asarray(sa))
    out = NeuralODE(_torch_mlp(jp), **kw)(
        torch.tensor(x), tspan=(0.0, torch.tensor(t1v)),
        saveat=None if sa is None else torch.tensor(sa))
    _check_solutions(out.solution, jout.solution, sa)
    np.testing.assert_array_equal(out.nfe.numpy(), np.asarray(jout.nfe))


def test_engine_gradients_match_jax_scan():
    """Gradients of <W, y1> + <V, ys> + 0.3 * error_estimate (W, V random:
    on the skew-symmetric system |y|^2 is constant, and a quadratic loss
    would leave t1's and saveat's gradients to rounding) through the
    adjoint engine on the linear ODE, with respect to y0, the per-lane t1,
    A and the saveat grid, against JAX's ``mode="scan"`` of the same
    engine (JAX's oracle; the port has no scan): rtol=5e-3, atol=1e-4, the
    JAX package's tolerance for its adjoint against its scan (the readings
    are 2e-5 relative)."""
    A, x = _linear_problem()
    t1v, sa = _f32(T1_LANES), _f32(GRID[1:])
    rng = np.random.default_rng(12)
    W, V = _f32(rng.normal(size=(BATCH, DIM))), _f32(rng.normal(size=(len(sa), BATCH, DIM)))
    kw = dict(rtol=TOL, atol=TOL, max_steps=MAX_STEPS)

    def jloss(y0, t1, a, s):
        sol = j_odeint_per_sample(lambda t, y, args: y @ args[0], y0, 0.0, t1, (a,),
                                  engine="batched", mode="scan", saveat=s, **kw)
        return (jnp.sum(W * sol.y1) + jnp.sum(V * sol.ys)
                + 0.3 * jreg.error_estimate(sol.telemetry, "mean"))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (x, t1v, A, sa)))
    prim = [torch.tensor(a, requires_grad=True) for a in (x, t1v, A, sa)]
    sol = odeint_per_sample_batched(lambda t, y, args: y @ args[0], prim[0], 0.0, prim[1],
                                    (prim[2],), saveat=prim[3], **kw)
    loss = (torch.sum(torch.tensor(W) * sol.y1) + torch.sum(torch.tensor(V) * sol.ys)
            + 0.3 * treg.error_estimate(sol.telemetry, "mean"))
    got = torch.autograd.grad(loss, prim)
    for name, a, b in zip(["y0", "t1", "A", "saveat"], got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-3, atol=1e-4,
                                   err_msg=name)
    assert np.abs(got[3].numpy()).max() > 0


def test_mlp_gradients_match_jax_scan():
    """Gradients of sum(y1^2) + 0.3 * error_estimate with respect to the
    MLPDynamics weights and the per-lane t1, the port's adjoint over K11/K12's
    plain versions against JAX's ``mode="scan"`` over its interpret-mode lane
    kernels (rtol=5e-3, atol=1e-4). On the CPU the port's ``fused=False``
    runs the same plain functions (``test_routes_launch_no_kernel_on_the_cpu``)."""
    fused = True
    jp = _jax_mlp_params()
    x, t1v = _x(), _f32(T1_LANES)
    kw = dict(rtol=TOL, atol=TOL, max_steps=MAX_STEPS, per_sample="batched", fused=fused)
    jnode = JNODE(JMLP(dim=DIM, hidden=HIDDEN), **kw)

    def jloss(p, t1):
        out = jnode(p, jnp.asarray(x), tspan=(0.0, t1), mode="scan")
        return jnp.sum(out.value ** 2) + 0.3 * jreg.error_estimate(out.telemetry, "mean")

    gp, gt = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(t1v))
    m = _torch_mlp(jp)
    t1 = torch.tensor(t1v, requires_grad=True)
    out = NeuralODE(m, **kw)(torch.tensor(x), tspan=(0.0, t1))
    loss = torch.sum(out.value ** 2) + 0.3 * treg.error_estimate(out.telemetry, "mean")
    loss.backward()
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(gt), rtol=5e-3, atol=1e-4)
    for name in ("dense_1", "dense_2"):
        layer = getattr(m, name)
        np.testing.assert_allclose(layer.weight.grad.numpy(),
                                   np.asarray(gp["params"][name]["kernel"]).T,
                                   rtol=5e-3, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(layer.bias.grad.numpy(),
                                   np.asarray(gp["params"][name]["bias"]),
                                   rtol=5e-3, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("saveat", [None, "shared"])
def test_adjoint_matches_autograd_through_the_loop_float64(saveat):
    """The adjoint engine's gradients (the reverse walk: autograd of the
    per-lane chain, the sweep's backward, dt_eff's pullback) against
    ``torch.autograd`` straight through the forward iteration loop, on
    MLPDynamics in float64 with a per-lane t1: y0, t1, the saveat grid and
    the weights at 1e-9."""
    from regneuralde_tpu_torch.ops import per_sample_batched as psb
    from regneuralde_tpu_torch.ops.controller import PIController

    m = _torch_mlp(_jax_mlp_params()).double()
    leaves = tuple(m.parameters())
    node = NeuralODE(m, rtol=TOL, atol=TOL, max_steps=MAX_STEPS, per_sample="batched",
                     fused=True)
    rng = np.random.default_rng(13)
    W = torch.tensor(rng.normal(size=(BATCH, DIM)))
    sa = None if saveat is None else torch.tensor(GRID[1:], dtype=torch.float64,
                                                 requires_grad=True)
    grads = []
    for route in ("adjoint", "loop"):
        y0 = torch.tensor(_x(), dtype=torch.float64, requires_grad=True)
        t1 = torch.tensor(T1_LANES, dtype=torch.float64, requires_grad=True)
        if route == "adjoint":
            sol = node(y0, tspan=(0.0, t1), saveat=sa).solution
            y1, ys, tel = sol.y1, sol.ys, sol.telemetry
        else:
            func = node._func
            t0v = torch.zeros(BATCH, dtype=torch.float64)
            f0 = func(t0v, y0, leaves)
            dt0, _ = psb._per_lane_initial_dt(func, t0v, y0, f0, leaves, 5, TOL, TOL, t1)
            eng = psb._Engine(fl.plain_mlp_sweep_lanes, None, PIController.for_order(5), TOL,
                              TOL, MAX_STEPS)
            sag = None if sa is None else sa.expand(BATCH, -1)
            ys0 = None if sa is None else torch.where(
                (sag <= 0)[:, :, None], y0[:, None, :], torch.zeros(BATCH, sag.shape[1], DIM,
                                                                    dtype=torch.float64))
            (y1, ys, _, _, _), rows, _ = psb._solve_forward(eng, t0v, t1, dt0, y0, f0, ys0,
                                                            sag, leaves, keep=False)
            tel = psb._telemetry(rows, MAX_STEPS)
            ys = None if ys is None else ys.transpose(0, 1)
        loss = torch.sum(W * y1) + treg.error_estimate(tel, "mean")
        if sa is not None:
            loss = loss + torch.sum(ys[..., 0])
        wrt = [y0, t1, *leaves] + ([] if sa is None else [sa])
        grads.append(torch.autograd.grad(loss, wrt))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)


def test_each_lane_equals_its_solo_solve():
    """Every lane of a batched solve against the same lane solved alone
    (batch 1) at its own t1: the same NFE and accepts, y1 within rtol=1e-5,
    atol=1e-6 (the module's float32 products of a 1-row and an 8-row matrix
    round differently, and the prologue's initial dt with them)."""
    jp = _jax_mlp_params()
    x, t1v = _x(), _f32(T1_LANES)
    node = NeuralODE(_torch_mlp(jp), rtol=TOL, atol=TOL, max_steps=MAX_STEPS,
                     per_sample="batched", fused=True)
    out = node(torch.tensor(x), tspan=(0.0, torch.tensor(t1v)), mode="while")
    for i in range(BATCH):
        solo = node(torch.tensor(x[i:i + 1]), tspan=(0.0, torch.tensor(t1v[i:i + 1])),
                    mode="while")
        assert solo.nfe.item() == out.nfe[i].item(), i
        n = int(solo.telemetry.live.sum())
        assert torch.equal(solo.telemetry.accepted[0, :n], out.telemetry.accepted[i, :n])
        np.testing.assert_allclose(solo.value[0].numpy(), out.value[i].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_while_mode_is_the_adjoint_forward():
    """``mode="while"`` runs the adjoint engine's forward without recording:
    the same values, NFE and telemetry, bitwise."""
    A, x = _linear_problem()
    kw = dict(rtol=TOL, atol=TOL, max_steps=MAX_STEPS, saveat=torch.tensor(GRID))
    args = (lambda t, y, a: y @ a[0], torch.tensor(x), 0.0, torch.tensor(T1_LANES),
            (torch.tensor(A),))
    a = odeint_per_sample(*args, engine="batched", mode="adjoint", **kw)
    w = odeint_per_sample(*args, engine="batched", mode="while", **kw)
    assert torch.equal(a.y1, w.y1) and torch.equal(a.ys, w.ys)
    assert torch.equal(a.stats.nfe, w.stats.nfe)
    for x_a, x_w in zip(a.telemetry, w.telemetry):
        assert torch.equal(x_a, x_w)


# ---------------------------------------------------------------------------
# The per-sample classifier's training step.
# ---------------------------------------------------------------------------


CLS_TOL, CLS_MAX_STEPS, CLS_REG = 1e-4, 64, 100.0


def _cls_batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(_f32(rng.uniform(0.0, 1.0, (BATCH, DIM))),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, BATCH)]) for _ in range(n)]


def _cls_node(fused):
    return dict(rtol=CLS_TOL, atol=CLS_TOL, max_steps=CLS_MAX_STEPS, per_sample="batched",
                fused=fused)


@pytest.fixture(scope="module")
def classifier_runs():
    """JAX's per-sample classifier on both routes from one init (the
    dynamics' kernels at SCALE times their init): per step of three
    training steps on the cross-entropy the per-lane NFE, and the
    parameters after them; the first step's per-lane NFE and gradient on
    CE + CLS_REG * error_estimate."""
    batches = _cls_batches()
    runs = {}
    for fused in (False, True):
        clf = JClassifier(None, JNODE(JMLP(dim=DIM, hidden=HIDDEN), **_cls_node(fused)),
                          fnn.Dense(10))
        params = dict(clf.init(jax.random.PRNGKey(2), jnp.asarray(batches[0][0])))
        params["de"] = jax.tree_util.tree_map(lambda a: a * SCALE if a.ndim == 2 else a,
                                              params["de"])

        def loss(p, x, y, w):
            out = clf(p, x)
            ce = optax.softmax_cross_entropy(out.logits, y).mean()
            return ce + w * jreg.error_estimate(out.telemetry, "mean"), out

        grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
        (_, out), g = grad_fn(params, *map(jnp.asarray, batches[0]), CLS_REG)
        run = dict(params=params, reg_nfe=np.asarray(out.nfe), reg_grads=_flat(g))
        opt = j_optimizer()
        state = opt.init(params)
        p, nfes = params, []
        for x, y in batches:
            (_, out), g = grad_fn(p, jnp.asarray(x), jnp.asarray(y), 0.0)
            nfes.append(np.asarray(out.nfe))
            updates, state = opt.update(g, state, p)
            p = optax.apply_updates(p, updates)
        runs[fused] = dict(run, nfes=nfes, after=p)
    return runs


def _flat(tree):
    d, q = tree["de"]["params"], tree["post"]["params"]
    return [np.asarray(a) for a in (d["dense_1"]["kernel"], d["dense_1"]["bias"],
                                    d["dense_2"]["kernel"], d["dense_2"]["bias"],
                                    q["kernel"], q["bias"])]


def _torch_classifier(run, fused, dtype=torch.float32):
    clf = ClassifierNODE(None, NeuralODE(MLPDynamics(DIM, HIDDEN, device="cpu"),
                                         **_cls_node(fused)), torch.nn.Linear(DIM, 10))
    clf.load_state_dict(classifier_node_state_dict(
        jax.tree_util.tree_map(np.asarray, run["params"])))
    return clf.to(dtype)


def _cls_loss(reg_weight):
    def loss_fn(model, x, y):
        out = model(x)
        ce = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1).mean()
        return ce + reg_weight * treg.error_estimate(out.telemetry, "mean"), out
    return loss_fn


def _jax_layout(clf):
    g = [p.grad.numpy() for p in clf.parameters()]
    return [g[0].T, g[1], g[2].T, g[3], g[4].T, g[5]]


@pytest.mark.parametrize("fused", [False, True])
def test_classifier_training_steps_match_jax(classifier_runs, fused):
    """Three InvDecay+Momentum steps of ``ClassifierNODE(None,
    NeuralODE(MLPDynamics(16, 12), per_sample="batched", fused),
    Dense(10))`` on the cross-entropy (rtol=atol=1e-4, batch 8) against
    JAX's: the same per-lane NFE at each step; each parameter leaf within
    2e-3 of JAX's, relative to the distance it moved (the readings are
    ~1e-5)."""
    run = classifier_runs[fused]
    clf = _torch_classifier(run, fused)
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(_cls_loss(0.0), optimizer)
    for (x, y), jnfe in zip(_cls_batches(), run["nfes"]):
        state, loss, out = step(state, torch.tensor(x), torch.tensor(y))
        assert torch.isfinite(loss) and out.success.all()
        np.testing.assert_array_equal(out.nfe.numpy(), jnfe)
    got = [p.detach().numpy() for p in clf.parameters()]
    got = [got[0].T, got[1], got[2].T, got[3], got[4].T, got[5]]
    for name, a, b, b0 in zip(["W1", "b1", "W2", "b2", "post_W", "post_b"], got,
                              _flat(run["after"]), _flat(run["params"])):
        assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b - b0), name


@pytest.mark.parametrize("fused", [False, True])
def test_regularized_classifier_step_matches_jax(classifier_runs, fused):
    """The first step on CE + 100 * error_estimate: the same per-lane NFE
    as JAX's; the port's float32 gradient and JAX's each within 5e-2
    (relative) of the port's float64 gradient. Per lane, the error
    estimate's gradient is ill-conditioned in float32: the readings are
    2.6% for the port, 4.3% (traced sweep) and 0.9% (lane kernels) for JAX,
    so the two float32 gradients are not held to each other (a parity limit,
    ``ROADMAP.md`` queue 3; the cross-entropy's agree to ~1e-5)."""
    run = classifier_runs[fused]
    x, y = (torch.tensor(a) for a in _cls_batches()[0])
    grads = {}
    for dtype in (torch.float32, torch.float64):
        clf = _torch_classifier(run, fused, dtype)
        loss, out = _cls_loss(CLS_REG)(clf, x.to(dtype), y.to(dtype))
        loss.backward()
        np.testing.assert_array_equal(out.nfe.numpy(), run["reg_nfe"])
        grads[dtype] = np.concatenate([g.ravel() for g in _jax_layout(clf)])
    g64 = grads[torch.float64]
    g_jax = np.concatenate([g.ravel() for g in run["reg_grads"]])
    assert _rel(grads[torch.float32], g64) <= 5e-2
    assert _rel(g_jax, g64) <= 5e-2


# ---------------------------------------------------------------------------
# Routing, refusals, STEER.
# ---------------------------------------------------------------------------


def test_routes_launch_no_kernel_on_the_cpu():
    """``fused=True`` on CPU tensors takes K11/K12's plain versions and
    counts no launch; per-lane NFE, y1 and the gradients equal
    ``fused=False``'s bitwise (the same plain functions)."""
    jp = _jax_mlp_params()
    x = torch.tensor(_x())
    results = {}
    for fused in (True, False):
        m = _torch_mlp(jp)
        fl.reset_launches()
        out = NeuralODE(m, rtol=TOL, atol=TOL, max_steps=MAX_STEPS, per_sample="batched",
                        fused=fused)(x)
        (out.value.sum() + treg.error_estimate(out.telemetry)).backward()
        results[fused] = (out.nfe, out.value.detach(), m.dense_1.weight.grad)
    assert fl.LAUNCHES == {"mlp_lanes_tsit5_fwd": 0, "mlp_lanes_tsit5_bwd": 0}
    for a, b in zip(results[True], results[False]):
        assert torch.equal(a, b)


def test_unported_parts_raise_not_implemented():
    """The vmap engine (``per_sample=True``, ``engine="vmap"``), pytree and
    3-D states, and ``mode="scan"`` raise naming ROADMAP."""
    f = lambda t, y, a: -y
    y0 = torch.ones(BATCH, DIM)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NeuralODE(MLPDynamics(DIM, HIDDEN, device="cpu"), per_sample=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        odeint_per_sample(f, y0, 0.0, 1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        odeint_per_sample(f, {"a": y0}, 0.0, 1.0, engine="batched")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        odeint_per_sample(f, torch.ones(BATCH, 2, 3), 0.0, 1.0, engine="batched")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        odeint_per_sample(f, y0, 0.0, 1.0, engine="batched", mode="scan")
    with pytest.raises(ValueError, match="engine"):
        odeint_per_sample(f, y0, 0.0, 1.0, engine="nope")
    with pytest.raises(ValueError, match="stage_sweep"):
        odeint_per_sample(f, y0, 0.0, 1.0, engine="batched", stage_sweep=f)
    with pytest.raises(ValueError, match="t1"):
        odeint_per_sample(f, y0, 0.0, torch.ones(3), engine="batched")
    with pytest.raises(ValueError, match="saveat"):
        odeint_per_sample(f, y0, 0.0, 1.0, engine="batched", saveat=torch.ones(3, 2))


@pytest.mark.parametrize("dynamics,fused", [("altmlp", True), ("mlp", "solve"),
                                            ("mlp", "tiled")])
def test_fused_per_sample_refusals(dynamics, fused):
    """``fused`` with ``per_sample`` needs MLPDynamics (JAX's ValueError);
    the port takes only ``True`` and ``"step"`` there (JAX also accepts
    ``"solve"``/``"tiled"``, a deliberate difference)."""
    m = (AlternatingMLP(6, 8, 1, device="cpu") if dynamics == "altmlp"
         else MLPDynamics(DIM, HIDDEN, device="cpu"))
    with pytest.raises(ValueError, match="MLPDynamics" if dynamics == "altmlp" else "fused"):
        NeuralODE(m, per_sample="batched", fused=fused, time_dep=dynamics == "mlp")


def test_steer_draws():
    """STEER from a ``torch.Generator``: ``t1`` in [t1 - b, t1 + b], one draw
    a lane, reproducible from the seed; the jittered grids keep their first
    point, stay sorted and in [lo, hi], and each point moves by at most half
    the gap to its predecessor (the arithmetic of JAX's ``steer_saveat`` on
    the same draws)."""
    g = lambda: torch.Generator().manual_seed(3)
    t0, t1 = treg.steer_tspan_per_sample(g(), 64, 0.0, 1.0, 0.5)
    assert t0.item() == 0.0 and t1.shape == (64,)
    assert ((t1 >= 0.5) & (t1 <= 1.5)).all() and t1.unique().numel() == 64
    assert torch.equal(t1, treg.steer_tspan_per_sample(g(), 64)[1])
    _, t1s = treg.steer_tspan(g(), 0.0, 1.0, 0.25)
    assert t1s.shape == () and 0.75 <= t1s.item() <= 1.25
    sa = torch.tensor(GRID)
    grids = treg.steer_saveat_per_sample(g(), sa, 16, 0.0, 1.0)
    assert grids.shape == (16, len(GRID))
    assert (grids[:, 0] == 0.0).all() and (grids[:, 1:] >= grids[:, :-1]).all()
    assert ((grids >= 0.0) & (grids <= 1.0)).all()
    gap = (sa[1:] - sa[:-1]) / 2 + 1e-6
    assert ((grids[:, 1:] - sa[1:]).abs() <= gap).all()
    one = treg.steer_saveat(g(), sa)
    assert one.shape == sa.shape and one[0] == 0.0


def test_per_lane_steer_t1_reaches_both_packages():
    """A per-lane STEER ``t1`` drawn by the port, fed to both packages: the
    same per-lane NFE and y1 (``_check_solutions``)."""
    A, x = _linear_problem()
    _, t1 = treg.steer_tspan_per_sample(torch.Generator().manual_seed(9), BATCH)
    kw = dict(rtol=TOL, atol=TOL, max_steps=MAX_STEPS)
    jsol = j_odeint_per_sample(lambda t, y, a: y @ a[0], jnp.asarray(x), 0.0,
                               jnp.asarray(t1.numpy()), (jnp.asarray(A),), engine="batched",
                               **kw)
    sol = odeint_per_sample(lambda t, y, a: y @ a[0], torch.tensor(x), 0.0, t1,
                            (torch.tensor(A),), engine="batched", **kw)
    _check_solutions(sol, jsol, None)
