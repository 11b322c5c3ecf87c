"""The port's whole solve (regneuralde_tpu_torch.ops.whole_solve, the plain
versions of K3/K4 on the CPU) against the JAX package's whole-solve
engines and against the port's own fast adjoint.

The JAX side runs ``NeuralODE(fused=True)`` (``whole_solve_odeint``, K3/K4)
and ``NeuralODE(fused="tiled")`` (``whole_solve_odeint_tiled``, K5/K6) in
interpret mode, as its own tests run them on the CPU. Both packages get
the same numpy inputs and the same parameters (``convert.py``).
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
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.convert import classifier_node_state_dict
from regneuralde_tpu_torch.models import ClassifierNODE, MLPDynamics, NeuralODE
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import ode as tode
from regneuralde_tpu_torch.ops import whole_solve as ws
from regneuralde_tpu_torch.ops.controller import PIController

torch.set_num_threads(1)

DIM, HIDDEN, TOL, MAX_STEPS = 16, 12, 1e-4, 48
CTRL = PIController.for_order(5)

# ---------------------------------------------------------------------------
# (a) the hand pullback of the scalar chain
# ---------------------------------------------------------------------------

# (t, dt, t1, e, n, d, qold, t0): with count 4, eest = sqrt(e) / 2.
POST_CASES = {
    "accept": (0.2, 0.01, 1.0, 1.0, 0.3, 0.2, 1e-4, 0.0),
    "deadband": (0.2, 0.01, 1.0, 2.0, 0.3, 0.2, 0.5, 0.0),
    "qmax_clamp_and_eest_floor": (0.2, 0.01, 1.0, 1e-30, 0.3, 0.2, 1.0, 0.0),
    "accept_qmin_clamp": (0.2, 0.01, 1.0, 3.6, 0.3, 0.2, 1e-10, 0.0),
    "reject": (0.2, 0.01, 1.0, 4e6, 0.3, 0.2, 1e-4, 0.0),
    "reject_qmin_clamp": (0.2, 0.01, 1.0, 1e10, 0.3, 0.2, 1e-4, 0.0),
    "zero_sums": (0.2, 0.01, 1.0, 0.0, 0.0, 0.0, 0.3, 0.0),
    "is_last": (0.9, 0.3, 1.0, 1.0, 0.3, 0.2, 1e-4, 0.0),
    "span_clamp": (0.0, 0.2, 1.0, 1e-30, 0.3, 0.2, 1.0, 0.0),
    # last step in the deadband: dt_next == dt_eff == span, a tie
    "span_tie": (0.0, 0.25, 0.25, 2.0, 0.3, 0.2, 0.5, 0.0),
    "reverse_time": (0.6, -0.1, 0.0, 1.0, 0.3, 0.2, 1e-4, 1.0),
}


@pytest.mark.parametrize("case", sorted(POST_CASES))
def test_post_bwd_matches_autograd(case):
    """``ode.post_bwd`` against ``torch.autograd`` of ``ode._post`` in
    float64, every output seeded: rtol 1e-12 (the same algebra, so only
    the summation order of autograd's accumulation differs)."""
    t, dt, t1, e, n, d, qold, t0 = POST_CASES[case]
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    t, dt, t1, t0, qold = map(f64, (t, dt, t1, t0, qold))
    tdir = torch.sign(t1 - t0)
    span = torch.abs(t1 - t0)
    remaining = t1 - t
    is_last = (dt - remaining) * tdir >= 0
    dt_eff = torch.where(is_last, remaining, dt)
    prims = [x.clone().requires_grad_(True)
             for x in (t, dt_eff, qold, f64(e), f64(n), f64(d), t1, span)]
    outs = tode._post(CTRL, 4.0, *prims, is_last)
    seeds = [f64(v) for v in np.random.default_rng(len(case)).normal(size=6)]
    want = torch.autograd.grad(outs, prims, grad_outputs=seeds, allow_unused=True)
    accept = outs[4] <= 1.0
    got = tode.post_bwd(CTRL, 4.0, *(p.detach() for p in prims), is_last, accept, seeds)
    if case == "span_tie":
        assert outs[1].item() == span.item()
    for name, g, w in zip(["t", "dt_eff", "qold", "e", "n", "d", "t1", "span"], got, want):
        w = torch.zeros_like(g) if w is None else w
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-12, atol=0, err_msg=name)


# ---------------------------------------------------------------------------
# (b), (c) the slice against the JAX whole-solve engines
# ---------------------------------------------------------------------------


def _batch(batch, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (batch, DIM)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)]
    return x, y


def _jax_loss(clf, reg_weight):
    def loss(params, x, y):
        out = clf(params, x)
        ce = optax.softmax_cross_entropy(out.logits, y).mean()
        return ce + reg_weight * jreg.error_estimate(out.telemetry, "mean"), out
    return loss


def _torch_loss(clf, x, y, reg_weight):
    out = clf(x)
    ce = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1).mean()
    return ce + reg_weight * treg.error_estimate(out.telemetry, "mean"), out


def _jax_flat(tree):
    d, p = tree["de"]["params"], tree["post"]["params"]
    return [np.asarray(a) for a in (
        d["dense_1"]["kernel"], d["dense_1"]["bias"], d["dense_2"]["kernel"],
        d["dense_2"]["bias"], p["kernel"], p["bias"])]


def _torch_grads_in_jax_layout(clf):
    g = [p.grad.numpy() for p in clf.parameters()]
    return [g[0].T, g[1], g[2].T, g[3], g[4].T, g[5]]


ENGINES = {True: 8, "tiled": 128}  # fused option -> batch
REG_WEIGHTS = [0.0, 100.0]


@pytest.fixture(scope="module")
def jax_runs():
    """For each JAX whole-solve engine and loss: the parameters, the loss,
    logits, NFE, telemetry and gradients of one value-and-grad."""
    runs = {}
    for fused, batch in ENGINES.items():
        node = JNODE(JMLP(dim=DIM, hidden=HIDDEN), rtol=TOL, atol=TOL,
                     max_steps=MAX_STEPS, fused=fused)
        clf = JClassifier(None, node, fnn.Dense(10))
        x, y = _batch(batch)
        params = jax.jit(clf.init)(jax.random.PRNGKey(2), jnp.asarray(x))
        y1 = np.asarray(jax.jit(lambda p, v: node(p, v).value)(
            params["de"], jnp.asarray(x)))
        for w in REG_WEIGHTS:
            grad_fn = jax.jit(jax.value_and_grad(_jax_loss(clf, w), has_aux=True))
            (loss, out), grads = grad_fn(params, jnp.asarray(x), jnp.asarray(y))
            tel = out.telemetry
            runs[fused, w] = dict(
                params=jax.tree_util.tree_map(np.asarray, params), y1=y1,
                loss=float(loss),
                logits=np.asarray(out.logits), nfe=int(out.nfe),
                accepted=np.asarray(tel.accepted), live=np.asarray(tel.live),
                tel=[np.asarray(a) for a in (tel.t, tel.dt, tel.eest, tel.eigen_est)],
                grads=_jax_flat(grads))
    return runs


# At rtol=atol=1e-4 this model's embedded error estimate sits at its float32
# rounding floor (tests/test_torch_slice.py): ATen's and XLA's exp differ by
# an ulp in about one argument in ten. So eest, the regularized loss and its
# gradients are held to bounds at that floor; the cross-entropy and the
# step times to the JAX package's own tolerances.
NOISE_FLOOR = 5e-2


@pytest.mark.parametrize("reg_weight", REG_WEIGHTS)
@pytest.mark.parametrize("fused", list(ENGINES))
def test_whole_solve_matches_jax_engine(jax_runs, fused, reg_weight):
    """The port's ``fused=True`` against JAX ``fused=True`` (K3/K4) at batch
    8, and the port's ``fused="tiled"`` against JAX ``fused="tiled"``
    (K5/K6) at batch 128: the same NFE, accept sequence and live mask;
    y1 and the logits at rtol 1e-5/atol 1e-6; the telemetry streams within
    NOISE_FLOOR (relative Frobenius; eigen_est before the last step): eest
    at its rounding floor moves the controller's next dt by about 0.3%
    here, and JAX's own step and unfused routes differ by as much.
    Cross-entropy:
    loss at rtol 1e-5, gradients at rtol 2e-3/atol 1e-5 (the JAX
    package's fast-adjoint tolerance, tests/test_pallas_fused.py:316-317).
    CE + 100 * error_estimate: loss at rtol 5e-4, each gradient leaf
    within NOISE_FLOOR (relative Frobenius)."""
    run = jax_runs[fused, reg_weight]
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, device="cpu"), rtol=TOL, atol=TOL,
                     max_steps=MAX_STEPS, fused=fused)
    clf = ClassifierNODE(None, node, torch.nn.Linear(DIM, 10))
    clf.load_state_dict(classifier_node_state_dict(run["params"]))
    x, y = (torch.from_numpy(a) for a in _batch(ENGINES[fused]))
    ws.reset_launches()
    loss, out = _torch_loss(clf, x, y, reg_weight)
    loss.backward()
    assert ws.LAUNCHES == {k: 0 for k in ws.LAUNCHES} and len(ws.LAUNCHES) == 6
    assert out.success
    assert out.nfe == run["nfe"]
    tel = out.telemetry
    np.testing.assert_array_equal(tel.accepted.numpy(), run["accepted"])
    np.testing.assert_array_equal(tel.live.numpy(), run["live"])
    np.testing.assert_allclose(out.logits.detach().numpy(), run["logits"],
                               rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        np.testing.assert_allclose(clf.node(x).value.numpy(), run["y1"], rtol=1e-5,
                                   atol=1e-6)
    got_tel = [a.detach().numpy() for a in (tel.t, tel.dt, tel.eest, tel.eigen_est)]
    # The last trial step is a short one onto t1 (dt about 1e-2 here), where
    # both norms of the stiffness estimate sit at their rounding floor too.
    ns = int(run["live"].sum())
    got_tel[3], run_eig = got_tel[3][:ns - 1], run["tel"][3][:ns - 1]
    for name, a, b in zip(["t", "dt", "eest", "eigen_est"], got_tel,
                          [*run["tel"][:3], run_eig]):
        assert np.linalg.norm(a - b) <= NOISE_FLOOR * np.linalg.norm(b), name
    grads = _torch_grads_in_jax_layout(clf)
    names = ["W1", "b1", "W2", "b2", "post_W", "post_b"]
    if reg_weight == 0.0:
        np.testing.assert_allclose(loss.item(), run["loss"], rtol=1e-5)
        for name, a, b in zip(names, grads, run["grads"]):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(loss.item(), run["loss"], rtol=5e-4)
        for name, a, b in zip(names, grads, run["grads"]):
            assert np.linalg.norm(a - b) <= NOISE_FLOOR * np.linalg.norm(b), name


# ---------------------------------------------------------------------------
# (d) the plain whole solve against the fast adjoint, float64
# ---------------------------------------------------------------------------


def _node_run(fused, tspan, batch=8, dtype=torch.float64, seed=0, max_steps=MAX_STEPS):
    gen = torch.Generator().manual_seed(seed)
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, generator=gen, device="cpu"), rtol=TOL, atol=TOL,
                     max_steps=max_steps, fused=fused).to(dtype)
    with torch.no_grad():  # biases off zero, so every leaf matters
        for p in node.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=dtype))
    x = torch.from_numpy(_batch(batch, seed)[0]).to(dtype)
    out = node(x, tspan=tspan)
    tel = out.telemetry
    loss = (out.value.square().sum()
            + 100.0 * (tel.eest * tel.dt * tel.accepted).sum()
            + (tel.eigen_est * tel.accepted).sum() + tel.t.sum())
    grads = torch.autograd.grad(loss, list(node.parameters()))
    return out, grads


@pytest.mark.parametrize("tspan", [(0.0, 1.0), (1.0, 0.0)])
def test_plain_whole_solve_matches_fast_adjoint_float64(tspan):
    """The same math as ``ode.FastAdjointSolve`` over the plain sweeps (the
    forward shares its loop; the backward trades autograd of the scalar
    chain for ``post_bwd``): value, telemetry and the gradients of a loss
    that seeds every output (y1, eest, dt, eigen_est, t) at rtol 1e-9."""
    a, ga = _node_run(True, tspan)
    b, gb = _node_run(False, tspan)
    assert a.nfe == b.nfe and a.solution.stats == b.solution.stats
    assert torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    for x, y in zip([a.value, *a.telemetry[:4]], [b.value, *b.telemetry[:4]]):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=0)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("tspan, max_steps", [((0.0, 1.0), 2), ((0.5, 0.5), MAX_STEPS)])
def test_plain_whole_solve_edge_cases(tspan, max_steps):
    """A solve cut short by max_steps (success False) and one over an empty
    span (no trial step): the same as the fast adjoint, rtol 1e-9. Over an
    empty span the prologue's initial step divides by the zero span, so
    the gradients are NaN on both routes, as in the JAX package."""
    a, ga = _node_run(True, tspan, max_steps=max_steps)
    b, gb = _node_run(False, tspan, max_steps=max_steps)
    assert a.solution.stats == b.solution.stats
    assert a.solution.stats.success == (tspan[0] == tspan[1])
    torch.testing.assert_close(a.value, b.value, rtol=1e-9, atol=0)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-12, equal_nan=True)


def test_plain_whole_solve_record():
    """The forward record: streams past the last trial step are zero, the
    history holds each step's start state, and ``final`` the step counts
    and the loop's last (t, dt, qold). The stage residuals ``ks``/``hs``
    have ``max_steps`` rows, zero past the last trial step, and row ``i``
    holds trial step ``i``'s six stages of the plain sweep."""
    gen = torch.Generator().manual_seed(0)
    leaves = [p.detach() for p in MLPDynamics(DIM, HIDDEN, generator=gen, device="cpu").parameters()]
    y0 = torch.from_numpy(_batch(4)[0])
    f0 = torch.zeros_like(y0)
    t0, t1, dt0 = torch.tensor(0.0), torch.tensor(1.0), torch.tensor(0.05)
    rec = ws.whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, TOL, TOL, CTRL, MAX_STEPS)
    t_f, dt_f, qold_f, na, nr, done = rec.final.tolist()
    ns = int(na + nr)
    assert done == 1.0 and 0 < ns < MAX_STEPS and t_f == 1.0
    st = rec.streams
    assert torch.all(st[:, ns:] == 0)
    assert st[ws.ST_T, 0] == 0.0 and st[ws.ST_DT, 0] == dt0
    assert st[ws.ST_QOLD, 0] == CTRL.qoldinit
    assert int(st[ws.ST_ACC, :ns].sum()) == na
    assert torch.equal(rec.hy[0], y0) and torch.equal(rec.hy[ns], rec.y1)
    # an accepted step's end is the next step's start
    acc = st[ws.ST_ACC, :ns - 1] > 0.5
    torch.testing.assert_close(st[ws.ST_T, 1:ns][acc], st[ws.TEL_T, :ns - 1][acc],
                               rtol=0, atol=0)
    assert dt_f > 0 and qold_f > 0
    assert rec.ks.shape == (MAX_STEPS, 6, 4, DIM) and rec.hs.shape == (MAX_STEPS, 6, 4, HIDDEN)
    assert not rec.ks[ns:].any() and not rec.hs[ns:].any()
    for i in (0, ns - 1):
        _, (ks, hs) = fm._reference_normed_sweep_res(
            st[ws.ST_T, i], st[ws.TEL_DT, i], rec.hy[i], rec.hf[i],
            fm._split_params(*leaves), TOL, TOL)
        assert torch.equal(rec.ks[i], torch.stack(ks[1:]))
        assert torch.equal(rec.hs[i], torch.stack(hs))


# ---------------------------------------------------------------------------
# (e) routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, "solve", "tiled"])
def test_whole_solve_options_route_to_whole_solve(fused, monkeypatch):
    """``fused=True``, ``"solve"`` and ``"tiled"`` reach
    ``whole_solve_odeint`` in ``mode="adjoint"`` and the step route in
    ``mode="while"``, as in the JAX layer; no kernel launches on the CPU."""
    calls = []
    real_ws, real_step = ws.whole_solve_odeint, fm.mlp_dynamics_normed_sweep
    monkeypatch.setattr(ws, "whole_solve_odeint",
                        lambda *a, **k: calls.append("whole") or real_ws(*a, **k))
    monkeypatch.setattr(fm, "mlp_dynamics_normed_sweep",
                        lambda *a, **k: calls.append("step") or real_step(*a, **k))
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, device="cpu"), rtol=TOL, atol=TOL,
                     max_steps=MAX_STEPS, fused=fused)
    x = torch.from_numpy(_batch(8)[0])
    ws.reset_launches()
    fm.reset_launches()
    node(x)
    assert calls == ["whole"]
    calls.clear()
    out = node(x, mode="while")
    assert out.solution.stats.success
    assert set(calls) == {"step"}
    assert ws.LAUNCHES == {k: 0 for k in ws.LAUNCHES} and len(ws.LAUNCHES) == 6
    assert fm.LAUNCHES == {k: 0 for k in fm.LAUNCHES} and len(fm.LAUNCHES) == 4


def test_tiled_takes_any_batch():
    """The Hopper kernels mask a ragged row tile, so ``fused="tiled"`` has
    no ``batch % tile_rows`` limit: at batch 13 it matches ``fused=False``
    (rtol 1e-9 in float64)."""
    a, ga = _node_run("tiled", (0.0, 1.0), batch=13)
    b, gb = _node_run(False, (0.0, 1.0), batch=13)
    assert a.nfe == b.nfe
    torch.testing.assert_close(a.value, b.value, rtol=1e-9, atol=0)
    for x, y in zip(ga, gb):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("fused", [False, "step", True, "solve", "tiled"])
def test_saveat_raises_not_implemented(fused, monkeypatch):
    """``saveat`` gives the trajectory, ``(batch, time, feat)``, ending in
    y1: on the step routes, and on ``fused=True``/``"solve"`` through the
    whole-solve wrappers (K3's save cursor, K4's Hermite pullback), in one
    forward and one backward call. ``fused="tiled"`` with ``saveat``
    raises ``ValueError`` with JAX's message; no option raises
    ``NotImplementedError`` or is remapped to another route."""
    calls = []
    for name in ("whole_solve_fwd", "whole_solve_bwd"):
        real = getattr(ws, name)
        monkeypatch.setattr(ws, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, device="cpu"), fused=fused)
    x = torch.zeros(2, DIM, requires_grad=True)
    if fused == "tiled":
        with pytest.raises(ValueError, match="final-state solves only"):
            node(x, saveat=torch.tensor([0.5, 1.0]))
        return
    out = node(x, saveat=torch.tensor([0.5, 1.0]))
    assert out.value.shape == (2, 2, DIM) and out.solution.stats.success
    assert torch.equal(out.value[:, -1], out.solution.y1)
    out.value.sum().backward()
    whole = fused in (True, "solve")
    assert calls == (["whole_solve_fwd", "whole_solve_bwd"] if whole else [])
