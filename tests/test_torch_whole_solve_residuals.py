"""The MLPDynamics whole solve's streamed stage residuals in the port
(``fused_mlp._reference_normed_sweep_res``, ``_normed_bwd_math(res=)``, the
``ks``/``hs`` rows of ``whole_solve.SolveRecord``) against the port's own
replay and against the JAX package's ``make_normed_algebra_fwd_res``,
``_normed_bwd_math(res=)`` and ``whole_solve_odeint``.

The shapes are those of JAX's ``TestHandAlgebraBackward``
(``tests/test_whole_solve.py``): ``MLPDynamics(8, 6)``, batch 8,
rtol=atol=1e-4. JAX's whole solve runs in interpret mode, as its own
tests run it on the CPU. Inputs come from numpy's seeded generator; the
parameters of the end-to-end case from JAX's ``init``, handed to the port
through ``convert.py``'s layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.models import MLPDynamics as JMLP
from regneuralde_tpu.models import NeuralODE as JNODE
from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu.ops.pallas_solve import whole_solve_odeint as j_whole_solve_odeint
from regneuralde_tpu_torch.convert import _dense
from regneuralde_tpu_torch.models import AlternatingMLP, MLPDynamics, NeuralODE
from regneuralde_tpu_torch.ops import fused_generic as fg
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import ode
from regneuralde_tpu_torch.ops import whole_solve as ws
from regneuralde_tpu_torch.ops.controller import PIController

torch.set_num_threads(1)

DIM, HIDDEN, BATCH, TOL, MAX_STEPS = 8, 6, 8, 1e-4, 48
CTRL = PIController.for_order(5)
# (t, dt) of the single-step cases: an early step and one near t1
STEPS = [(0.15, 0.07), (0.9, 0.1)]


def _case(seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(HIDDEN, DIM + 1)) * scale / np.sqrt(DIM + 1)),
        b1=f32(rng.normal(size=HIDDEN) * 0.1),
        W2=f32(rng.normal(size=(DIM, HIDDEN + 1)) * scale / np.sqrt(HIDDEN + 1)),
        b2=f32(rng.normal(size=DIM) * 0.1),
        y=f32(rng.normal(size=(BATCH, DIM)) * 0.5),
        k1=f32(rng.normal(size=(BATCH, DIM)) * 0.3),
        ct_y_new=f32(rng.normal(size=(BATCH, DIM))),
        ct_k7=f32(rng.normal(size=(BATCH, DIM))),
    )


def _jax_parts(c):
    """JAX's split leaves ``(W1x, w1t, b1, W2h, w2t, b2)`` of the same
    weights (flax kernels are ``(in, out)``, the time row last)."""
    return jmlp._split_params({"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }})


def _parts(c):
    return fm._split_params(*(torch.tensor(c[k]) for k in ("W1", "b1", "W2", "b2")))


FWD_NAMES = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]


@pytest.mark.parametrize("step", STEPS)
def test_fwd_res_equals_plain_sweep_and_recompute(step):
    """(1) The residual-capturing sweep: its quintuple bitwise equal to
    ``_reference_normed_sweep``'s and its ``(ks, hs)`` to ``_recompute``'s;
    against JAX's ``make_normed_algebra_fwd_res`` on the same inputs at the
    tolerances of ``test_torch_fused_mlp.py``'s forward (rows and stages
    rtol 2e-5, the three sums rtol 1e-4, atol 5e-7: ATen's and XLA's exp
    differ by an ulp in about one argument in ten)."""
    c = _case()
    t, dt = step
    args = (torch.tensor(t), torch.tensor(dt), torch.tensor(c["y"]), torch.tensor(c["k1"]),
            _parts(c))
    outs, (ks, hs) = fm._reference_normed_sweep_res(*args, TOL, TOL)
    plain = fm._reference_normed_sweep(*args, TOL, TOL)
    want_ks, want_hs = fm._recompute(*args)
    assert len(ks) == 7 and len(hs) == 6
    for a, b in zip(outs, plain):
        assert torch.equal(a, b)
    for a, b in zip(ks + hs, want_ks + want_hs):
        assert torch.equal(a, b)

    j_outs, (j_ks, j_hs) = jmlp.make_normed_algebra_fwd_res(TOL, TOL)(
        jnp.float32(t), jnp.float32(dt), jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
        _jax_parts(c))
    for a, b, name in zip(outs, j_outs, FWD_NAMES):
        rtol = 2e-5 if name in ("y_new", "k7") else 1e-4
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=5e-7,
                                   err_msg=name)
    for j, (a, b) in enumerate(zip(ks + hs, list(j_ks) + list(j_hs))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=5e-7,
                                   err_msg=f"residual {j}")


SCALAR_CTS = (0.7, 1.3, -0.4)


def _flat_jax_grads(g):
    """(ct_t, ct_dt, ct_y, ct_k1, split parts) -> the port's layout."""
    ct_t, ct_dt, cy, ck1, (cw1x, cw1t, cb1, cw2h, cw2t, cb2) = g
    cw1 = np.concatenate([np.asarray(cw1x), np.asarray(cw1t)], 0).T
    cw2 = np.concatenate([np.asarray(cw2h), np.asarray(cw2t)], 0).T
    return [np.asarray(ct_t), np.asarray(ct_dt), np.asarray(cy), np.asarray(ck1),
            cw1, np.asarray(cb1).reshape(-1), cw2, np.asarray(cb2).reshape(-1)]


def _flat(g):
    ct_t, ct_dt, cy, ck1, leaves = g
    return [ct_t, ct_dt, cy, ck1, *leaves]


@pytest.mark.parametrize("step", STEPS)
def test_bwd_with_res_equals_recompute_and_matches_jax(step):
    """(2) ``_normed_bwd_math(res=)`` on the captured residuals bitwise
    equal to the call that recomputes them, and within
    ``test_torch_fused_mlp.py``'s backward tolerance (rtol 2e-2, atol 5e-4:
    the seeds multiply by 1/(atol + |y| rtol)) of JAX's
    ``_normed_bwd_math(res=)`` on JAX's own residuals."""
    c = _case(seed=1)
    t, dt = step
    args = (torch.tensor(t), torch.tensor(dt), torch.tensor(c["y"]), torch.tensor(c["k1"]),
            _parts(c))
    cts = (torch.tensor(c["ct_y_new"]), torch.tensor(c["ct_k7"]),
           *(torch.tensor(s) for s in SCALAR_CTS))
    _, res = fm._reference_normed_sweep_res(*args, TOL, TOL)
    got = _flat(fm._normed_bwd_math(*args, cts, TOL, TOL, res=res))
    replay = _flat(fm._normed_bwd_math(*args, cts, TOL, TOL))
    for a, b in zip(got, replay):
        assert torch.equal(a, b)

    jargs = (jnp.float32(t), jnp.float32(dt), jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
             _jax_parts(c))
    _, j_res = jmlp.make_normed_algebra_fwd_res(TOL, TOL)(*jargs)
    j_cts = (jnp.asarray(c["ct_y_new"]), jnp.asarray(c["ct_k7"]),
             *(jnp.float32(s) for s in SCALAR_CTS))
    want = _flat_jax_grads(jmlp._normed_bwd_math(*jargs, j_cts, TOL, TOL, res=j_res))
    names = ["t", "dt", "y", "k1", "W1", "b1", "W2", "b2"]
    for a, b, name in zip(got, want, names):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-2, atol=5e-4, err_msg=name)


def _solve(tspan, saveat=None, seed=2, scale=3.0, whole_span_first=False):
    """The plain whole solve's record over seeded weights at ``scale``
    times LeCun's (which lifts the error estimate off its float32 floor);
    with ``whole_span_first`` its first trial step tries the whole span
    and is rejected."""
    c = _case(seed, scale)
    leaves = [torch.tensor(c[k]) for k in ("W1", "b1", "W2", "b2")]
    y0 = torch.tensor(c["y"])
    parts = fm._split_params(*leaves)
    func = lambda t, y, _: fm._mlp_k(y, t, parts)[0]
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, *tspan, (), TOL, TOL)
    if whole_span_first:
        dt0 = t1 - t0
    kw = {}
    if saveat is not None:
        kw = dict(zip(("saveat", "ys_init"), ode.saveat_rows(torch.tensor(saveat), t0, t1, y0)))
    args = (t0, t1, dt0, y0, f0, leaves, TOL, TOL, CTRL, MAX_STEPS)
    rec = ws.whole_solve_fwd(*args, **kw)
    return rec, int(rec.final[3:5].sum().item()), args, kw


SAVES = {(0.0, 1.0): [0.25, 0.5, 0.75, 1.0], (1.0, 0.0): [0.75, 0.5, 0.25, 0.0]}


@pytest.mark.parametrize("saves", [False, True])
@pytest.mark.parametrize("tspan", [(0.0, 1.0), (1.0, 0.0)])
def test_streamed_backward_equals_replay(tspan, saves):
    """(3) The plain reverse walk fed the record's residuals against the
    walk that replays the stages, on the same record and cotangents (y1,
    the telemetry and, with 4 saves, the saves): every output bitwise."""
    rec, ns, args, kw = _solve(tspan, SAVES[tspan] if saves else None)
    assert ns > 2 and rec.final[5].item() == 1.0
    rng = np.random.default_rng(3)
    f32 = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))
    bkw = dict(saveat=kw.get("saveat"), ct_ys=f32(*rec.ys.shape) if saves else None)
    rest = (f32(BATCH, DIM), f32(4, MAX_STEPS) * 0.1, args[0], args[1], args[5], TOL, TOL,
            CTRL)
    streamed = ws.whole_solve_bwd(rec, ns, *rest, **bkw)
    replay = ws.whole_solve_bwd(rec, ns, *rest, **bkw, cache_residuals=False)
    assert len(streamed) == 10
    for a, b in zip(streamed, replay):
        assert torch.equal(a, b)
    # the same record without the stream: the same steps, and a streamed
    # backward refuses it rather than replaying
    bare = ws.whole_solve_fwd(*args, **kw, cache_residuals=False)
    assert bare.ks.numel() == 0 and bare.hs.numel() == 0
    for name in ("y1", "hy", "hf", "streams", "final", "ys"):
        assert torch.equal(getattr(bare, name), getattr(rec, name)), name
    with pytest.raises(ValueError, match="stage residuals"):
        ws.whole_solve_bwd(bare, ns, *rest, **bkw)


@pytest.mark.parametrize("tspan", [(0.0, 1.0), (1.0, 0.0)])
def test_record_rows_are_the_plain_capture(tspan):
    """(4) Row ``i < ns`` of the record's ``ks``/``hs`` is the plain capture
    on trial step ``i``'s own stored inputs (``t``, ``dt_eff``, ``hy[i]``,
    ``hf[i]``), rejected steps included, bitwise; later rows are zero."""
    rec, ns, args, _ = _solve(tspan, seed=4, whole_span_first=True)
    st = rec.streams
    assert st[ws.ST_ACC, 0] == 0.0 and rec.final[5].item() == 1.0
    assert rec.ks.shape == (MAX_STEPS, 6, BATCH, DIM)
    assert rec.hs.shape == (MAX_STEPS, 6, BATCH, HIDDEN)
    t1, tdir = args[1], torch.sign(args[1] - args[0])
    parts = fm._split_params(*args[5])
    for i in range(ns):
        t, dt = st[ws.ST_T, i], st[ws.ST_DT, i]
        dt_eff = torch.where((dt - (t1 - t)) * tdir >= 0, t1 - t, dt)
        _, (ks, hs) = fm._reference_normed_sweep_res(t, dt_eff, rec.hy[i], rec.hf[i], parts,
                                                     TOL, TOL)
        assert torch.equal(rec.ks[i], torch.stack(ks[1:])), i
        assert torch.equal(rec.hs[i], torch.stack(hs)), i
    assert not rec.ks[ns:].any() and not rec.hs[ns:].any()


def test_only_mlp_dynamics_streams():
    """AlternatingMLP's whole solve has no hand pullback that takes the
    residuals (JAX's ``_whole_solve_parts`` gives it none): its record
    holds none, and its backward replays with ``cache_residuals`` on or
    off, bitwise alike."""
    gen = torch.Generator().manual_seed(6)
    leaves = [p.detach() for p in AlternatingMLP(DIM, HIDDEN, 2, device="cpu",
                                                 generator=gen).parameters()]
    y0 = torch.rand(BATCH, DIM, generator=gen)
    func = fg.alternating_mlp_apply(2)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, tuple(leaves), TOL, TOL)
    args = (t0, t1, dt0, y0, f0, leaves, TOL, TOL, CTRL, MAX_STEPS)
    rec = ws.whole_solve_fwd(*args, dynamics="altmlp")
    assert rec.ks.numel() == 0 and rec.hs.numel() == 0
    ns = int(rec.final[3:5].sum().item())
    rest = (torch.randn(BATCH, DIM, generator=gen), torch.zeros(4, MAX_STEPS), t0, t1,
            leaves, TOL, TOL, CTRL)
    on = ws.whole_solve_bwd(rec, ns, *rest, dynamics="altmlp")
    off = ws.whole_solve_bwd(rec, ns, *rest, dynamics="altmlp", cache_residuals=False)
    assert all(torch.equal(a, b) for a, b in zip(on, off))


# ---------------------------------------------------------------------------
# (5) the port's whole-solve gradient against JAX's whole_solve_odeint
# ---------------------------------------------------------------------------

REG_WEIGHTS = [0.0, 0.3]
AFR = ["res", "none"]  # JAX's algebra_fwd_res: the stream on, or off


def _jax_loss(node, afr):
    apply_fn, flatten, alg_bwd, alg_fwd_res = node._whole_solve_parts(None)

    def loss(p, x, w):
        sol = j_whole_solve_odeint(
            node._func, apply_fn, flatten, x, 0.0, 1.0, p, rtol=TOL, atol=TOL,
            max_steps=MAX_STEPS, algebra_bwd=alg_bwd,
            algebra_fwd_res=alg_fwd_res if afr == "res" else None)
        tel = sol.telemetry
        r = jnp.sum(jnp.where(tel.accepted, tel.eest * tel.dt, 0.0))
        return jnp.sum(sol.y1 ** 2) + w * r, (sol.y1, sol.stats.nfe, tel.accepted)
    return loss


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ``whole_solve_odeint`` on ``MLPDynamics(8, 6)``, with and
    without ``algebra_fwd_res``: one jit per case, both loss weights."""
    x = np.random.default_rng(5).normal(size=(BATCH, DIM)).astype(np.float32) * 0.5
    node = JNODE(JMLP(dim=DIM, hidden=HIDDEN), rtol=TOL, atol=TOL, max_steps=MAX_STEPS,
                 fused="solve")
    params = jax.jit(node.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    runs = {}
    for afr in AFR:
        fn = jax.jit(jax.value_and_grad(_jax_loss(node, afr), has_aux=True))
        for w in REG_WEIGHTS:
            (loss, (y1, nfe, acc)), g = fn(params, jnp.asarray(x), jnp.float32(w))
            g = g["params"]
            runs[afr, w] = dict(
                loss=float(loss), y1=np.asarray(y1), nfe=int(nfe), accepted=np.asarray(acc),
                grads=[np.asarray(g["dense_1"]["kernel"]).T, np.asarray(g["dense_1"]["bias"]),
                       np.asarray(g["dense_2"]["kernel"]).T, np.asarray(g["dense_2"]["bias"])])
    return x, jax.tree_util.tree_map(np.asarray, params), runs


# The tolerances of test_torch_whole_solve.py::test_whole_solve_matches_jax_engine.
NOISE_FLOOR = 5e-2


@pytest.mark.parametrize("reg_weight", REG_WEIGHTS)
@pytest.mark.parametrize("afr", AFR)
def test_streamed_gradient_matches_jax_whole_solve(jax_runs, afr, reg_weight):
    """(5) The port's ``NeuralODE(fused="solve")`` (the stream on, plain
    versions on the CPU) against JAX's ``whole_solve_odeint`` with its
    stream on (``algebra_fwd_res``) and off: the same NFE and accept
    sequence, y1 at rtol 1e-5/atol 1e-6; with ``sum(y1^2)`` alone the loss
    at rtol 1e-5 and the gradients at rtol 2e-3/atol 1e-5; with ``0.3 *
    sum(eest * dt)`` over the accepted steps added, the loss at rtol 5e-4
    and each gradient within NOISE_FLOOR (relative Frobenius)."""
    x, params, runs = jax_runs
    run = runs[afr, reg_weight]
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, device="cpu"), rtol=TOL, atol=TOL,
                     max_steps=MAX_STEPS, fused="solve")
    p = params["params"]
    node.load_state_dict({**_dense(p["dense_1"], "dynamics.dense_1"),
                          **_dense(p["dense_2"], "dynamics.dense_2")})
    calls = []
    real = ws.plain_whole_solve_bwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ws, "plain_whole_solve_bwd",
                   lambda *a, **k: calls.append(k["cache_residuals"]) or real(*a, **k))
        out = node(torch.from_numpy(x))
        tel = out.telemetry
        loss = (out.value.square().sum()
                + reg_weight * torch.where(tel.accepted, tel.eest * tel.dt, 0.0).sum())
        loss.backward()
    assert calls == [True]
    assert out.nfe == run["nfe"]
    np.testing.assert_array_equal(tel.accepted.numpy(), run["accepted"])
    np.testing.assert_allclose(out.value.detach().numpy(), run["y1"], rtol=1e-5, atol=1e-6)
    grads = [q.grad.numpy() for q in node.parameters()]
    names = ["W1", "b1", "W2", "b2"]
    if reg_weight == 0.0:
        np.testing.assert_allclose(loss.item(), run["loss"], rtol=1e-5)
        for name, a, b in zip(names, grads, run["grads"]):
            np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-5, err_msg=name)
    else:
        np.testing.assert_allclose(loss.item(), run["loss"], rtol=5e-4)
        for name, a, b in zip(names, grads, run["grads"]):
            assert np.linalg.norm(a - b) <= NOISE_FLOOR * np.linalg.norm(b), name
