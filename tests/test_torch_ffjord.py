"""The port's FFJORD (regneuralde_tpu_torch.models.FFJORD) against the JAX
package's (regneuralde_tpu.models.FFJORD), and the pieces of its training
step: ``load_miniboone``, ``reg.exp_decay_schedule``, WeightDecay then Adam,
``convert.ffjord_state_dict`` and ``utils.loglikelihood``.

The routes are held to JAX's same routes at ``tests/test_whole_solve.py``'s
FFJORD size (``CSLDynamics(dim=3, hidden=8)``, batch 8, rtol=atol=1e-4,
max_steps=48): the port's ``fused=False`` to JAX's fast adjoint,
``"step"`` to JAX's interpret-mode K7/K8-CSL, ``True`` (on the CPU the
plain versions of K3/K4-CSL) to JAX's ``fused="solve"``, the whole-solve
kernels in interpret mode. Both packages get the same numpy parameters and
the same Hutchinson probe.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.models import MLP as JMLP
from regneuralde_tpu.models import CSLDynamics as JCSL
from regneuralde_tpu.models import FFJORD as JFFJORD
from regneuralde_tpu_torch import convert
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.models import MLP, FFJORD, CSLDynamics
from regneuralde_tpu_torch.ops import fused_csl as fc
from regneuralde_tpu_torch.ops import whole_solve as ws

from test_torch_fused_csl import _jax_grads_in_torch_layout, csl_params

torch.set_num_threads(1)

BATCH, DIM, HIDDEN = 8, 3, 8
TOL, MAX_STEPS = 1e-4, 48
REG = 0.1
# the port's route -> JAX's
ROUTES = {False: False, "step": "step", True: "solve"}


def _inputs(seed=0):
    rng = np.random.default_rng(seed + 7)
    f32 = lambda a: np.asarray(a, np.float32)
    return (csl_params(DIM, HIDDEN, seed), f32(rng.normal(size=(BATCH, DIM)) * 0.5),
            f32(rng.normal(size=(BATCH, DIM))))


def _jax_ffjord(fused, **kw):
    return JFFJORD(JCSL(dim=DIM, hidden=HIDDEN), input_dim=DIM, rtol=TOL, atol=TOL,
                   max_steps=MAX_STEPS, analytic_vjp=True, fused=fused, **kw)


def _torch_ffjord(params, fused, dtype=torch.float32, **kw):
    ff = FFJORD(CSLDynamics(DIM, HIDDEN, device="cpu"), input_dim=DIM, rtol=TOL, atol=TOL,
                max_steps=MAX_STEPS, fused=fused, **kw)
    ff.load_state_dict(convert.ffjord_state_dict(params))
    return ff.to(dtype)


@pytest.fixture(scope="module")
def jax_runs():
    """Per JAX route and kinetic flag: NFE, accept sequence, logpx, the
    kinetic terms, eest, and the gradients of -mean(logpx) + 0.1 *
    error_estimate."""
    params, x, e = _inputs()
    key = jax.random.PRNGKey(2)
    runs = {}
    for route, jroute in ROUTES.items():
        for kinetic in ((False, True) if route is not True else (False,)):
            ff = _jax_ffjord(jroute)

            def loss(p, ff=ff, kinetic=kinetic):
                out = ff(p, jnp.asarray(x), key, kinetic_reg=kinetic, e=jnp.asarray(e))
                return (-jnp.mean(out.logpx)
                        + REG * jreg.error_estimate(out.telemetry, agg="mean"), out)

            (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
            tel = out.telemetry
            runs[route, kinetic] = dict(
                nfe=int(out.nfe), accepted=np.asarray(tel.accepted),
                live=np.asarray(tel.live), logpx=np.asarray(out.logpx),
                kinetic=np.asarray(out.kinetic), jacobian=np.asarray(out.jacobian),
                eest=np.asarray(tel.eest), grads=_jax_grads_in_torch_layout(g),
                success=bool(out.solution.stats.success))
    return params, x, e, runs


def _torch_run(params, x, e, route, kinetic=False, dtype=torch.float32):
    ff = _torch_ffjord(params, route, dtype)
    out = ff(torch.tensor(x, dtype=dtype), e=torch.tensor(e, dtype=dtype),
             kinetic_reg=kinetic)
    loss = -out.logpx.mean() + REG * treg.error_estimate(out.telemetry, "mean")
    grads = torch.autograd.grad(loss, list(ff.parameters()))
    return out, [g.numpy() for g in grads]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("route, kinetic", [(False, False), (False, True), ("step", False),
                                            ("step", True), (True, False)])
def test_routes_match_jax(jax_runs, route, kinetic):
    """Each route against JAX's same route: the same NFE, accept sequence
    and live mask; logpx (and the kinetic terms) at rtol=1e-4, atol=1e-5
    (JAX's own bound between its routes, tests/test_pallas_generic.py);
    each parameter's gradient of -mean(logpx) + 0.1 * error_estimate within
    2e-2 relative (Frobenius): the error estimate sits near its float32
    rounding floor at this size, where ATen's and XLA's exp and log1p
    differ by ulps (JAX holds its fused and unfused gradients to rtol=2e-2,
    atol=5e-4)."""
    params, x, e, runs = jax_runs
    run = runs[route, kinetic]
    ws.reset_launches()
    fc.reset_launches()
    out, grads = _torch_run(params, x, e, route, kinetic)
    assert out.nfe == run["nfe"] and out.solution.stats.success == run["success"]
    np.testing.assert_array_equal(out.telemetry.accepted.numpy(), run["accepted"])
    np.testing.assert_array_equal(out.telemetry.live.numpy(), run["live"])
    np.testing.assert_allclose(out.logpx.detach().numpy(), run["logpx"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.kinetic.detach().numpy(), run["kinetic"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out.jacobian.detach().numpy(), run["jacobian"], rtol=1e-4,
                               atol=1e-5)
    assert out.kinetic.any() == kinetic
    for j, (a, b) in enumerate(zip(grads, run["grads"])):
        assert _rel(a, b) <= 2e-2, (j, _rel(a, b))
    # on the CPU no kernel is launched: the wrappers take the plain versions
    assert not any(fc.LAUNCHES.values()) and not any(ws.LAUNCHES.values())


def test_routes_agree_with_each_other(jax_runs):
    """The three routes run the same trial-step algebra (the kernels' plain
    versions on the CPU), so they take the same steps and agree bitwise."""
    params, x, e, _ = jax_runs
    outs = [_torch_run(params, x, e, route) for route in ROUTES]
    for out, grads in outs[1:]:
        assert out.nfe == outs[0][0].nfe
        assert torch.equal(out.logpx, outs[0][0].logpx)
        assert all(np.array_equal(a, b) for a, b in zip(grads, outs[0][1]))


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("route", [True, "step"])
def test_matches_jax_float64(x64, route):
    """float64, where eest is far above its rounding floor: the whole solve
    (and the step route) against JAX's fast adjoint with the weights at
    three times LeCun's scale and rtol=atol=1e-6: the same NFE and accept
    sequence, logpx and eest at rtol 1e-7, and the gradients of -mean(logpx)
    + 0.1 * error_estimate within 1e-6 (relative, Frobenius)."""
    params, x, e = _inputs()
    params = csl_params(DIM, HIDDEN, 0, scale=3.0)
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    ff = JFFJORD(JCSL(dim=DIM, hidden=HIDDEN), input_dim=DIM, rtol=1e-6, atol=1e-6,
                 max_steps=64)

    def loss(p):
        out = ff(p, jnp.asarray(x, jnp.float64), None, e=jnp.asarray(e, jnp.float64))
        return -jnp.mean(out.logpx) + REG * jreg.error_estimate(out.telemetry, agg="mean"), out

    (jval, jout), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(p64)
    tff = FFJORD(CSLDynamics(DIM, HIDDEN, device="cpu"), input_dim=DIM, rtol=1e-6, atol=1e-6,
                 max_steps=64, fused=route)
    tff.load_state_dict(convert.ffjord_state_dict(params))
    tff.to(torch.float64)
    out = tff(torch.tensor(x, dtype=torch.float64), e=torch.tensor(e, dtype=torch.float64))
    val = -out.logpx.mean() + REG * treg.error_estimate(out.telemetry, "mean")
    grads = torch.autograd.grad(val, list(tff.parameters()))
    assert out.solution.stats.naccept >= 8 and out.nfe == int(jout.nfe)
    np.testing.assert_array_equal(out.telemetry.accepted.numpy(),
                                  np.asarray(jout.telemetry.accepted))
    np.testing.assert_allclose(out.logpx.detach().numpy(), np.asarray(jout.logpx), rtol=1e-7)
    np.testing.assert_allclose(out.telemetry.eest.detach().numpy(),
                               np.asarray(jout.telemetry.eest), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-9)
    for j, (a, b) in enumerate(zip(grads, _jax_grads_in_torch_layout(g))):
        assert _rel(a.numpy(), b.reshape(a.shape)) <= 1e-6, (j, _rel(a.numpy(), b))


def test_autograd_vjp_and_sample_match_jax():
    """``analytic_vjp=False`` (the e^T J product by ``torch.func.vjp``, JAX's
    by ``jax.vjp``) in ``mode="while"``: the same NFE, logpx at rtol=1e-4,
    atol=1e-5; ``sample`` (reverse time, the exact trace by a batched
    Jacobian) from JAX's base-space draw at rtol=1e-4, atol=1e-5."""
    params, x, e = _inputs()
    jff = JFFJORD(JCSL(dim=DIM, hidden=HIDDEN), input_dim=DIM, rtol=TOL, atol=TOL,
                  max_steps=MAX_STEPS, analytic_vjp=False)
    jout = jff(params, jnp.asarray(x), None, e=jnp.asarray(e), mode="while")
    ff = _torch_ffjord(params, False, analytic_vjp=False)
    assert not ff.analytic_vjp
    out = ff(torch.tensor(x), e=torch.tensor(e), mode="while")
    assert out.nfe == int(jout.nfe)
    np.testing.assert_allclose(out.logpx.numpy(), np.asarray(jout.logpx), rtol=1e-4, atol=1e-5)
    loss = -out.logpx.mean()
    assert not loss.requires_grad  # "while" records nothing for a backward
    key = jax.random.PRNGKey(4)
    want = np.asarray(jff.sample(params, key, 6))
    z = np.asarray(jax.random.normal(key, (6, DIM)))
    got = ff.sample(6, z=torch.tensor(z))
    assert got.shape == (6, DIM)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    drawn = ff.sample(6, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn).all()


def test_autograd_vjp_gradients_match_the_analytic_route():
    """The ``torch.func.vjp`` route is differentiable: its gradients equal
    the analytic route's in float64 (rtol 1e-9, the same function) when
    both take the same steps."""
    params, x, e = _inputs()
    grads = []
    for analytic in (True, False):
        ff = _torch_ffjord(params, False, torch.float64, analytic_vjp=analytic)
        out = ff(torch.tensor(x, dtype=torch.float64), e=torch.tensor(e, dtype=torch.float64))
        grads.append((out.nfe, torch.autograd.grad(-out.logpx.mean(), list(ff.parameters()))))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-12)


def test_argument_validation_matches_jax():
    """JAX's ``ValueError``s for a bad ``fused``, and for fusing anything but
    Tsit5 over ``CSLDynamics`` with the analytic product."""
    csl = CSLDynamics(DIM, HIDDEN, device="cpu")
    for bad in (dict(fused="tiled"), dict(fused="yes")):
        with pytest.raises(ValueError, match="fused must be"):
            FFJORD(csl, DIM, **bad)
        with pytest.raises(ValueError, match="fused must be"):
            JFFJORD(JCSL(dim=DIM, hidden=HIDDEN), DIM, **bad)
    for kw in (dict(fused=True, solver="dopri5"), dict(fused="step", analytic_vjp=False)):
        with pytest.raises(ValueError, match="CSLDynamics"):
            FFJORD(csl, DIM, **kw)
        with pytest.raises(ValueError, match="CSLDynamics"):
            JFFJORD(JCSL(dim=DIM, hidden=HIDDEN), DIM, **kw)
    with pytest.raises(ValueError, match="CSLDynamics"):
        FFJORD(MLP(DIM, (4, DIM), device="cpu"), DIM, fused=True)
    with pytest.raises(ValueError, match="CSLDynamics"):
        JFFJORD(JMLP(features=(4, DIM)), DIM, fused=True)


def test_three_training_steps_match_jax():
    """Three training steps of -mean(logpx) + 0.1 * error_estimate on
    ``fused=True`` with WeightDecay(1e-5) then Adam(1e-2)
    (``ffjord_optimizer``, optax's semantics) against JAX's on
    ``fused="solve"``: the same NFE each step, the loss at rtol 1e-5 and the
    parameters after three steps within 2e-3 of their move (relative,
    Frobenius over the moves)."""
    from regneuralde_tpu.training import ffjord_optimizer as jopt
    from regneuralde_tpu_torch.training import (
        create_train_state,
        ffjord_optimizer,
        make_train_step,
    )

    params, x, e = _inputs()
    jff = _jax_ffjord("solve")

    def loss(p):
        out = jff(p, jnp.asarray(x), None, e=jnp.asarray(e))
        return -jnp.mean(out.logpx) + REG * jreg.error_estimate(out.telemetry, agg="mean"), out

    vg = jax.jit(jax.value_and_grad(loss, has_aux=True))
    opt = jopt(1e-2)
    jp, jstate = params, opt.init(params)
    jlog = []
    for _ in range(3):
        (val, out), g = vg(jp)
        upd, jstate = opt.update(g, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        jlog.append((float(val), int(out.nfe)))

    ff = _torch_ffjord(params, True)
    optimizer = ffjord_optimizer(1e-2)
    state = create_train_state(ff, optimizer)

    def loss_fn(model, xb, eb):
        out = model(xb, e=eb)
        return -out.logpx.mean() + REG * treg.error_estimate(out.telemetry, "mean"), out

    step = make_train_step(loss_fn, optimizer)
    for want_val, want_nfe in jlog:
        state, val, out = step(state, torch.tensor(x), torch.tensor(e))
        assert out.nfe == want_nfe
        np.testing.assert_allclose(val.item(), want_val, rtol=1e-5)
    start = [np.asarray(a) for a in _jax_grads_in_torch_layout(params)]
    moved_j = [np.asarray(a).reshape(s.shape) - s
               for a, s in zip(_jax_grads_in_torch_layout(jp), start)]
    moved_t = [p.detach().numpy() - s for p, s in zip(ff.parameters(), start)]
    assert _rel(np.concatenate([m.ravel() for m in moved_t]),
                np.concatenate([m.ravel() for m in moved_j])) <= 2e-3


def test_optimizer_matches_optax():
    """WeightDecay(1e-5) then Adam(1e-2) against optax's
    ``add_decayed_weights`` then ``adam`` over three updates of fixed
    gradients (rtol 1e-6)."""
    from regneuralde_tpu.training import ffjord_optimizer as jopt
    from regneuralde_tpu_torch.training import Adam, WeightDecay, ffjord_optimizer

    rng = np.random.default_rng(3)
    p0 = [np.asarray(rng.normal(size=s), np.float32) for s in ((4, 3), (5,))]
    gs = [[np.asarray(rng.normal(size=a.shape), np.float32) for a in p0] for _ in range(3)]
    opt = jopt(1e-2)
    jp = [jnp.asarray(a) for a in p0]
    js = opt.init(jp)
    tp = [torch.tensor(a) for a in p0]
    chain = ffjord_optimizer(1e-2)
    assert [type(x) for x in chain.parts] == [WeightDecay, Adam]
    ts = chain.init(tp)
    for g in gs:
        upd, js = opt.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = chain.update([torch.tensor(a) for a in g], ts, tp)
        tp = [p + u for p, u in zip(tp, tu)]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_exp_decay_schedule_matches_jax():
    """``lambda0 exp(-k t)`` in float32, bitwise JAX's; FFJORD's first
    value is 5e3."""
    js = jreg.exp_decay_schedule(5e3, 1e3, 500)
    ts = treg.exp_decay_schedule(5e3, 1e3, 500)
    for epoch in (0, 1, 7, 250, 499, 500):
        got = ts(epoch)
        assert got.dtype == torch.float32
        assert got.item() == float(js(epoch))
    assert ts(0).item() == 5e3


@pytest.fixture
def no_data_files(tmp_path, monkeypatch):
    """No data file in reach, and the JAX package's loaders on their numpy
    route (its native loader shuffles with its own generator)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REGNDE_DATA_DIR", raising=False)
    monkeypatch.setenv("REGNDE_NATIVE_LOADER", "0")
    return tmp_path


def test_load_miniboone_matches_jax(no_data_files):
    """The surrogate bitwise JAX's (the same numpy calls from the same
    seed), with the same split and shuffles; the ``miniboone.npy`` route
    in both orientations (a feature-major file is transposed)."""
    tmp_path = no_data_files
    from regneuralde_tpu.data import load_miniboone as jload
    from regneuralde_tpu_torch.data import load_miniboone

    for seed in (0, 3021):
        jtr, jte = jload(64, seed=seed)
        ttr, tte = load_miniboone(64, seed=seed)
        assert ttr.source == "synthetic" and len(ttr) == len(jtr)
        for a, b in zip(list(ttr)[:3], list(jtr)[:3]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(next(iter(tte)), next(iter(jte)))
    data = np.random.default_rng(1).normal(size=(50, 43)).astype(np.float32) * 3 + 1
    for arr in (data, data.T):
        path = tmp_path / "miniboone.npy"
        np.save(path, arr)
        ttr, tte = load_miniboone(10, path=str(path), seed=2)
        jtr, _ = jload(10, path=str(path), seed=2)
        assert ttr.source == str(path)
        # the first epoch's first batch (each pass reshuffles)
        np.testing.assert_array_equal(next(iter(ttr)), next(iter(jtr)))
        rows = np.concatenate(list(ttr) + list(tte))
        assert rows.shape == (50, 43)
        np.testing.assert_allclose(rows.mean(0), 0.0, atol=1e-5)


def test_loglikelihood_matches_jax():
    """``utils.loglikelihood`` over a loader against the JAX package's: the
    mean per-sample logpx of FFJORD's ``"while"`` mode, with a probe drawn
    per batch from one seed (rtol 1e-5)."""
    from regneuralde_tpu.utils import loglikelihood as jll
    from regneuralde_tpu_torch.data import DataLoader
    from regneuralde_tpu_torch.utils import loglikelihood

    params, x, e = _inputs()
    xs = np.concatenate([x, x[::-1] * 0.5]).astype(np.float32)
    es = np.concatenate([e, e[::-1]]).astype(np.float32)
    jff = _jax_ffjord(False)
    ff = _torch_ffjord(params, False)
    probes = iter(es[i:i + 5] for i in range(0, 16, 5))
    jprobes = iter(es[i:i + 5] for i in range(0, 16, 5))
    want = jll(lambda p, xb: jff(p, xb, None, e=jnp.asarray(next(jprobes)), mode="while"),
               params, DataLoader((xs,), 5))
    got = loglikelihood(lambda m, xb: m(xb, e=torch.tensor(next(probes)), mode="while"),
                        ff, DataLoader((xs,), 5))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert loglikelihood(lambda m, xb: m(xb, e=torch.zeros_like(xb), mode="while").logpx,
                         ff, DataLoader((xs,), 5), batches=1) < 0


def test_state_dict_round_trip_and_the_card_default():
    """``convert.ffjord_state_dict`` gives every key of the port's FFJORD
    with its shape (time Dense kernels ``(1, out)`` as ``(out, 1)``
    weights); CSLDynamics goes on the card unless ``device="cpu"``."""
    params = csl_params(DIM, HIDDEN)
    sd = convert.ffjord_state_dict(params)
    ff = FFJORD(CSLDynamics(DIM, HIDDEN, device="cpu"), DIM)
    want = ff.state_dict()
    assert sorted(sd) == sorted(want)
    assert all(sd[k].shape == want[k].shape for k in sd)
    np.testing.assert_array_equal(sd["dynamics.csl2.gate.weight"].numpy(),
                                  params["params"]["csl2"]["gate"]["kernel"].T)
    if torch.cuda.is_available():
        assert all(p.device.type == "cuda" for p in CSLDynamics(DIM, HIDDEN).parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CSLDynamics(DIM, HIDDEN)
