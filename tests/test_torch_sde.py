"""The port's ``sdeint`` (``regneuralde_tpu_torch.ops.sde``) against the JAX
package's ``sdeint`` on JAX's own draws.

JAX's ``sdeint`` makes exactly the N(0, 1) draws that
``regneuralde_tpu.ops.pallas_sde.presample_noise(key, shape, dtype,
max_steps)`` returns (one pair of rows a trial step); every case computes
them with JAX and hands them to the port as ``noise=``. The dynamics are the
MLP pair of ``tests/test_sde_whole_solve.py`` (drift 4 -> 8 tanh -> 4,
diffusion 4 -> 4 linear, its 0.2 folded into the diffusion's weights), batch
16, SOSRI.

Tolerances. Float64: the same accept sequence, NFE and success; y1, the
saves and the telemetry at 1e-7 relative; the gradients of ``sum(v^2) + 0.5
* (error_estimate + stiffness_estimate)`` at 1e-6 relative. Float32: the
same steps, y1 at 1e-5, the gradients within 2e-3 relative (Frobenius). The
port's adjoint against autograd straight through its trial-step loop:
float64 at 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.ops.pallas_sde import presample_noise as jax_presample_noise
from regneuralde_tpu.ops.sde import sdeint as jax_sdeint
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.ops import sde as tsde
from regneuralde_tpu_torch.ops.controller import PIController
from regneuralde_tpu_torch.ops.sri import SOSRI_TPU, stability_size

torch.set_num_threads(1)

BATCH, DIM, HIDDEN = 16, 4, 8
SA = [0.0, 0.3, 0.6, 1.0]
REG = 0.5
STAB = stability_size(SOSRI_TPU)
# (saveat, rtol = atol, max_steps)
CASES = {
    "final": (None, 1e-2, 64),
    "saveat": (SA, 1e-2, 64),
    "rejections": (SA, 2e-3, 128),
    "starved": (None, 1e-5, 3),
}


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _weights(seed=1):
    """(W1 (in, out), b1, W2, b2, Wd, bd) in JAX's layout, and y0."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    w = [f32(rng.normal(size=(DIM, HIDDEN)) / np.sqrt(DIM)), f32(rng.normal(size=HIDDEN) * 0.1),
         f32(rng.normal(size=(HIDDEN, DIM)) / np.sqrt(HIDDEN)), f32(rng.normal(size=DIM) * 0.1),
         f32(0.2 * rng.normal(size=(DIM, DIM)) / np.sqrt(DIM)),
         f32(0.2 * rng.normal(size=DIM) * 0.1)]
    return w, f32(rng.normal(size=(BATCH, DIM)) * 0.4)


def jax_drift(t, y, p):
    return jnp.tanh(y @ p[0] + p[1]) @ p[2] + p[3]


def jax_diffusion(t, y, p):
    return y @ p[4] + p[5]


def torch_drift(t, y, p):
    return torch.tanh(y @ p[0] + p[1]) @ p[2] + p[3]


def torch_diffusion(t, y, p):
    return y @ p[4] + p[5]


def _jax_solve(w, y0, case, dtype, mode="adjoint", key=7):
    """JAX's solve and the value and gradients (leaves, y0, t1) of the
    loss; the draws it made, as numpy."""
    sa, tol, max_steps = CASES[case]
    key = jax.random.PRNGKey(key)
    sa_j = None if sa is None else jnp.asarray(sa, dtype)
    p = [jnp.asarray(x, dtype) for x in w]
    x = jnp.asarray(y0, dtype)

    def loss(p, x, t1):
        s = jax_sdeint(jax_drift, jax_diffusion, x, jnp.asarray(0.0, dtype), t1, p, key=key,
                       solver="sosri", rtol=tol, atol=tol, max_steps=max_steps, saveat=sa_j,
                       mode=mode)
        v = s.y1 if sa is None else s.ys
        r = (jreg.error_estimate(s.telemetry, agg="mean")
             + jreg.stiffness_estimate(s.telemetry, STAB, agg="mean"))
        return jnp.sum(v ** 2) + REG * r, s

    t1 = jnp.asarray(1.0, dtype)
    if mode == "adjoint":
        (_, s), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(p, x, t1)
    else:
        _, s = loss(p, x, t1)
        g = None
    xi = jax_presample_noise(key, (BATCH, DIM), dtype, max_steps)
    return s, g, [np.asarray(a) for a in xi]


def _torch_solve(w, y0, case, dtype, noise, mode="adjoint"):
    sa, tol, max_steps = CASES[case]
    leaves = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in w]
    y = torch.tensor(y0, dtype=dtype, requires_grad=True)
    t1 = torch.tensor(1.0, dtype=dtype, requires_grad=True)
    noise = tuple(torch.from_numpy(np.array(a)) for a in noise)
    s = tsde.sdeint(torch_drift, torch_diffusion, y, 0.0, t1, leaves, noise=noise,
                    solver="sosri", rtol=tol, atol=tol, max_steps=max_steps,
                    saveat=None if sa is None else torch.tensor(sa, dtype=dtype), mode=mode)
    if mode != "adjoint":
        return s, None
    v = s.y1 if sa is None else s.ys
    r = treg.error_estimate(s.telemetry, "mean") + treg.stiffness_estimate(
        s.telemetry, STAB, "mean")
    grads = torch.autograd.grad(v.square().sum() + REG * r, [*leaves, y, t1])
    return s, [g.detach().numpy() for g in grads]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _assert_same_steps(ts, js):
    live = np.asarray(js.telemetry.live)
    assert ts.stats.naccept == int(js.stats.naccept)
    assert ts.stats.nreject == int(js.stats.nreject)
    assert ts.stats.nfe1 == int(js.stats.nfe1) and ts.stats.nfe2 == int(js.stats.nfe2)
    assert ts.stats.success == bool(js.stats.success)
    np.testing.assert_array_equal(ts.telemetry.live.numpy(), live)
    np.testing.assert_array_equal(ts.telemetry.accepted.numpy(),
                                  np.asarray(js.telemetry.accepted))


def _jax_grads(g):
    gp, gy, gt = g
    return [np.asarray(x) for x in gp] + [np.asarray(gy), np.asarray(gt)]


@pytest.mark.parametrize("case", list(CASES))
def test_adjoint_matches_jax_float64(x64, case):
    w, y0 = _weights()
    js, jg, noise = _jax_solve(w, y0, case, jnp.float64)
    ts, tg = _torch_solve(w, y0, case, torch.float64, noise)
    _assert_same_steps(ts, js)
    if case == "rejections":
        assert ts.stats.nreject > 0, "the case needs rejections"
    if case == "starved":
        assert not ts.stats.success
    assert _rel(ts.y1.detach(), js.y1) <= 1e-7
    if ts.ys is not None:
        assert _rel(ts.ys.detach(), js.ys) <= 1e-7
    for name in ("t", "dt", "eest", "eigen_est"):
        assert _rel(getattr(ts.telemetry, name).detach(),
                    getattr(js.telemetry, name)) <= 1e-7, name
    for a, b in zip(tg, _jax_grads(jg)):
        assert _rel(a, b) <= 1e-6


@pytest.mark.parametrize("case", ["final", "saveat"])
def test_while_matches_jax_float64(x64, case):
    w, y0 = _weights()
    js, _, noise = _jax_solve(w, y0, case, jnp.float64, mode="while")
    ts, _ = _torch_solve(w, y0, case, torch.float64, noise, mode="while")
    _assert_same_steps(ts, js)
    assert _rel(ts.y1, js.y1) <= 1e-7
    if ts.ys is not None:
        assert _rel(ts.ys, js.ys) <= 1e-7
    assert _rel(ts.telemetry.eest, js.telemetry.eest) <= 1e-7


@pytest.mark.parametrize("case", ["final", "rejections"])
def test_adjoint_matches_jax_float32(case):
    w, y0 = _weights()
    js, jg, noise = _jax_solve(w, y0, case, jnp.float32)
    ts, tg = _torch_solve(w, y0, case, torch.float32, noise)
    _assert_same_steps(ts, js)
    assert _rel(ts.y1.detach(), js.y1) <= 1e-5
    for a, b in zip(tg, _jax_grads(jg)):
        assert _rel(a, b) <= 2e-3


@pytest.mark.parametrize("case", ["saveat", "rejections"])
def test_adjoint_matches_autograd_through_the_loop(case):
    """The replay adjoint against autograd of the same trial-step loop run
    with the graph kept (float64, 1e-9)."""
    sa, tol, max_steps = CASES[case]
    w, y0 = _weights()
    gen = torch.Generator().manual_seed(3)
    noise = tsde.presample_noise(gen, (BATCH, DIM), max_steps, dtype=torch.float64)

    def run(mode):
        leaves = [torch.tensor(x, dtype=torch.float64, requires_grad=True) for x in w]
        y = torch.tensor(y0, dtype=torch.float64, requires_grad=True)
        t1 = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        sat = torch.tensor(sa, dtype=torch.float64)
        if mode == "adjoint":
            s = tsde.sdeint(torch_drift, torch_diffusion, y, 0.0, t1, leaves, noise=noise,
                            solver="sosri", rtol=tol, atol=tol, max_steps=max_steps,
                            saveat=sat)
            ys, tel = s.ys, s.telemetry
        else:
            tab = tsde.get_tableau("sosri")
            step = tsde.make_step(tab, torch_drift, torch_diffusion,
                                  PIController(beta1=0.5, beta2=0.0), tol, tol, torch.float64)
            t0, t1_, dt_init = tsde.sde_prologue(y, 0.0, t1, None)
            sat, ys0 = tsde.save_rows_at_start(sat, t0, y)
            qold = torch.full((), 1e-4, dtype=torch.float32)
            (_, _, _, _, ys), rows, accepted, _, _ = tsde._forward_loop(
                step, max_steps, t0, t1_, dt_init, qold, y, ys0, sat, tuple(leaves),
                noise[0], noise[1], keep_history=False)
            tel = tsde._telemetry(rows, accepted, max_steps, t0)
        r = treg.error_estimate(tel, "mean") + treg.stiffness_estimate(tel, STAB, "mean")
        loss = ys.square().sum() + REG * r
        return torch.autograd.grad(loss, [*leaves, y, t1])

    for a, b in zip(run("adjoint"), run("loop")):
        assert _rel(a.numpy(), b.numpy()) <= 1e-9


def test_generator_draws_and_refusals():
    """``generator=`` draws ``presample_noise``'s buffers; exactly one of
    noise and generator; the JAX options not ported raise naming ROADMAP."""
    w, y0 = _weights()
    leaves = [torch.tensor(x) for x in w]
    y = torch.tensor(y0)
    kw = dict(solver="sosri2", rtol=1e-1, atol=1e-1, max_steps=16, mode="while")
    a = tsde.sdeint(torch_drift, torch_diffusion, y, 0.0, 1.0, leaves,
                    generator=torch.Generator().manual_seed(5), **kw)
    noise = tsde.presample_noise(torch.Generator().manual_seed(5), y.shape, 16)
    b = tsde.sdeint(torch_drift, torch_diffusion, y, 0.0, 1.0, leaves, noise=noise, **kw)
    assert torch.equal(a.y1, b.y1) and a.stats == b.stats
    with pytest.raises(ValueError, match="exactly one"):
        tsde.sdeint(torch_drift, torch_diffusion, y, 0.0, 1.0, leaves, **kw)
    with pytest.raises(ValueError, match="exactly one"):
        tsde.sdeint(torch_drift, torch_diffusion, y, 0.0, 1.0, leaves, noise=noise,
                    generator=torch.Generator(), **kw)
    with pytest.raises(ValueError, match="max_steps"):
        tsde.sdeint(torch_drift, torch_diffusion, y, 0.0, 1.0, leaves,
                    noise=tuple(x[:8] for x in noise), **kw)
    for bad, err in ((dict(mode="scan"), NotImplementedError),
                     (dict(solver="em"), NotImplementedError),
                     (dict(brownian="stack"), NotImplementedError),
                     (dict(mode="bogus"), ValueError), (dict(solver="rk4"), ValueError),
                     (dict(brownian="tree"), ValueError)):
        with pytest.raises(err, match="ROADMAP" if err is NotImplementedError else None):
            tsde.sdeint(torch_drift, torch_diffusion, y, 0.0, 1.0, leaves, noise=noise,
                        **{**kw, **bad})
