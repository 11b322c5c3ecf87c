"""The port's SDE whole solve (``regneuralde_tpu_torch.ops.sde_whole_solve``;
on the CPU the wrappers take the plain versions of K9/K10) against the JAX
package's ``whole_solve_sdeint`` in interpret mode, as
``tests/test_sde_whole_solve.py`` runs it, on JAX's own draws; the hand
pullback of one trial step against ``torch.autograd``; and the plain whole
solve against the port's ``sdeint``.

The pair is ``tests/test_sde_whole_solve.py``'s ``_setup`` pair (drift
``MLP((8, 4))``, diffusion ``0.2 * MLP((4,))``, the 0.2 folded into the
diffusion's weights), batch 16 (and 13, which JAX pads to 16 with masked
rows and the port does not pad), SOSRI at rtol=atol=1e-2, max_steps 64.

Tolerances: against JAX in float32 the same accept sequence and NFE, y1 and
the saves within 1e-5 relative, the gradients of ``sum(v^2) + 10 *
error_estimate`` within 2e-3 relative (Frobenius). The hand pullback against
autograd in float64: 1e-10. The plain whole solve against ``sdeint``'s
adjoint in float64: 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.ops.pallas_sde import presample_noise as jax_presample_noise
from regneuralde_tpu.ops.pallas_sde import whole_solve_sdeint as jax_whole_solve_sdeint
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.ops import sde as tsde
from regneuralde_tpu_torch.ops import sde_whole_solve as sw
from regneuralde_tpu_torch.ops.controller import PIController
from regneuralde_tpu_torch.ops.sri import get_tableau

torch.set_num_threads(1)

DIM, HIDDEN = 4, 8
SA = [0.0, 0.3, 0.6, 1.0]
KW = dict(solver="sosri", rtol=1e-2, atol=1e-2, max_steps=64)
REG = 10.0


def _weights(batch, seed=1):
    """The pair's weights in JAX's layout (kernels ``(in, out)``) and y0."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    w = [f32(rng.normal(size=(DIM, HIDDEN)) / np.sqrt(DIM)), f32(rng.normal(size=HIDDEN) * 0.1),
         f32(rng.normal(size=(HIDDEN, DIM)) / np.sqrt(HIDDEN)), f32(rng.normal(size=DIM) * 0.1),
         f32(0.2 * rng.normal(size=(DIM, DIM)) / np.sqrt(DIM)),
         f32(0.2 * rng.normal(size=DIM) * 0.1)]
    return w, f32(rng.normal(size=(batch, DIM)) * 0.4)


def _leaves(w, dtype=torch.float32):
    """The port's leaves (``nn.Linear`` layout), requiring grad."""
    return [torch.tensor(np.ascontiguousarray(x.T) if x.ndim == 2 else x, dtype=dtype,
                         requires_grad=True) for x in w]


def _jax_run(w, y0, sa):
    drift = lambda t, y, p: jnp.tanh(y @ p[0] + p[1]) @ p[2] + p[3]
    diffusion = lambda t, y, p: y @ p[4] + p[5]
    key = jax.random.PRNGKey(7)
    sa_j = None if sa is None else jnp.asarray(sa, jnp.float32)

    def loss(p, x):
        s = jax_whole_solve_sdeint(drift, diffusion, x, 0.0, 1.0, p, key=key, saveat=sa_j, **KW)
        v = s.y1 if sa is None else s.ys
        return jnp.sum(v ** 2) + REG * jreg.error_estimate(s.telemetry, agg="mean"), s

    (_, s), (gp, gy) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(x) for x in w], jnp.asarray(y0))
    xi = jax_presample_noise(key, y0.shape, jnp.float32, KW["max_steps"])
    grads = [np.asarray(g).T if g.ndim == 2 else np.asarray(g) for g in gp] + [np.asarray(gy)]
    return s, grads, tuple(torch.from_numpy(np.array(a)) for a in xi)


def _torch_run(w, y0, sa, noise, dtype=torch.float32):
    leaves = _leaves(w, dtype)
    y = torch.tensor(y0, dtype=dtype, requires_grad=True)
    s = sw.whole_solve_sdeint(y, 0.0, 1.0, leaves, n_drift=2,
                              noise=tuple(x.to(dtype) for x in noise),
                              saveat=None if sa is None else torch.tensor(sa, dtype=dtype), **KW)
    v = s.y1 if sa is None else s.ys
    loss = v.square().sum() + REG * treg.error_estimate(s.telemetry, "mean")
    return s, [g.numpy() for g in torch.autograd.grad(loss, [*leaves, y])]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.parametrize("batch,sa", [(16, None), (16, SA), (13, SA)],
                         ids=["final", "saveat", "batch13"])
def test_plain_whole_solve_matches_jax(batch, sa):
    w, y0 = _weights(batch)
    js, jg, noise = _jax_run(w, y0, sa)
    ts, tg = _torch_run(w, y0, sa, noise)
    assert ts.stats.naccept == int(js.stats.naccept)
    assert ts.stats.nreject == int(js.stats.nreject)
    assert ts.stats.nfe1 == int(js.stats.nfe1) and ts.stats.nfe2 == int(js.stats.nfe2)
    assert ts.stats.success and bool(js.stats.success)
    np.testing.assert_array_equal(ts.telemetry.accepted.numpy(),
                                  np.asarray(js.telemetry.accepted))
    np.testing.assert_array_equal(ts.telemetry.live.numpy(), np.asarray(js.telemetry.live))
    assert _rel(ts.y1.detach(), js.y1) <= 1e-5
    if sa is not None:
        assert _rel(ts.ys.detach(), js.ys) <= 1e-5
    for a, b in zip(tg, jg):
        assert _rel(a, b) <= 2e-3


# (tableau, rtol = atol, t, dt, tail_h, tail rows' scale): accept and
# reject, inside and outside the tail, var == 0 (a step that consumes the
# tail exactly), is_last, the qmin clamp (huge eest), the qmax clamp (tiny
# eest), SRIW1's aliased drift stage
PULLBACK_CASES = {
    "accept_outside": ("sosri2", 1.0, 0.0, 0.1, 0.0, 0.0),
    "accept_inside": ("sosri2", 1.0, 0.0, 0.1, 0.3, 0.5),
    "reject_inside": ("sosri2", 1e-6, 0.0, 0.1, 0.3, 0.5),
    "reject_outside_tail": ("sosri2", 1e-6, 0.0, 0.1, 0.05, 0.5),
    "var_zero": ("sosri2", 1.0, 0.0, 0.125, 0.125, 0.5),
    "is_last": ("sosri2", 1.0, 0.9, 0.2, 0.0, 0.0),
    "qmin_clamp": ("sosri2", 1e-9, 0.0, 0.1, 0.0, 0.0),
    "qmax_clamp": ("sosri2", 100.0, 0.0, 0.1, 0.0, 0.0),
    "sriw1_alias": ("sriw1", 0.05, 0.0, 0.1, 0.3, 0.5),
    "sosri_reject": ("sosri", 1e-3, 0.2, 0.1, 0.0, 0.0),
}


@pytest.mark.parametrize("case", list(PULLBACK_CASES))
def test_step_pullback_matches_autograd(case):
    """``_sde_step_bwd_math`` against ``torch.autograd`` of
    ``plain_sde_trial_step`` in float64, every output seeded, at 1e-10."""
    name, tol, t, dt, h, tail_scale = PULLBACK_CASES[case]
    B, D, H = 5, 3, 6
    f64 = torch.float64
    g = torch.Generator().manual_seed(1)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, dtype=f64) * sc
    leaves = [r(H, D, sc=D ** -0.5), r(H, sc=0.1), r(D, H, sc=H ** -0.5), r(D, sc=0.1),
              r(D, D, sc=0.3 * D ** -0.5), r(D, sc=0.05)]
    y, tw, tz = r(B, D, sc=0.5), r(B, D, sc=tail_scale), r(B, D, sc=tail_scale)
    sc = lambda v: torch.tensor(v, dtype=f64)
    prim = [sc(t), sc(dt), sc(1e-4), sc(h), y, tw, tz, r(B, D), r(B, D), sc(1.0), sc(1.0)]
    req = [x.clone().requires_grad_(True) for x in prim]
    lreq = [x.clone().requires_grad_(True) for x in leaves]
    tab, ctrl = get_tableau(name), PIController(beta1=0.5, beta2=0.0)
    out = sw.plain_sde_trial_step(tab, ctrl, tol, tol, *req, lreq, 2)
    outs = [out.t, out.dt, out.qold, out.y, *out.tail, out.tel_t, out.dt_eff, out.eest,
            out.eigen_est]
    cts = [r(*o.shape) for o in outs]
    inputs = [req[k] for k in (0, 1, 2, 3, 4, 5, 6, 9, 10)] + lreq
    want = torch.autograd.grad(outs, inputs, grad_outputs=cts, allow_unused=True)
    want = [torch.zeros_like(x) if w is None else w for w, x in zip(want, inputs)]
    got_s, got_l = sw._sde_step_bwd_math(tab, ctrl, tol, tol, prim, leaves, 2, bool(out.accept),
                                         out.sums, cts)
    if case.startswith("reject") or case == "qmin_clamp":
        assert not bool(out.accept)
    elif case != "sosri_reject":
        assert bool(out.accept)
    assert bool(out.is_last) == (case == "is_last")
    for a, b in zip([*got_s, *got_l], want):
        assert _rel(a.detach().numpy(), b.numpy()) <= 1e-10


@pytest.mark.parametrize("sa,tol", [(SA, 5e-4), (None, 1e-2)], ids=["saveat_rejections", "final"])
def test_plain_whole_solve_matches_sdeint_float64(sa, tol):
    """The plain K9/K10 (through ``whole_solve_sdeint``) against ``sdeint``'s
    autograd replay on the same draws, float64: the same steps, y1, the
    saves, the telemetry and the gradients of ``sum(v^2) + 10 *
    (error_estimate + stiffness_estimate)`` at 1e-9."""
    w, y0 = _weights(16)
    noise = tsde.presample_noise(torch.Generator().manual_seed(2), y0.shape, 128,
                                 dtype=torch.float64)
    kw = dict(solver="sosri2", rtol=tol, atol=tol, max_steps=128)

    def run(whole):
        leaves = _leaves(w, torch.float64)
        y = torch.tensor(y0, dtype=torch.float64, requires_grad=True)
        t1 = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        sat = None if sa is None else torch.tensor(sa, dtype=torch.float64)
        if whole:
            s = sw.whole_solve_sdeint(y, 0.0, t1, leaves, n_drift=2, noise=noise, saveat=sat,
                                      **kw)
        else:
            drift, diffusion = sw.pair_functions(2)
            s = tsde.sdeint(drift, diffusion, y, 0.0, t1, leaves, noise=noise, saveat=sat, **kw)
        v = s.y1 if sa is None else s.ys
        r = treg.error_estimate(s.telemetry, "mean") + treg.stiffness_estimate(
            s.telemetry, 11.0, "mean")
        return s, torch.autograd.grad(v.square().sum() + REG * r, [*leaves, y, t1])

    (a, ga), (b, gb) = run(True), run(False)
    assert a.stats == b.stats
    if sa is not None:
        assert a.stats.nreject > 0, "the case needs rejections"
        assert _rel(a.ys.detach(), b.ys.detach()) <= 1e-9
    assert _rel(a.y1.detach(), b.y1.detach()) <= 1e-9
    for name in ("t", "dt", "eest", "eigen_est"):
        assert _rel(getattr(a.telemetry, name).detach(),
                    getattr(b.telemetry, name).detach()) <= 1e-9
    for x, z in zip(ga, gb):
        assert _rel(x.numpy(), z.numpy()) <= 1e-9


def test_record_layout_and_refusals():
    """The record of a CPU solve (the plain version: no launch), the
    wrappers' refusals, and an unsorted saveat refused."""
    w, y0 = _weights(5)
    leaves = [x.detach() for x in _leaves(w)]
    y = torch.tensor(y0)
    noise = tsde.presample_noise(torch.Generator().manual_seed(3), y.shape, 16)
    t0, t1 = torch.tensor(0.0), torch.tensor(1.0)
    ctrl = PIController(beta1=0.5, beta2=0.0)
    sw.reset_launches()
    rec = sw.sde_whole_solve_fwd(t0, t1, torch.tensor(0.01), y, leaves, 0.1, 0.1, ctrl, 16,
                                 *noise, n_drift=2, saveat=torch.tensor(SA))
    assert sw.LAUNCHES == {"sde_whole_solve_fwd": 0, "sde_whole_solve_bwd": 0,
                           "sde_whole_solve_cubic_fwd": 0, "sde_whole_solve_cubic_bwd": 0}
    na, nr, done = rec.final[3:].tolist()
    ns = int(na + nr)
    assert done == 1.0 and rec.hy.shape == (17, 5, DIM) and rec.streams.shape == (12, 16)
    assert torch.equal(rec.hy[0], y) and torch.equal(rec.hy[ns], rec.y1)
    assert torch.equal(rec.streams[:, ns:], torch.zeros_like(rec.streams[:, ns:]))
    assert rec.cursors.tolist() == [1, 4] and torch.equal(rec.ys[0], y)
    assert torch.equal(rec.hw[0], torch.zeros_like(y))
    with pytest.raises(RuntimeError, match="device"):
        sw.sde_whole_solve_fwd(t0, t1, torch.tensor(0.01), y.to("meta"), leaves, 0.1, 0.1, ctrl,
                               16, *noise, n_drift=2)
    with pytest.raises(ValueError, match="sorted"):
        sw.whole_solve_sdeint(y, 0.0, 1.0, leaves, n_drift=2, noise=noise, max_steps=16,
                              saveat=torch.tensor([0.0, 0.6, 0.3, 1.0]))
    with pytest.raises(ValueError, match="exactly one"):
        sw.whole_solve_sdeint(y, 0.0, 1.0, leaves, n_drift=2, max_steps=16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sw.whole_solve_sdeint(y, 0.0, 1.0, leaves, n_drift=2, noise=noise, max_steps=16,
                              solver="em")
