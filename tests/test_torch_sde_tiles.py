"""K9's and K10's tile plan and K10's order of sums on the CPU
(``regneuralde_tpu_torch.ops.sde_whole_solve``): ``plain_sde_bwd_tiles``,
the reverse walk in the order of the reverse tile body (the bitwise
reference for K10 on the card), against the plain reverse walk
``plain_sde_whole_solve_bwd`` in float32 and float64; the plain K9 and the
schedule as the gradient of the whole solve against the JAX package's
``whole_solve_sdeint`` in interpret mode on JAX's own draws, for SOSRI2,
SOSRI and SRIW1, with and without saves, at ragged batches and at the cubic
pair's widths; and ``sde_tile_plan``'s sizes.

Tolerances: the schedule within 1e-5 (relative Frobenius) of the plain
walk in float32 and within 3 times the plain walk's distance from the
float64 walk plus 1e-6 (both orders of sums are float32 rounding), and
within 1e-12 of it in float64 (the same algebra). Against JAX in float32
(``tests/test_torch_sde_whole_solve.py``'s): the same accept sequence and
NFE, y1 and the saves within 1e-5, the gradients of ``sum(v^2) + 10 *
error_estimate`` within 2e-3.
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

torch.set_num_threads(1)

REG = 10.0
SA = [0.0, 0.3, 0.6, 1.0]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _weights(batch, dim, hidden, cubic, seed=1):
    """The pair's weights in JAX's layout (kernels ``(in, out)``) and y0:
    drift dim -> hidden -> dim (on the cube of the state where cubic),
    diffusion 0.2 * (dim -> dim)."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    w = [f32(rng.normal(size=(dim, hidden)) / np.sqrt(dim)), f32(rng.normal(size=hidden) * 0.1),
         f32(rng.normal(size=(hidden, dim)) / np.sqrt(hidden)), f32(rng.normal(size=dim) * 0.1),
         f32(0.2 * rng.normal(size=(dim, dim)) / np.sqrt(dim)),
         f32(0.2 * rng.normal(size=dim) * 0.1)]
    y0 = rng.normal(size=(batch, dim)) * 0.4
    if cubic:
        y0 = y0 + np.eye(1, dim)
    return w, f32(y0)


def _record(batch, dim, hidden, tol, solver, sa, body, seed=0, S=64):
    """A plain forward's record at seeded random weights, states and draws,
    and the backward's arguments (seeded cotangents of y1, the telemetry
    and the saves)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g) * sc
    leaves = [r(hidden, dim, sc=dim ** -0.5), r(hidden, sc=0.1), r(dim, hidden, sc=hidden ** -0.5),
              r(dim, sc=0.1), r(dim, dim, sc=dim ** -0.5), r(dim, sc=0.1)]
    y0 = r(batch, dim, sc=0.5)
    if body == "cubic":
        y0 = y0 + torch.eye(1, dim)
    xi = tuple(r(S, batch, dim) for _ in range(2))
    t0, t1 = torch.tensor(0.0), torch.tensor(1.0)
    ctrl = PIController(beta1=0.5, beta2=0.0)
    kw = dict(n_drift=2, solver=solver, body=body)
    fkw = dict(kw)
    if sa is not None:
        fkw["saveat"], fkw["ys_init"] = tsde.save_rows_at_start(torch.tensor(sa), t0, y0)
    rec = sw.plain_sde_whole_solve_fwd(t0, t1, torch.tensor(0.01), y0, leaves, tol, tol, ctrl, S,
                                       *xi, **fkw)
    ns = int(rec.final[3:5].sum())
    seeds = (r(batch, dim), 0.1 * r(4, S), None if sa is None else r(len(sa), batch, dim))
    return rec, ns, seeds, (t0, t1, leaves, tol, tol, ctrl, *xi), dict(kw, saveat=fkw.get("saveat"))


def _groups(g):
    """(ct_t0, ct_t1, ct_dt0), ct_y0, ct_ys_init and each leaf's cotangent."""
    return [torch.stack(g[:3]), *g[3:]]


@pytest.mark.parametrize("batch,dim,hidden,tol,solver,sa,body", [
    (13, 4, 8, 1e-2, "sosri2", SA, "mlp"), (7, 4, 8, 1e-2, "sosri", None, "mlp"),
    (13, 3, 6, 3e-2, "sriw1", SA, "mlp"), (16, 5, 7, 1e-2, "sosri2", None, "mlp"),
    (7, 2, 6, 1e-2, "sosri", SA, "cubic")],
    ids=["sosri2_13_saves", "sosri_7", "sriw1_13_saves", "sosri2_16", "cubic_7_saves"])
def test_schedule_matches_plain_bwd(batch, dim, hidden, tol, solver, sa, body):
    """The schedule against the plain reverse walk over the same record:
    float32 within its rounding, float64 to 1e-12."""
    rec, ns, (ct_y1, ct_tel, ct_ys), (t0, t1, leaves, *rest), kw = _record(
        batch, dim, hidden, tol, solver, sa, body)
    assert rec.final[4] > 0 or tol < 3e-2, "the walk holds no rejection"
    args = (rec, ns, ct_y1, ct_tel, t0, t1, leaves, *rest)
    got = _groups(sw.plain_sde_bwd_tiles(*args, ct_ys=ct_ys, **kw))
    plain = _groups(sw.plain_sde_whole_solve_bwd(*args, ct_ys=ct_ys, **kw))
    d = lambda x: None if x is None else x.double()
    rec64 = sw.SDERecord(*map(d, rec))
    args64 = (rec64, ns, d(ct_y1), d(ct_tel), d(t0), d(t1), [d(x) for x in leaves], *rest[:3],
              d(rest[3]), d(rest[4]))
    kw64 = dict(kw, saveat=d(kw["saveat"]))
    got64 = _groups(sw.plain_sde_bwd_tiles(*args64, ct_ys=d(ct_ys), **kw64))
    ref = _groups(sw.plain_sde_whole_solve_bwd(*args64, ct_ys=d(ct_ys), **kw64))
    for j, (a, p, a64, r) in enumerate(zip(got, plain, got64, ref)):
        if not r.numel():
            continue
        assert a.dtype == torch.float32 and a64.dtype == torch.float64
        assert _rel(a, p) <= 1e-5, (j, _rel(a, p))
        assert _rel(a, r) <= 3 * _rel(p, r) + 1e-6, (j, _rel(a, r), _rel(p, r))
        assert _rel(a64, r) <= 1e-12, (j, _rel(a64, r))


def test_schedule_blocks_sum_in_block_order():
    """Fewer blocks than tiles (a block walks several tiles, each block's
    leaf cotangents one slot): the same cotangents as one tile a block
    within float32 rounding, the rows' bitwise."""
    rec, ns, (ct_y1, ct_tel, ct_ys), rest, kw = _record(13, 4, 8, 1e-2, "sosri2", SA, "mlp")
    args = (rec, ns, ct_y1, ct_tel, *rest)
    a = sw.plain_sde_bwd_tiles(*args, ct_ys=ct_ys, **kw)
    b = sw.plain_sde_bwd_tiles(*args, ct_ys=ct_ys, blocks=2, **kw)
    assert torch.equal(a[3], b[3]) and torch.equal(a[4], b[4])
    for x, y in zip(a[5:], b[5:]):
        assert _rel(x, y) <= 1e-5


def _jax_run(w, y0, sa, solver, cubic, tol, max_steps):
    drift_in = (lambda y: y ** 3) if cubic else (lambda y: y)
    drift = lambda t, y, p: jnp.tanh(drift_in(y) @ p[0] + p[1]) @ p[2] + p[3]
    diffusion = lambda t, y, p: y @ p[4] + p[5]
    key = jax.random.PRNGKey(7)
    sa_j = None if sa is None else jnp.asarray(sa, jnp.float32)
    kw = dict(solver=solver, rtol=tol, atol=tol, max_steps=max_steps)

    def loss(p, x):
        s = jax_whole_solve_sdeint(drift, diffusion, x, 0.0, 1.0, p, key=key, saveat=sa_j, **kw)
        v = s.y1 if sa is None else s.ys
        return jnp.sum(v ** 2) + REG * jreg.error_estimate(s.telemetry, agg="mean"), s

    (_, s), (gp, gy) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        [jnp.asarray(x) for x in w], jnp.asarray(y0))
    xi = jax_presample_noise(key, y0.shape, jnp.float32, max_steps)
    grads = [np.asarray(g).T if g.ndim == 2 else np.asarray(g) for g in gp] + [np.asarray(gy)]
    return s, grads, tuple(torch.from_numpy(np.array(a)) for a in xi)


@pytest.mark.parametrize("batch,solver,sa,cubic,tol", [
    (13, "sosri2", SA, False, 1e-2), (7, "sosri", None, False, 1e-2),
    (13, "sriw1", None, False, 1e-2), (7, "sriw1", SA, False, 1e-2),
    (7, "sosri", SA, True, 3e-2)],
    ids=["sosri2_13_saves", "sosri_7", "sriw1_13", "sriw1_7_saves", "cubic_7_saves"])
def test_k9_and_schedule_match_jax(monkeypatch, batch, solver, sa, cubic, tol):
    """The whole solve on the CPU with the schedule as its backward (the
    plain K9 forward, ``plain_sde_bwd_tiles`` for ``plain_sde_whole_solve_bwd``)
    against JAX's ``whole_solve_sdeint`` in interpret mode on its draws."""
    dim, hidden, max_steps = (2, 8, 64) if cubic else (4, 8, 64)
    w, y0 = _weights(batch, dim, hidden, cubic)
    js, jg, noise = _jax_run(w, y0, sa, solver, cubic, tol, max_steps)
    calls = []

    def schedule(*a, **k):
        calls.append(1)
        return sw.plain_sde_bwd_tiles(*a, **k)

    monkeypatch.setattr(sw, "plain_sde_whole_solve_bwd", schedule)
    leaves = [torch.tensor(np.ascontiguousarray(x.T) if x.ndim == 2 else x, requires_grad=True)
              for x in w]
    y = torch.tensor(y0, requires_grad=True)
    s = sw.whole_solve_sdeint(y, 0.0, 1.0, leaves, n_drift=2, noise=noise, solver=solver,
                              rtol=tol, atol=tol, max_steps=max_steps,
                              saveat=None if sa is None else torch.tensor(sa),
                              body="cubic" if cubic else "mlp")
    v = s.y1 if sa is None else s.ys
    loss = v.square().sum() + REG * treg.error_estimate(s.telemetry, "mean")
    grads = torch.autograd.grad(loss, [*leaves, y])
    assert calls == [1]
    assert (s.stats.naccept, s.stats.nreject) == (int(js.stats.naccept), int(js.stats.nreject))
    assert s.stats.nfe1 == int(js.stats.nfe1) and s.stats.nfe2 == int(js.stats.nfe2)
    assert s.stats.success and bool(js.stats.success)
    np.testing.assert_array_equal(s.telemetry.accepted.numpy(), np.asarray(js.telemetry.accepted))
    assert _rel(s.y1.detach(), js.y1) <= 1e-5
    if sa is not None:
        assert _rel(s.ys.detach(), js.ys) <= 1e-5
    for a, b in zip(grads, jg):
        assert _rel(a, b) <= 2e-3


def test_plan_at_the_nsde_and_toy_widths():
    """The tile plan at the MNIST NSDE pair (512 x 32, drift 32-64-32,
    diffusion 32-32) and at the toy's cubic pair (100 x 2, drift 2-50-2,
    diffusion 2-2), each its pair's compile-time instance."""
    p = sw.sde_tile_plan(512, ((32, 64, 32), (32, 32)))
    assert (p.rows, p.tiles, p.terms) == (4, 128, 8)
    assert p.fwd_lanes == ((4, 8), (4,)) and p.bwd_lanes == ((8, 4), (4,))
    assert (p.fwd_smem_bytes, p.bwd_smem_bytes) == (48864, 86272)
    assert (p.cw_smem, p.fixed_instance) == (2 * 32 * 64 + 64 + 32 + 32 * 32 + 32, True)
    q = sw.sde_tile_plan(100, ((2, 50, 2), (2, 2)), "cubic")
    assert (q.rows, q.tiles) == (4, 25)
    assert q.fwd_lanes == ((1, 8), (1,)) and q.bwd_lanes == ((8, 1), (1,))
    assert (q.fwd_smem_bytes, q.bwd_smem_bytes) == (10576, 14208)
    assert (q.cw_smem, q.fixed_instance) == (2 * 2 * 50 + 50 + 2 + 2 * 2 + 2, True)
    # one pair's widths under the other body are the generic instance
    assert not sw.sde_tile_plan(512, ((32, 64, 32), (32, 32)), "cubic").fixed_instance
    assert not sw.sde_tile_plan(100, ((2, 50, 2), (2, 2))).fixed_instance
    # ragged batches: a last tile of 1 and of 3 rows
    assert sw.sde_tile_plan(13, ((4, 8, 4), (4, 4))).tiles == 4
    assert sw.sde_tile_plan(7, ((4, 8, 4), (4, 4))).tiles == 2


def test_plan_holds_wide_pairs_cotangents_in_shared_memory():
    """A wide pair (hidden 256): its leaves' cotangents in K10's shared
    memory, counted in its bytes, and 32 lanes a sum of 256 terms (more
    than ``SDE_CHAIN`` a lane)."""
    p = sw.sde_tile_plan(64, ((32, 256, 32), (32, 32)))
    nleaf = 2 * 32 * 256 + 256 + 32 + 32 * 32 + 32
    assert p.cw_smem == nleaf
    assert p.bwd_smem_bytes - p.fwd_smem_bytes > 4 * nleaf
    assert p.fwd_lanes == ((4, 32), (4,)) and p.bwd_lanes == ((32, 4), (4,))


@pytest.mark.parametrize("widths,match", [
    (((4, 8, 8, 8, 8, 4), (4, 4)), "1 to 4 layers"),
    (((4, 8, 4), (4, 4, 4, 4, 4, 4)), "1 to 4 layers"),
    (((4,), (4, 4)), "1 to 4 layers"),
    (((4, 8, 3), (4, 4)), "end at the state's width"),
    (((4, 8, 4), (3, 4)), "end at the state's width"),
    (((32, 4096, 32), (32, 32)), "shared memory")])
def test_plan_refuses_pairs_the_kernels_do_not_take(widths, match):
    with pytest.raises(ValueError, match=match):
        sw.sde_tile_plan(8, widths)


@pytest.mark.parametrize("K", [1, 7, 16, 17, 32, 50, 64, 100, 513])
def test_split_sums_are_the_f64_sum_rounded_once(K):
    """``_split_sum`` (the kernels' lanes, at most ``SDE_CHAIN`` terms a
    lane up to 32 lanes) rounds a float64 sum once: within one float32
    rounding of the float64 matmul, and its lanes as ``sde_lanes`` counts
    them."""
    g = torch.Generator().manual_seed(K)
    x, w, b = torch.randn(4, K, generator=g), torch.randn(5, K, generator=g), torch.randn(5, generator=g)
    got = sw._split_sum(x, w, sw.sde_lanes(K), b)
    ref = torch.addmm(b.double(), x.double(), w.double().t())
    assert got.dtype == torch.float32
    assert ((got.double() - ref).abs() <= 2 ** -24 * ref.abs() + 1e-12 * K).all()
    S = sw.sde_lanes(K)
    assert -(-K // S) <= sw.SDE_CHAIN or S == 32
    assert S == 1 or -(-K // (S // 2)) > sw.SDE_CHAIN


def test_warp_sum_is_the_xor_butterfly():
    """``_warp_sum`` adds lane l and lane l + 16, then + 8, ...: the order
    of the kernels' ``warp_sum``, every lane's result lane 0's."""
    v = torch.tensor([2.0 ** (-e) for e in range(32)], dtype=torch.float32)
    want = v.clone()
    for off in (16, 8, 4, 2, 1):
        want = torch.stack([want[l] + want[l ^ off] for l in range(32)])
    assert torch.equal(sw._warp_sum(v), want[0])
