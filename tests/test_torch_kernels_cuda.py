"""The port's CUDA kernels (K1/K2 step pair, K3/K4 whole solve for
MLPDynamics, AlternatingMLP and FFJORD's CSL dynamics, K7/K8 step pairs for
AlternatingMLP and CSL, K9/K10 the SDE whole solve of an MLP pair and of the
toy SDE's cubic pair, K11/K12 the lane-wise step of the per-sample engine,
K13/K14 the tuple step of ``odeint``'s generic engine, K15 the whole-solve
feature probe, and the weight-cotangent contraction that ends K2, K4, K12
and K14) against their plain PyTorch versions.

These tests need a CUDA device and ``nvcc`` (the kernels have no CPU mode)
and skip without one. This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from regneuralde_tpu_torch.ops import fused_csl as fc
from regneuralde_tpu_torch.ops import fused_generic as fg
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl
from regneuralde_tpu_torch.ops import ode
from regneuralde_tpu_torch.ops import sde as sde_ops
from regneuralde_tpu_torch.ops import sde_whole_solve as sw
from regneuralde_tpu_torch.ops import spike_wholesolve as sp
from regneuralde_tpu_torch.ops import weight_cotangents as wc
from regneuralde_tpu_torch.ops import whole_solve as ws
from regneuralde_tpu_torch.ops.controller import PIController

T, DT = 0.07, 0.11
CTRL = PIController.for_order(5)


def _inputs(batch, dim, hidden, device, seed=0, scale=1.0):
    """Seeded MLPDynamics leaves (weights at ``scale`` times LeCun's), y, a
    random k1 and the cotangents."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    leaves = [f32(rng.normal(size=(hidden, dim + 1)) * scale / np.sqrt(dim + 1)),
              f32(rng.normal(size=hidden) * 0.1),
              f32(rng.normal(size=(dim, hidden + 1)) * scale / np.sqrt(hidden + 1)),
              f32(rng.normal(size=dim) * 0.1)]
    y = f32(rng.normal(size=(batch, dim)) * 0.5)
    k1 = f32(rng.normal(size=(batch, dim)) * 0.3)
    cts = [f32(rng.normal(size=(batch, dim))), f32(rng.normal(size=(batch, dim))),
           f32(0.7), f32(1.3), f32(-0.4)]
    return y, k1, leaves, cts


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("shape", [(13, 40, 24), (5, 8, 5), (512, 784, 100)])
def test_kernels_match_plain_versions(cuda, shape, tol):
    """Ragged row tiles included (13 and 5 rows). Forward by relative
    Frobenius error <= 1e-4; backward <= 1e-3, since its seeds multiply
    by 1/(atol + |y| rtol) and amplify f32 rounding."""
    y, k1, leaves, cts = _inputs(*shape, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    parts = fm._split_params(*leaves)
    fm.reset_launches()
    kern = fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)
    plain = fm._reference_normed_sweep(t, dt, y, k1, parts, tol, tol)
    for a, b in zip(kern, plain):
        assert _rel(a, b) <= 1e-4
    kern_b = fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    plain_b = fm._normed_bwd_math(t, dt, y, k1, parts, cts, tol, tol)
    for a, b in zip([*kern_b[:4], *kern_b[4]], [*plain_b[:4], *plain_b[4]]):
        assert _rel(a, b) <= 1e-3
    assert fm.LAUNCHES == {"normed_tsit5_fwd": 1, "normed_tsit5_bwd": 1, "mlp_tsit5_fwd": 0,
                           "mlp_tsit5_bwd": 0}


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda):
    """Fixed-order sums: two launches give bitwise-equal results."""
    y, k1, leaves, cts = _inputs(64, 96, 32, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    a = fm.normed_sweep_fwd(t, dt, y, k1, leaves, 1e-6, 1e-6)
    b = fm.normed_sweep_fwd(t, dt, y, k1, leaves, 1e-6, 1e-6)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    ga = fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-6, 1e-6)
    gb = fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-6, 1e-6)
    assert all(torch.equal(u, v) for u, v in zip([*ga[:4], *ga[4]], [*gb[:4], *gb[4]]))


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda):
    y, k1, leaves, _ = _inputs(8, 16, 12, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(TypeError):
        fm.normed_sweep_fwd(t, dt, y.double(), k1, leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_fwd(t, dt, y.t(), k1, leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_fwd(t, dt, y, k1.cpu(), leaves, 1e-4, 1e-4)


def _solve_args(batch, dim, hidden, device, tol=1e-4, max_steps=96, seed=0, scale=1.0):
    """Seeded weights and initial state, and odeint's prologue over the
    plain MLP: the arguments of ``whole_solve_fwd``."""
    y0, _, leaves, _ = _inputs(batch, dim, hidden, device, seed, scale)
    parts = fm._split_params(*leaves)
    func = lambda t, y, _: fm._mlp_k(y, t, parts)[0]
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, (), tol, tol)
    return (t0, t1, dt0, y0, f0, leaves, tol, tol, CTRL, max_steps)


def _bwd_seeds(batch, dim, device, max_steps=96, seed=1):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return f32(rng.normal(size=(batch, dim))), f32(rng.normal(size=(4, max_steps)) * 0.1)


def _grad_groups(grads):
    """K4's outputs as compared: the three time scalars as one vector (one
    of them alone can be a cancellation of the others' size), ct_y0, ct_f0
    and the four weight cotangents (ct_ys_init, grads[5], is empty without
    saveat)."""
    return [torch.stack(grads[:3]), *grads[3:5], *grads[6:]]


GROUPS = ["ct_t0|ct_t1|ct_dt0", "ct_y0", "ct_f0", "cW1", "cb1", "cW2", "cb2"]


def _assert_k4_matches(rec, ns, ct_y1, ct_tel, args, hard_bound):
    """K4, its float32 plain version and a float64 plain walk over the same
    record: every output of K4 within 3 times the float32 plain version's
    distance from float64, plus 1e-5; with ``hard_bound``, also within
    1e-3 of the plain version on the well-conditioned outputs (all but
    ct_f0)."""
    t0, t1, leaves = args[0], args[1], args[5]
    d = lambda x: x.double()
    gk = ws.whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, 1e-4, 1e-4, CTRL)
    gp = ws.plain_whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, 1e-4, 1e-4,
                                  CTRL)
    g64 = ws.plain_whole_solve_bwd(ws.SolveRecord(*map(d, rec)), ns, d(ct_y1),
                                   d(ct_tel), d(t0), d(t1), [d(x) for x in leaves],
                                   1e-4, 1e-4, CTRL)
    for name, a, b, c in zip(GROUPS, *map(_grad_groups, (gk, gp, g64))):
        if hard_bound and name != "ct_f0":
            assert _rel(a, b) <= 1e-3, name
        assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5, (name, _rel(a, b), _rel(a, c),
                                                      _rel(b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 784, 100), (13, 40, 24), (1040, 64, 32)])
def test_whole_solve_kernels_match_plain_versions(cuda, shape):
    """K3 against its plain version at rtol=atol=1e-4: the same step
    counts and accept sequence, y1 within 1e-4 (relative Frobenius).

    K4, its float32 plain version and a float64 plain walk run over the
    same record (K3's). Seeded with a cotangent of y1 alone, K4 is held to
    its plain version within 1e-3 on the well-conditioned outputs (the
    time scalars, ct_y0 and the weights). Seeded with the telemetry too,
    the cotangents pass through 1/(atol + |y| rtol) and the error
    estimate's rounding floor, and float32 itself drifts from float64 by
    up to 1e-2 at the flagship shape (measured on the H100): every output
    of K4 is then held to within 3 times the float32 plain version's
    distance from float64, plus 1e-5. Batch 13 leaves a ragged tile; at
    1040 every block walks several tiles.

    The flagship shape runs at LeCun's scale (phase 5's inputs). The two
    reduced shapes draw their weights at three times that scale, which
    lifts the error estimate of every step but the last, clipped one from
    5e-5..3e-3 to 4e-3..3e-2 (as ``chip_smoke.py`` phase 12). At LeCun's
    scale the error estimate's cotangent there is the float32 rounding
    residual of the cotangents of t and dt_eff, so ct_f0 of any float32
    walk is noise: at 1040x64x32, with the cotangent of y1 alone, K4 and
    its plain version lie 4.6e-4 and 1.2e-4 from float64
    (``tools/torch_k4_trace.py``, H100)."""
    args = _solve_args(*shape, cuda, scale=1.0 if shape == (512, 784, 100) else 3.0)
    ws.reset_launches()
    rk = ws.whole_solve_fwd(*args)
    rp = ws.plain_whole_solve_fwd(*args)
    assert rk.final[3:].tolist() == rp.final[3:].tolist()
    assert rk.final[5].item() == 1.0
    assert torch.equal(rk.streams[ws.ST_ACC], rp.streams[ws.ST_ACC])
    assert _rel(rk.y1, rp.y1) <= 1e-4
    ns = int(rk.final[3:5].sum().item())
    ct_y1, ct_tel = _bwd_seeds(shape[0], shape[1], cuda)
    t0, t1, leaves = args[0], args[1], args[5]
    for tel in (torch.zeros_like(ct_tel), ct_tel):
        _assert_k4_matches(rk, ns, ct_y1, tel, args, hard_bound=not tel.any())
    assert ws.LAUNCHES == {"whole_solve_fwd": 1, "whole_solve_bwd": 2,
                           "whole_solve_altmlp_fwd": 0, "whole_solve_altmlp_bwd": 0,
                           "whole_solve_csl_fwd": 0, "whole_solve_csl_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("t1, max_steps", [(1.0, 2), (0.0, 96)])
def test_whole_solve_kernels_edge_cases(cuda, t1, max_steps):
    """A solve cut short by max_steps (not done) and one over an empty
    span (no trial step, an empty weight-row buffer): the same counts as
    the plain versions; y1 of the empty span is y0. Two solves cut short
    stop at times that differ by their dt drift (the error sums near their
    float32 floor move dt by ~1%), so there y1 is held to K1's plain
    version on the last stored step (rtol 1e-4, as K1). Cut short, y1
    depends on the step sizes at first order, so its cotangent reaches
    the error sums through the controller at small eest, where float32 is
    ill-conditioned: K4 is held to a float64 walk of the same record as
    closely as its float32 plain version is (``_assert_k4_matches``)."""
    args = list(_solve_args(64, 40, 24, cuda, max_steps=max_steps))
    args[1] = torch.tensor(t1, device=cuda)
    rk, rp = ws.whole_solve_fwd(*args), ws.plain_whole_solve_fwd(*args)
    assert rk.final[3:].tolist() == rp.final[3:].tolist()
    ns = int(rk.final[3:5].sum().item())
    if t1 == 0.0:
        assert rk.final[5].item() == 1.0 and ns == 0 and torch.equal(rk.y1, args[3])
    else:
        assert rk.final[5].item() == 0.0 and ns == max_steps
        st, i = rk.streams, ns - 1
        if st[ws.ST_ACC, i] > 0.5:
            want = fm._reference_normed_sweep(st[ws.ST_T, i], st[ws.TEL_DT, i], rk.hy[i],
                                              rk.hf[i], fm._split_params(*args[5]),
                                              1e-4, 1e-4)[0]
        else:
            want = rk.hy[i]
        assert _rel(rk.y1, want) <= 1e-4
    ct_y1, ct_tel = _bwd_seeds(64, 40, cuda, max_steps)
    _assert_k4_matches(rk, ns, ct_y1, torch.zeros_like(ct_tel), args,
                       hard_bound=t1 == 0.0)


@pytest.mark.cuda
def test_whole_solve_kernels_are_deterministic(cuda):
    """Fixed-order sums, no atomics: two runs are bitwise equal, with
    several tiles per block (batch 1040)."""
    args = _solve_args(1040, 64, 32, cuda)
    a, b = ws.whole_solve_fwd(*args), ws.whole_solve_fwd(*args)
    ns = int(a.final[3:5].sum().item())
    assert torch.equal(a.final, b.final) and torch.equal(a.streams, b.streams)
    assert torch.equal(a.hy[:ns + 1], b.hy[:ns + 1]) and torch.equal(a.y1, b.y1)
    ct_y1, ct_tel = _bwd_seeds(1040, 64, cuda)
    rest = (ct_y1, ct_tel, args[0], args[1], args[5], 1e-4, 1e-4, CTRL)
    ga, gb = ws.whole_solve_bwd(a, ns, *rest), ws.whole_solve_bwd(a, ns, *rest)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 40, 24), (13, 40, 24), (512, 784, 100)])
def test_whole_solve_stream_rows_match_plain_capture(cuda, shape):
    """K3's streamed stage residuals, teacher-forced: row ``i`` of ``ks``
    and ``hs`` within 1e-4 (relative Frobenius, as K1's rows) of the plain
    capture ``fm._reference_normed_sweep_res`` on trial step ``i``'s own
    stored inputs, rejected steps included (the first trial step tries the
    whole span and is rejected). Batch 13 leaves a ragged tile. The
    flagship shape runs at its tolerance, 1.4e-8, and LeCun's scale (at
    1e-4 it takes the whole span in one step), the others at 1e-4 and
    three times that scale."""
    flagship = shape[0] == 512
    args = list(_solve_args(*shape, cuda, tol=1.4e-8 if flagship else 1e-4,
                            scale=1.0 if flagship else 3.0))
    args[2] = args[1] - args[0]
    rec = ws.whole_solve_fwd(*args)
    ns = int(rec.final[3:5].sum().item())
    st = rec.streams
    assert st[ws.ST_ACC, 0].item() == 0.0 and rec.final[5].item() == 1.0
    assert rec.ks.shape == (96, 6, shape[0], shape[1])
    assert rec.hs.shape == (96, 6, shape[0], shape[2])
    parts = fm._split_params(*args[5])
    for i in range(ns):
        _, (ks, hs) = fm._reference_normed_sweep_res(st[ws.ST_T, i], st[ws.TEL_DT, i],
                                                     rec.hy[i], rec.hf[i], parts, *args[6:8])
        assert _rel(rec.ks[i], torch.stack(ks[1:])) <= 1e-4, i
        assert _rel(rec.hs[i], torch.stack(hs)) <= 1e-4, i


@pytest.mark.cuda
@pytest.mark.parametrize("saves", [False, True])
@pytest.mark.parametrize("shape", [(64, 40, 24), (13, 40, 24)])
def test_whole_solve_stream_backward_is_replay(cuda, shape, saves):
    """K4 on K3's stage residuals against K4 replaying the stages
    (``cache_residuals=False``) on the same record and cotangents (y1, the
    telemetry, and with 4 saves theirs): every output bitwise. Batch 13
    leaves a ragged tile, whose rows past the batch end the stream does
    not hold."""
    args = _solve_args(*shape, cuda, scale=3.0)
    kw, bkw = {}, {}
    if saves:
        sa, ys_init = ode.saveat_rows(torch.tensor([0.25, 0.5, 0.75, 1.0], device=cuda),
                                      args[0], args[1], args[3])
        kw = dict(saveat=sa, ys_init=ys_init)
    rec = ws.whole_solve_fwd(*args, **kw)
    ns = int(rec.final[3:5].sum().item())
    ct_y1, ct_tel = _bwd_seeds(shape[0], shape[1], cuda)
    if saves:
        bkw = dict(saveat=kw["saveat"], ct_ys=_bwd_seeds(4 * shape[0], shape[1], cuda,
                                                         seed=2)[0].view(rec.ys.shape))
    rest = (ct_y1, ct_tel, args[0], args[1], args[5], 1e-4, 1e-4, CTRL)
    ws.reset_launches()
    streamed = ws.whole_solve_bwd(rec, ns, *rest, **bkw)
    replay = ws.whole_solve_bwd(rec, ns, *rest, **bkw, cache_residuals=False)
    assert ws.LAUNCHES["whole_solve_bwd"] == 2
    for a, b in zip(streamed, replay):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_whole_solve_stream_is_deterministic(cuda):
    """The streamed pair run twice: K3's record, its stage residuals
    included, and K4's outputs on it bitwise equal, with several tiles per
    block (batch 1040)."""
    args = _solve_args(1040, 64, 32, cuda)
    a, b = ws.whole_solve_fwd(*args), ws.whole_solve_fwd(*args)
    ns = int(a.final[3:5].sum().item())
    assert torch.equal(a.streams, b.streams) and torch.equal(a.y1, b.y1)
    assert torch.equal(a.ks[:ns], b.ks[:ns]) and torch.equal(a.hs[:ns], b.hs[:ns])
    ct_y1, ct_tel = _bwd_seeds(1040, 64, cuda)
    rest = (ct_y1, ct_tel, args[0], args[1], args[5], 1e-4, 1e-4, CTRL)
    ga, gb = ws.whole_solve_bwd(a, ns, *rest), ws.whole_solve_bwd(b, ns, *rest)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 13, 512])
@pytest.mark.parametrize("dim, hidden, saves", [(40, 24, True), (784, 100, False)])
def test_mlp_walk_matches_plain_version(cuda, batch, dim, hidden, saves):
    """K4's walk (``csrc/mlp_walk.cuh``) against ``plain_whole_solve_bwd`` on
    K3's record at rtol=atol=1e-4: one row (a tile of 1 live row), a ragged
    tile (13) and the flagship's batch, at 40x24 with 4 saves (weights at
    three times LeCun's scale, as phase 12) and at 784x100 without (LeCun's
    scale, as phase 5). Seeded with the rows' cotangents (y1, and ys), every
    output but ct_f0 within 1e-3 of the plain version; with the telemetry's
    too, every output within 3 times the float32 plain version's distance
    from a float64 walk of the same record, plus 1e-5. One launch a call,
    bitwise the same twice."""
    args = _solve_args(batch, dim, hidden, cuda, scale=3.0 if saves else 1.0)
    kw, bkw = {}, {}
    if saves:
        sa, ys_init = ode.saveat_rows(torch.tensor([0.25, 0.5, 0.75, 1.0], device=cuda),
                                      args[0], args[1], args[3])
        kw = dict(saveat=sa, ys_init=ys_init)
    rec = ws.whole_solve_fwd(*args, **kw)
    ns = int(rec.final[3:5].sum().item())
    assert rec.final[5].item() == 1.0 and ns >= 1
    ct_y1, ct_tel = _bwd_seeds(batch, dim, cuda)
    if saves:
        bkw = dict(saveat=sa, ct_ys=_bwd_seeds(4 * batch, dim, cuda, seed=2)[0].view(
            rec.ys.shape))
    t0, t1, leaves = args[0], args[1], args[5]
    d = lambda x: x.double()
    rec64 = ws.SolveRecord(*map(d, rec))
    bkw64 = {k: d(v) for k, v in bkw.items()}
    for tel in (torch.zeros_like(ct_tel), ct_tel):
        rest = (ns, ct_y1, tel, t0, t1, leaves, 1e-4, 1e-4, CTRL)
        ws.reset_launches()
        gk = ws.whole_solve_bwd(rec, *rest, **bkw)
        assert ws.LAUNCHES["whole_solve_bwd"] == 1
        assert all(torch.equal(a, b) for a, b in zip(gk, ws.whole_solve_bwd(rec, *rest, **bkw)))
        gp = ws.plain_whole_solve_bwd(rec, *rest, **bkw)
        g64 = ws.plain_whole_solve_bwd(rec64, ns, d(ct_y1), d(tel), d(t0), d(t1),
                                       [d(x) for x in leaves], 1e-4, 1e-4, CTRL, **bkw64)
        names = GROUPS + (["ct_ys_init"] if saves else [])
        tails = [[g[5]] if saves else [] for g in (gk, gp, g64)]
        for name, a, b, c in zip(names, *(_grad_groups(g) + t for g, t in
                                          zip((gk, gp, g64), tails))):
            if not tel.any() and name != "ct_f0":
                assert _rel(a, b) <= 1e-3, (name, _rel(a, b))
            assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5, (name, _rel(a, b), _rel(a, c),
                                                          _rel(b, c))


@pytest.mark.cuda
def test_mlp_walk_in_row_chunks_matches_plain_version(cuda, monkeypatch):
    """K4's walk on the plan of a card of 4 multiprocessors: 4 tiles, the
    batch of 256 walked in row chunks one after another. Held as
    ``test_whole_solve_kernels_match_plain_versions`` holds it, with the
    cotangents of y1 and then of the telemetry too."""
    plan = ws.walk_plan

    def small_card(B, D, H, sms, limit=ws.SMEM_LIMIT):
        return plan(B, D, H, 4, limit)

    monkeypatch.setattr(ws, "walk_plan", small_card)
    assert ws.walk_plan(256, 64, 32, 132).chunks > 1
    args = _solve_args(256, 64, 32, cuda, scale=3.0)
    rk = ws.whole_solve_fwd(*args)
    ns = int(rk.final[3:5].sum().item())
    ct_y1, ct_tel = _bwd_seeds(256, 64, cuda)
    for tel in (torch.zeros_like(ct_tel), ct_tel):
        _assert_k4_matches(rk, ns, ct_y1, tel, args, hard_bound=not tel.any())


def _assert_k3_matches(rk, rp, args):
    """K3 for MLPDynamics against its plain version on the same inputs: the
    same step counts and accept sequence, the solve done, y1 within 1e-4;
    every stored trial step's streamed stage residuals within 1e-4 of the
    plain capture on the step's own stored inputs (teacher-forced)."""
    assert rk.final[3:].tolist() == rp.final[3:].tolist() and rk.final[5].item() == 1.0
    assert torch.equal(rk.streams[ws.ST_ACC], rp.streams[ws.ST_ACC])
    assert _rel(rk.y1, rp.y1) <= 1e-4
    st, parts = rk.streams, fm._split_params(*args[5])
    for i in range(int(rk.final[3:5].sum().item())):
        _, (ks, hs) = fm._reference_normed_sweep_res(st[ws.ST_T, i], st[ws.TEL_DT, i],
                                                     rk.hy[i], rk.hf[i], parts, *args[6:8])
        assert _rel(rk.ks[i], torch.stack(ks[1:])) <= 1e-4, i
        assert _rel(rk.hs[i], torch.stack(hs)) <= 1e-4, i


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 784, 100), (96, 200, 48)])
def test_mlp_solve_matches_plain_version(cuda, shape):
    """K3 for MLPDynamics (``csrc/mlp_solve.cuh``) on ``walk_plan``'s tiles,
    several column blocks at each shape (8 of 100 columns at the flagship,
    7 of 32 at 96x200x48), against ``plain_whole_solve_fwd`` at
    rtol=atol=1e-4 (``_assert_k3_matches``); one launch, bitwise the same
    twice. The reduced shape draws its weights at three times LeCun's scale,
    so it takes several trial steps."""
    args = _solve_args(*shape, cuda, scale=1.0 if shape[0] == 512 else 3.0)
    plan = ws.walk_plan(*shape, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert plan.col_blocks > 1 and plan.chunks == 1
    ws.reset_launches()
    rk = ws.whole_solve_fwd(*args)
    assert ws.LAUNCHES["whole_solve_fwd"] == 1
    _assert_k3_matches(rk, ws.plain_whole_solve_fwd(*args), args)
    again = ws.whole_solve_fwd(*args)
    ns = int(rk.final[3:5].sum().item())
    assert torch.equal(rk.streams, again.streams) and torch.equal(rk.hy[:ns + 1],
                                                                  again.hy[:ns + 1])
    assert torch.equal(rk.ks[:ns], again.ks[:ns]) and torch.equal(rk.hs[:ns], again.hs[:ns])


@pytest.mark.cuda
def test_mlp_solve_in_row_chunks_matches_plain_version(cuda, monkeypatch):
    """K3 on the plan of a card of 4 multiprocessors: 4 tiles, each trial
    step solved in row chunks one after another. Held to its plain version
    as ``test_mlp_solve_matches_plain_version`` holds it, and K4 on its
    stream bitwise K4 replaying the stages on the same chunks."""
    plan = ws.walk_plan

    def small_card(B, D, H, sms, limit=ws.SMEM_LIMIT):
        return plan(B, D, H, 4, limit)

    monkeypatch.setattr(ws, "walk_plan", small_card)
    assert ws.walk_plan(256, 64, 32, 132).chunks > 1
    args = _solve_args(256, 64, 32, cuda, scale=3.0)
    rk = ws.whole_solve_fwd(*args)
    _assert_k3_matches(rk, ws.plain_whole_solve_fwd(*args), args)
    ns = int(rk.final[3:5].sum().item())
    ct_y1, ct_tel = _bwd_seeds(256, 64, cuda)
    rest = (ct_y1, ct_tel, args[0], args[1], args[5], 1e-4, 1e-4, CTRL)
    streamed = ws.whole_solve_bwd(rk, ns, *rest)
    replay = ws.whole_solve_bwd(rk, ns, *rest, cache_residuals=False)
    assert all(torch.equal(a, b) for a, b in zip(streamed, replay))


@pytest.mark.cuda
def test_whole_solve_wrappers_refuse_bad_inputs(cuda):
    args = list(_solve_args(8, 16, 12, cuda))
    y0 = args[3]
    for bad, err in ((y0.double(), TypeError), (y0.t().contiguous().t(), ValueError),
                     (y0.cpu(), ValueError)):
        with pytest.raises(err):
            ws.whole_solve_fwd(*args[:4], bad, *args[5:])
    rec = ws.whole_solve_fwd(*args)
    ns = int(rec.final[3:5].sum().item())
    ct_y1, ct_tel = _bwd_seeds(8, 16, cuda)
    rest = (args[0], args[1], args[5], 1e-4, 1e-4, CTRL)
    with pytest.raises(ValueError):
        ws.whole_solve_bwd(rec, ns, ct_y1, ct_tel.t().contiguous().t(), *rest)
    with pytest.raises(ValueError):
        ws.whole_solve_bwd(rec, ns, ct_y1, ct_tel.cpu(), *rest)
    with pytest.raises(TypeError):
        ws.whole_solve_bwd(rec, ns, ct_y1.double(), ct_tel, *rest)
    # the streamed backward takes no record without the stage residuals
    bare = ws.whole_solve_fwd(*args, cache_residuals=False)
    with pytest.raises(ValueError, match="stage residuals"):
        ws.whole_solve_bwd(bare, ns, ct_y1, ct_tel, *rest)


@pytest.mark.cuda
def test_fused_true_trains_through_the_whole_solve_kernels(cuda):
    """``NeuralODE(fused=True)`` against ``fused=False`` on the card, at
    rtol=atol=1e-4: the same NFE and accept sequence, y1 within 1e-4 and
    the gradients of sum(y1^2) within 1e-3 (relative); one launch per
    direction and no step kernel. (The error estimate's gradient sits at
    its float32 rounding floor at this size; chip_smoke.py phase 6 holds
    the regularized gradient at full width.)"""
    from regneuralde_tpu_torch.models import MLPDynamics, NeuralODE

    outs = {}
    for fused in (True, False):
        gen = torch.Generator().manual_seed(0)
        node = NeuralODE(MLPDynamics(40, 24, device=cuda, generator=gen), rtol=1e-4,
                         atol=1e-4, max_steps=96, fused=fused)
        x = torch.rand(13, 40, generator=gen).to(cuda)
        ws.reset_launches()
        fm.reset_launches()
        out = node(x)
        grads = torch.autograd.grad(out.value.square().sum(), list(node.parameters()))
        outs[fused] = (out, grads, {**ws.LAUNCHES, **fm.LAUNCHES})
    (a, ga, la), (b, gb, _) = outs[True], outs[False]
    assert la == {"whole_solve_fwd": 1, "whole_solve_bwd": 1, "normed_tsit5_fwd": 0,
                  "normed_tsit5_bwd": 0, "mlp_tsit5_fwd": 0, "mlp_tsit5_bwd": 0,
                  "whole_solve_altmlp_fwd": 0,
                  "whole_solve_altmlp_bwd": 0, "whole_solve_csl_fwd": 0,
                  "whole_solve_csl_bwd": 0}
    assert a.nfe == b.nfe and torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    assert _rel(a.value, b.value) <= 1e-4
    for u, v in zip(ga, gb):
        assert _rel(u, v) <= 1e-3


def _alt_inputs(batch, dim, hidden, depth, device, seed=0):
    """AlternatingMLP leaves (nn.Linear layout), y, a random k1 (keeps the
    embedded error far above its rounding floor) and the cotangents."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    leaves = []
    for _ in range(depth):
        leaves += [f32(rng.normal(size=(hidden, dim)) / np.sqrt(dim)),
                   f32(rng.normal(size=hidden) * 0.1),
                   f32(rng.normal(size=(dim, hidden)) / np.sqrt(hidden)),
                   f32(rng.normal(size=dim) * 0.1)]
    y = f32(rng.normal(size=(batch, dim)) * 0.5)
    k1 = f32(rng.normal(size=(batch, dim)) * 0.3)
    cts = [f32(rng.normal(size=(batch, dim))), f32(rng.normal(size=(batch, dim))),
           f32(0.7), f32(1.3), f32(-0.4)]
    return y, k1, leaves, cts


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("shape", [(256, 20, 50, 4), (13, 20, 50, 4), (7, 6, 10, 2)])
def test_altmlp_kernels_match_plain_versions(cuda, shape, tol):
    """K7/K8 against their plain versions at the latent shape, a ragged
    batch (13 rows: the last tile half empty) and a small one. Forward by
    relative Frobenius error <= 1e-4; backward <= 1e-3 (its seeds multiply
    by 1/(atol + |y| rtol) and amplify float32 rounding); ct_t exactly 0."""
    y, k1, leaves, cts = _alt_inputs(*shape, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    fg.reset_launches()
    kern = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    plain = fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    for a, b in zip(kern, plain):
        assert _rel(a, b) <= 1e-4
    kern_b = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    plain_b = fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)
    assert kern_b[0].item() == 0.0
    for a, b in zip([*kern_b[1:4], *kern_b[4]], [*plain_b[1:4], *plain_b[4]]):
        assert _rel(a, b) <= 1e-3
    assert fg.LAUNCHES == {"altmlp_tsit5_fwd": 1, "altmlp_tsit5_bwd": 1}


@pytest.mark.cuda
def test_altmlp_kernels_are_deterministic(cuda):
    """Fixed-order sums and per-block weight-cotangent slots, no atomics:
    two launches give bitwise-equal results."""
    y, k1, leaves, cts = _alt_inputs(256, 20, 50, 4, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    a = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, 1e-6, 1e-6)
    b = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, 1e-6, 1e-6)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    ga = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-6, 1e-6)
    gb = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-6, 1e-6)
    assert all(torch.equal(u, v) for u, v in zip([*ga[:4], *ga[4]], [*gb[:4], *gb[4]]))


@pytest.mark.cuda
def test_altmlp_wrappers_refuse_bad_inputs(cuda):
    y, k1, leaves, cts = _alt_inputs(8, 20, 50, 4, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(TypeError):
        fg.altmlp_normed_sweep(t, dt, y.double(), k1, leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fg.altmlp_normed_sweep(t, dt, y, k1.t().contiguous().t(), leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fg.altmlp_normed_sweep(t, dt, y, k1.cpu(), leaves, 1e-4, 1e-4)
    bad = list(leaves)
    bad[2] = bad[2].t().contiguous().t()  # down_0.weight, strided
    with pytest.raises(ValueError):
        fg.altmlp_normed_sweep(t, dt, y, k1, bad, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, [cts[0].cpu(), *cts[1:]],
                                   1e-4, 1e-4)
    with pytest.raises(TypeError):
        fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, [cts[0], cts[1].double(),
                                                          *cts[2:]], 1e-4, 1e-4)


@pytest.mark.cuda
def test_fused_step_trains_the_latent_node_through_k7_k8(cuda):
    """``NeuralODE(AlternatingMLP, fused="step", saveat=...)`` against
    ``fused=False`` on the card at rtol=atol=1e-5: the same NFE and accept
    sequence, the trajectory within 1e-4 and the gradients of its weighted
    square within 1e-3 (relative); one K7 and one K8 launch per trial step."""
    from regneuralde_tpu_torch.models import AlternatingMLP, NeuralODE

    sa = torch.tensor([0.0, 0.1, 0.35, 0.6, 0.9, 1.0], device=cuda)
    outs = {}
    for fused in ("step", False):
        gen = torch.Generator().manual_seed(0)
        node = NeuralODE(AlternatingMLP(20, 50, 4, device=cuda, generator=gen),
                         time_dep=False, rtol=1e-5, atol=1e-5, max_steps=256,
                         saveat=sa, fused=fused)
        x = torch.randn(37, 20, generator=gen).to(cuda)
        fg.reset_launches()
        out = node(x)
        w = torch.arange(1.0, 7.0, device=cuda)[None, :, None]
        grads = torch.autograd.grad((w * out.value.square()).sum(),
                                    list(node.parameters()))
        outs[fused] = (out, grads, dict(fg.LAUNCHES))
    (a, ga, la), (b, gb, lb) = outs["step"], outs[False]
    n = int(a.telemetry.live.sum())
    assert la == {"altmlp_tsit5_fwd": n, "altmlp_tsit5_bwd": n}
    assert lb == {"altmlp_tsit5_fwd": 0, "altmlp_tsit5_bwd": 0}
    assert a.nfe == b.nfe and torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    assert a.value.shape == (37, 6, 20) and torch.equal(a.value[:, 0], b.value[:, 0])
    assert _rel(a.value, b.value) <= 1e-4
    for u, v in zip(ga, gb):
        assert _rel(u, v) <= 1e-3


def _alt_solve_args(batch, device, tol=1e-5, max_steps=256, seed=0, n_save=49):
    """Seeded AlternatingMLP(20, 50, 4) weights, y0, odeint's prologue and a
    sorted save grid from t0 (the latent cell's kind): the arguments and
    keywords of ``whole_solve_fwd``."""
    y0, _, leaves, _ = _alt_inputs(batch, 20, 50, 4, device, seed)
    func = fg.alternating_mlp_apply(4)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, tuple(leaves), tol, tol)
    rng = np.random.default_rng(seed + 7)
    sa = np.sort(np.concatenate([[0.0], rng.uniform(0.0, 1.0, n_save - 1)]))
    sa, ys_init = ode.saveat_rows(torch.tensor(sa, dtype=torch.float32, device=device),
                                  t0, t1, y0)
    return ((t0, t1, dt0, y0, f0, leaves, tol, tol, CTRL, max_steps),
            dict(dynamics="altmlp", saveat=sa, ys_init=ys_init))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [256, 13])
def test_whole_solve_altmlp_kernels_match_plain_versions(cuda, batch):
    """K3/K4 for AlternatingMLP with 49 saves at the latent width (and a
    ragged batch of 13) against their plain versions at rtol=atol=1e-5: the
    same step counts, accept sequence and save cursors; y1 and the saves
    within 1e-6; every stored trial step's norm sums and rows bitwise equal
    to K7's on its inputs. K4 over K3's record, seeded with cotangents of
    y1 and the saves: within 1e-3 of its plain version on all but ct_f0,
    and every output but ct_f0 within 3 times the float32 plain version's
    distance from a float64 walk, plus 1e-5 (``_assert_k4_matches`` says
    why not ct_f0); seeded with the telemetry too, every output within that
    distance; the cotangent of the rows K3 wrote is consumed, the others
    pass on to ys_init."""
    args, kw = _alt_solve_args(batch, cuda)
    ws.reset_launches()
    rk = ws.whole_solve_fwd(*args, **kw)
    rp = ws.plain_whole_solve_fwd(*args, **kw)
    assert rk.final[3:].tolist() == rp.final[3:].tolist() and rk.final[5].item() == 1.0
    assert torch.equal(rk.streams[ws.ST_ACC], rp.streams[ws.ST_ACC])
    assert torch.equal(rk.cursors, rp.cursors) and rk.cursors.tolist() == [1, 49]
    assert _rel(rk.y1, rp.y1) <= 1e-6 and _rel(rk.ys, rp.ys) <= 1e-6
    assert torch.equal(rk.ys[0], args[3])
    ns = int(rk.final[3:5].sum().item())
    t0, t1, leaves = args[0], args[1], args[5]
    for i in range(ns):
        t, dt = rk.streams[ws.ST_T, i], rk.streams[ws.ST_DT, i]
        dt_eff = torch.where(dt - (t1 - t) >= 0, t1 - t, dt)
        res = fg.altmlp_normed_sweep(t, dt_eff, rk.hy[i], rk.hf[i], leaves, 1e-5, 1e-5)
        assert torch.equal(torch.stack(res[2:]), rk.streams[ws.ST_E:ws.ST_ACC, i])
        assert torch.equal(res.y_new, rk.hy[i + 1]) and torch.equal(res.k_last, rk.hf[i + 1])
    rng = np.random.default_rng(3)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)
    ct_y1, ct_ys = f32(rng.normal(size=(batch, 20))), f32(rng.normal(size=(49, batch, 20)))
    ct_tel = f32(rng.normal(size=(4, 256)) * 0.1)
    d = lambda x: x.double()
    bkw = dict(dynamics="altmlp", saveat=kw["saveat"], ct_ys=ct_ys)
    names = ["ct_t0|ct_t1|ct_dt0", "ct_y0", "ct_f0", "ct_ys_init", "leaves"]
    group = lambda g: [torch.stack(g[:3]), *g[3:6], torch.cat([x.flatten() for x in g[6:]])]
    for tel in (torch.zeros_like(ct_tel), ct_tel):
        gk = ws.whole_solve_bwd(rk, ns, ct_y1, tel, t0, t1, leaves, 1e-5, 1e-5, CTRL, **bkw)
        gp = ws.plain_whole_solve_bwd(rk, ns, ct_y1, tel, t0, t1, leaves, 1e-5, 1e-5, CTRL,
                                      **bkw)
        g64 = ws.plain_whole_solve_bwd(
            ws.SolveRecord(*map(d, rk)), ns, d(ct_y1), d(tel), d(t0), d(t1),
            [d(x) for x in leaves], 1e-5, 1e-5, CTRL, dynamics="altmlp",
            saveat=d(kw["saveat"]), ct_ys=d(ct_ys))
        for name, a, b, c in zip(names, group(gk), group(gp), group(g64)):
            if not tel.any() and name != "ct_f0":
                assert _rel(a, b) <= 1e-3, name
            if tel.any() or name != "ct_f0":
                assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5, (name, _rel(a, b), _rel(a, c))
        assert not gk[5][1:].any() and torch.equal(gk[5][0], ct_ys[0])
    assert ws.LAUNCHES == {"whole_solve_fwd": 0, "whole_solve_bwd": 0,
                           "whole_solve_altmlp_fwd": 1, "whole_solve_altmlp_bwd": 2,
                           "whole_solve_csl_fwd": 0, "whole_solve_csl_bwd": 0}


@pytest.mark.cuda
def test_whole_solve_altmlp_kernels_are_deterministic(cuda):
    """Per-tile slots summed in tile order, per-block weight-cotangent
    slots summed in block order, no atomics: two runs are bitwise equal."""
    args, kw = _alt_solve_args(256, cuda)
    a, b = ws.whole_solve_fwd(*args, **kw), ws.whole_solve_fwd(*args, **kw)
    ns = int(a.final[3:5].sum().item())
    for x, y in ((a.final, b.final), (a.streams, b.streams), (a.ys, b.ys), (a.y1, b.y1),
                 (a.hy[:ns + 1], b.hy[:ns + 1]), (a.cursors, b.cursors)):
        assert torch.equal(x, y)
    rng = np.random.default_rng(4)
    ct_y1 = torch.tensor(rng.normal(size=(256, 20)), dtype=torch.float32, device=cuda)
    ct_ys = torch.tensor(rng.normal(size=(49, 256, 20)), dtype=torch.float32, device=cuda)
    ct_tel = torch.zeros(4, 256, device=cuda)
    rest = (ct_y1, ct_tel, args[0], args[1], args[5], 1e-5, 1e-5, CTRL)
    bkw = dict(dynamics="altmlp", saveat=kw["saveat"], ct_ys=ct_ys)
    ga, gb = ws.whole_solve_bwd(a, ns, *rest, **bkw), ws.whole_solve_bwd(a, ns, *rest, **bkw)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


@pytest.mark.cuda
def test_whole_solve_altmlp_wrappers_refuse_bad_inputs(cuda):
    args, kw = _alt_solve_args(8, cuda)
    sa, ys_init = kw["saveat"], kw["ys_init"]
    for bad in (dict(saveat=sa.double()), dict(ys_init=ys_init[:, :4]),
                dict(ys_init=ys_init.cpu())):
        with pytest.raises(ValueError):
            ws.whole_solve_fwd(*args, **{**kw, **bad})
    bad_leaves = list(args[5])
    bad_leaves[2] = bad_leaves[2].t().contiguous().t()  # down_0.weight, strided
    with pytest.raises(ValueError):
        ws.whole_solve_fwd(*args[:5], bad_leaves, *args[6:], **kw)
    rec = ws.whole_solve_fwd(*args, **kw)
    ns = int(rec.final[3:5].sum().item())
    rest = (torch.zeros(8, 20, device=cuda), torch.zeros(4, 256, device=cuda), args[0],
            args[1], args[5], 1e-5, 1e-5, CTRL)
    for bad in (torch.zeros(49, 8, 20), torch.zeros(48, 8, 20, device=cuda)):
        with pytest.raises(ValueError):
            ws.whole_solve_bwd(rec, ns, *rest, dynamics="altmlp", saveat=sa, ct_ys=bad)


# the latent shape, ragged batches (a last tile of one row), small widths
# (the generic instance) and depths 1 and 8
ALT_FWD_SHAPES = [(256, 20, 50, 4), (13, 20, 50, 4), (7, 6, 10, 2), (37, 5, 7, 3),
                  (40, 20, 50, 1), (40, 20, 50, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-5, 1.4e-8])
@pytest.mark.parametrize("shape", ALT_FWD_SHAPES)
def test_altmlp_fwd_matches_its_schedule(cuda, shape, tol):
    """K7 (the forward tile body, 2-row tiles, the latent widths compiled
    as constants, any other at run time) bitwise: y_new and k7 equal the
    plain version's and its schedule's (``fg.plain_altmlp_fwd_tiles``: the
    kernel's split float64 sums), the three sums the schedule's; ceil(B/2)
    blocks, one launch."""
    batch, dim, hidden, depth = shape
    y, k1, leaves, _ = _alt_inputs(*shape, cuda, seed=batch + depth)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    fg.reset_launches()
    kern = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    plain = fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    sched = fg.plain_altmlp_fwd_tiles(t, dt, y, k1, leaves, tol, tol)
    assert torch.equal(kern.y_new, plain.y_new) and torch.equal(kern.k_last, plain.k_last)
    for a, b in zip(kern, sched):
        assert torch.equal(a, b), (a.flatten()[:4], b.flatten()[:4])
    assert fg.LAUNCHES == {"altmlp_tsit5_fwd": 1, "altmlp_tsit5_bwd": 0}
    assert fg.altmlp_fwd_plan(batch, dim, hidden, depth).tiles == -(-batch // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", range(1, 9))
def test_altmlp_fwd_takes_every_depth(cuda, depth):
    """Every depth K7 takes (1 to 8) runs at the latent width, its rows and
    sums bitwise its schedule's."""
    y, k1, leaves, _ = _alt_inputs(64, 20, 50, depth, cuda, seed=depth)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    kern = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, 1e-5, 1e-5)
    sched = fg.plain_altmlp_fwd_tiles(t, dt, y, k1, leaves, 1e-5, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(kern, sched))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 20, 50, 4), (13, 20, 50, 4), (37, 5, 7, 3)])
def test_altmlp_fwd_is_bitwise_deterministic(cuda, shape):
    """K7's slots are summed in a fixed order (no atomics): three launches
    on the same inputs are bitwise equal, a ragged batch's and the generic
    instance's too."""
    y, k1, leaves, _ = _alt_inputs(*shape, cuda, seed=3)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    runs = [fg.altmlp_normed_sweep(t, dt, y, k1, leaves, 1.4e-8, 1.4e-8) for _ in range(3)]
    for r in runs[1:]:
        assert all(torch.equal(u, v) for u, v in zip(runs[0], r))


@pytest.mark.cuda
def test_altmlp_fwd_plan_is_the_librarys(cuda):
    """``fg.altmlp_fwd_plan``'s rows, slot rows and shared memory are the
    library's at every width and depth the card tests run, K3's partials
    take its slot rows (``ws._slot_rows``), and both forward wrappers (K7's
    and K3's) refuse widths the body does not hold with a ValueError."""
    from regneuralde_tpu_torch.ops import _cuda

    lib = _cuda.library()
    for D, H, depth in [(20, 50, d) for d in range(1, 9)] + [(6, 10, 2), (5, 7, 3),
                                                             (20, 300, 4)]:
        plan = fg.check_fwd_plan(lib, D, H, depth)
        assert (plan.rows, plan.slot_rows) == (2, 2) and plan.smem_bytes <= fg.SMEM_LIMIT
    assert ws._slot_rows(lib, "altmlp") == 2
    y, k1, leaves, _ = _alt_inputs(16, 20, 1000, 4, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(ValueError, match="forward tile body holds at most"):
        fg.altmlp_normed_sweep(t, dt, y, k1, leaves, 1e-5, 1e-5)
    with pytest.raises(ValueError, match="forward tile body holds at most"):
        ws.whole_solve_fwd(torch.tensor(0.0, device=cuda), torch.tensor(1.0, device=cuda),
                           torch.tensor(0.01, device=cuda), y, k1, leaves, 1e-5, 1e-5, CTRL,
                           8, dynamics="altmlp")


@pytest.mark.cuda
@pytest.mark.parametrize("batch, saves, tol", [(256, True, 1.4e-8), (256, False, 1e-5),
                                               (13, True, 1e-5)])
def test_whole_solve_altmlp_steps_are_k7s(cuda, batch, saves, tol):
    """K3 for AlternatingMLP runs K7's forward body, one 2-row tile a block
    of its cooperative grid: every stored trial step (rows and norm sums)
    equals a K7 launch on its inputs bitwise, with and without saves."""
    args, kw = _alt_solve_args(batch, cuda, tol=tol, seed=batch)
    if not saves:
        kw = dict(dynamics="altmlp")
    rk = ws.whole_solve_fwd(*args, **kw)
    ns = int(rk.final[3:5].sum().item())
    assert rk.final[5].item() == 1.0 and ns > 2
    t1, leaves = args[1], args[5]
    for i in range(ns):
        t, dt = rk.streams[ws.ST_T, i], rk.streams[ws.ST_DT, i]
        dt_eff = torch.where(dt - (t1 - t) >= 0, t1 - t, dt)
        res = fg.altmlp_normed_sweep(t, dt_eff, rk.hy[i], rk.hf[i], leaves, tol, tol)
        assert torch.equal(torch.stack(res[2:]), rk.streams[ws.ST_E:ws.ST_ACC, i]), i
        if rk.streams[ws.ST_ACC, i] == 1:
            assert torch.equal(res.y_new, rk.hy[i + 1]) and torch.equal(res.k_last, rk.hf[i + 1])


def _alt_bwd_groups(g):
    """(ct_t, ct_dt), ct_y, ct_k1 and the leaves' cotangents as one vector."""
    return [torch.stack(g[:2]), g[2], g[3], torch.cat([x.flatten() for x in g[4]])]


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-5, 1.4e-8])
@pytest.mark.parametrize("shape", [(256, 20, 50, 4), (13, 20, 50, 4), (7, 6, 10, 2),
                                   (40, 20, 50, 1), (40, 20, 50, 8)])
def test_altmlp_bwd_matches_its_schedule(cuda, shape, tol):
    """K8 (the reverse tile body, 2-row tiles, the cotangents in registers
    to depth 4 and in shared memory past it) against its order of sums in
    plain PyTorch (``fg.plain_altmlp_bwd_tiles``): every group within 3
    times the plain version's distance from the float64 chain, plus 1e-6;
    ct_t exactly zero."""
    y, k1, leaves, cts = _alt_inputs(*shape, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    d = lambda x: x.double()
    got = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    assert got[0].item() == 0.0
    kern = _alt_bwd_groups(got)
    sched = _alt_bwd_groups(fg.plain_altmlp_bwd_tiles(t, dt, y, k1, leaves, cts, tol, tol))
    plain = _alt_bwd_groups(fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, tol, tol))
    ref = _alt_bwd_groups(fg._altmlp_bwd_math(d(t), d(dt), d(y), d(k1), [d(x) for x in leaves],
                                              [d(c) for c in cts], tol, tol))
    for j, (a, b, p, r) in enumerate(zip(kern, sched, plain, ref)):
        assert _rel(a, b) <= 3 * _rel(p, r) + 1e-6, (j, _rel(a, b), _rel(p, r))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", range(1, 9))
def test_altmlp_bwd_takes_every_depth(cuda, depth):
    """Every depth K8 takes (1 to 8) runs at the latent width, within 1e-3
    of the plain version (the bound of ``test_altmlp_kernels_match_plain_
    versions``): past depth 4 the deeper layers' cotangents are held in
    shared memory."""
    y, k1, leaves, cts = _alt_inputs(64, 20, 50, depth, cuda, seed=depth)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    kern = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-5, 1e-5)
    plain = fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, 1e-5, 1e-5)
    assert kern[0].item() == 0.0
    for a, b in zip([*kern[1:4], *kern[4]], [*plain[1:4], *plain[4]]):
        assert _rel(a, b) <= 1e-3
    assert fg.altmlp_bwd_plan(64, 20, 50, depth).cw_in_smem == (depth > 4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 20, 50, 4), (13, 20, 50, 4), (40, 20, 50, 6)])
def test_altmlp_bwd_is_bitwise_deterministic(cuda, shape):
    """K8's sums run in a fixed order (no atomics): three launches on the
    same inputs are bitwise equal, a ragged batch's and a deep network's
    too."""
    y, k1, leaves, cts = _alt_inputs(*shape, cuda, seed=2)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    runs = [fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1.4e-8, 1.4e-8)
            for _ in range(3)]
    first = [*runs[0][:4], *runs[0][4]]
    for g in runs[1:]:
        assert all(torch.equal(u, v) for u, v in zip(first, [*g[:4], *g[4]]))


@pytest.mark.cuda
def test_altmlp_bwd_plan_is_the_librarys(cuda):
    """``fg.altmlp_bwd_plan``'s rows and shared memory are the library's at
    every width and depth the card tests run, K4's partials take its rows
    (``ws._slot_rows``), and the wrapper refuses widths the body does not
    hold with a ValueError."""
    from regneuralde_tpu_torch.ops import _cuda

    lib = _cuda.library()
    for D, H, depth in [(20, 50, d) for d in range(1, 9)] + [(6, 10, 2), (20, 300, 1)]:
        plan = fg.check_bwd_plan(lib, D, H, depth)
        assert plan.rows == fg.ALT_BWD_ROWS == 2 and plan.smem_bytes <= fg.SMEM_LIMIT
    assert ws._slot_rows(lib, "altmlp", bwd=True) == 2 == ws._slot_rows(lib, "altmlp")
    y, k1, leaves, cts = _alt_inputs(16, 20, 1000, 4, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(ValueError, match="reverse tile body holds at most"):
        fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-5, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("depth, batch", [(1, 40), (4, 21), (8, 40)])
def test_whole_solve_altmlp_walk_at_every_depth(cuda, depth, batch):
    """K4 for AlternatingMLP over a short walk (rtol=atol=1e-3, no saves)
    at depths 1, 4 (a ragged batch) and 8 (the deeper layers' cotangents in
    the walk's shared memory) against its plain walk: K3 takes the plain
    version's steps; seeded with y1's cotangent, K4 within 1e-3 of the plain
    walk on every output but ct_f0 and every output but ct_f0 within 3 times
    the plain walk's distance from float64, plus 1e-5 (as
    ``test_whole_solve_altmlp_kernels_match_plain_versions``)."""
    y0, _, leaves, _ = _alt_inputs(batch, 20, 50, depth, cuda, seed=depth)
    func = fg.alternating_mlp_apply(depth)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, tuple(leaves), 1e-3, 1e-3)
    args = (t0, t1, dt0, y0, f0, leaves, 1e-3, 1e-3, CTRL, 64)
    rk = ws.whole_solve_fwd(*args, dynamics="altmlp")
    rp = ws.plain_whole_solve_fwd(*args, dynamics="altmlp")
    assert rk.final[3:].tolist() == rp.final[3:].tolist() and rk.final[5].item() == 1.0
    ns = int(rk.final[3:5].sum().item())
    ct_y1 = torch.tensor(np.random.default_rng(depth).normal(size=(batch, 20)),
                         dtype=torch.float32, device=cuda)
    tel = torch.zeros(4, 64, device=cuda)
    d = lambda x: x.double()
    gk = ws.whole_solve_bwd(rk, ns, ct_y1, tel, t0, t1, leaves, 1e-3, 1e-3, CTRL,
                            dynamics="altmlp")
    gp = ws.plain_whole_solve_bwd(rk, ns, ct_y1, tel, t0, t1, leaves, 1e-3, 1e-3, CTRL,
                                  dynamics="altmlp")
    g64 = ws.plain_whole_solve_bwd(ws.SolveRecord(*map(d, rk)), ns, d(ct_y1), d(tel), d(t0),
                                   d(t1), [d(x) for x in leaves], 1e-3, 1e-3, CTRL,
                                   dynamics="altmlp")
    group = lambda g: [torch.stack(g[:3]), g[3], torch.cat([x.flatten() for x in g[6:]])]
    for name, a, b, c in zip(["ct_t0|ct_t1|ct_dt0", "ct_y0", "leaves"], group(gk), group(gp),
                             group(g64)):
        assert _rel(a, b) <= 1e-3, (name, _rel(a, b))
        assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5, (name, _rel(a, c), _rel(b, c))


@pytest.mark.cuda
def test_whole_solve_mlp_with_saveat_matches_plain_versions(cuda):
    """The save cursor on the MLPDynamics instantiation (64x40x24, five
    saves from t0, rtol=atol=1e-4): the same counts, accepts and cursors as
    the plain version, the saves within 1e-4; K4 seeded with a cotangent of
    y1 within 1e-3 of its plain version (with the saves' cotangents the
    error estimate's float32 floor takes the plain version itself 1e-3
    from float64)."""
    args = _solve_args(64, 40, 24, cuda)
    sa, ys_init = ode.saveat_rows(torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0], device=cuda),
                                  args[0], args[1], args[3])
    kw = dict(saveat=sa, ys_init=ys_init)
    rk, rp = ws.whole_solve_fwd(*args, **kw), ws.plain_whole_solve_fwd(*args, **kw)
    assert rk.final[3:].tolist() == rp.final[3:].tolist()
    assert torch.equal(rk.cursors, rp.cursors) and rk.cursors.tolist() == [1, 5]
    assert _rel(rk.ys, rp.ys) <= 1e-4 and torch.equal(rk.ys[0], args[3])
    ns = int(rk.final[3:5].sum().item())
    ct_y1, ct_tel = _bwd_seeds(64, 40, cuda)
    bkw = dict(saveat=sa, ct_ys=torch.zeros_like(rk.ys))
    rest = (ct_y1, torch.zeros_like(ct_tel), args[0], args[1], args[5], 1e-4, 1e-4, CTRL)
    gk = ws.whole_solve_bwd(rk, ns, *rest, **bkw)
    gp = ws.plain_whole_solve_bwd(rk, ns, *rest, **bkw)
    for name, a, b in zip(GROUPS, _grad_groups(gk), _grad_groups(gp)):
        if name != "ct_f0":
            assert _rel(a, b) <= 1e-3, name


@pytest.mark.cuda
def test_fused_true_trains_the_latent_node_through_k3_k4(cuda):
    """``NeuralODE(AlternatingMLP, fused=True, saveat=...)`` against
    ``fused=False`` on the card at rtol=atol=1e-5: the same NFE and accept
    sequence, the trajectory within 1e-4 and the gradients of its weighted
    square within 1e-3 (relative); one whole-solve launch per direction and
    no step kernel."""
    from regneuralde_tpu_torch.models import AlternatingMLP, NeuralODE

    sa = torch.tensor([0.0, 0.1, 0.35, 0.6, 0.9, 1.0], device=cuda)
    outs = {}
    for fused in (True, False):
        gen = torch.Generator().manual_seed(0)
        node = NeuralODE(AlternatingMLP(20, 50, 4, device=cuda, generator=gen),
                         time_dep=False, rtol=1e-5, atol=1e-5, max_steps=256,
                         saveat=sa, fused=fused)
        x = torch.randn(37, 20, generator=gen).to(cuda)
        ws.reset_launches()
        fg.reset_launches()
        out = node(x)
        w = torch.arange(1.0, 7.0, device=cuda)[None, :, None]
        grads = torch.autograd.grad((w * out.value.square()).sum(),
                                    list(node.parameters()))
        outs[fused] = (out, grads, {**ws.LAUNCHES, **fg.LAUNCHES})
    (a, ga, la), (b, gb, _) = outs[True], outs[False]
    assert la == {"whole_solve_fwd": 0, "whole_solve_bwd": 0, "whole_solve_altmlp_fwd": 1,
                  "whole_solve_altmlp_bwd": 1, "whole_solve_csl_fwd": 0,
                  "whole_solve_csl_bwd": 0, "altmlp_tsit5_fwd": 0, "altmlp_tsit5_bwd": 0}
    assert a.nfe == b.nfe and torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    assert a.value.shape == (37, 6, 20) and torch.equal(a.value[:, 0], b.value[:, 0])
    assert _rel(a.value, b.value) <= 1e-4
    for u, v in zip(ga, gb):
        assert _rel(u, v) <= 1e-3


def _csl_inputs(batch, dim, hidden, kinetic, device, seed=0):
    """CSLDynamics leaves (nn.Linear layout; weights at LeCun's scale, time
    weights standard normal) and the probe, a state of width dim + 1 (dim +
    3 with the kinetic terms), a random k1 and the cotangents."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    leaves = []
    for n_in, n_out in ((dim, hidden), (hidden, hidden), (hidden, dim)):
        leaves += [f32(rng.normal(size=(n_out, n_in)) / np.sqrt(n_in)),
                   f32(rng.normal(size=n_out) * 0.1), f32(rng.normal(size=(n_out, 1))),
                   f32(rng.normal(size=(n_out, 1))), f32(rng.normal(size=n_out) * 0.1)]
    leaves.append(f32(rng.normal(size=(batch, dim))))
    width = dim + (3 if kinetic else 1)
    y = f32(rng.normal(size=(batch, width)) * 0.5)
    k1 = f32(rng.normal(size=(batch, width)) * 0.3)
    cts = [f32(rng.normal(size=(batch, width))), f32(rng.normal(size=(batch, width))),
           f32(0.7), f32(1.3), f32(-0.4)]
    return y, k1, leaves, cts


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-5, 1.4e-8])
@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("shape", [(1024, 43, 100), (13, 5, 8), (7, 3, 6)])
def test_csl_kernels_match_plain_versions(cuda, shape, kinetic, tol):
    """K7-CSL/K8-CSL against their plain versions at the FFJORD width, a
    ragged batch (13 rows: the last tile half empty) and a small one, with
    and without the kinetic terms. K7-CSL's rows bitwise equal (each affine
    map, hop and row sum rounded once from float64), its norm sums within
    1e-6 (relative; only the summation order differs); K8-CSL within 1e-3
    (relative Frobenius: its seeds multiply by 1/(atol + |y| rtol)); the
    probe's cotangent zero."""
    y, k1, leaves, cts = _csl_inputs(*shape, kinetic, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    fc.reset_launches()
    kern = fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    plain = fc.plain_csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    assert torch.equal(kern.y_new, plain.y_new) and torch.equal(kern.k_last, plain.k_last)
    for a, b in zip(kern[2:], plain[2:]):
        assert _rel(a, b) <= 1e-6
    kern_b = fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    plain_b = fc._csl_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)
    assert _rel(torch.stack(kern_b[:2]), torch.stack(plain_b[:2])) <= 1e-3
    for a, b in zip([*kern_b[2:4], *kern_b[4][:fc.N_PARAMS]],
                    [*plain_b[2:4], *plain_b[4][:fc.N_PARAMS]]):
        assert _rel(a, b) <= 1e-3
    assert not kern_b[4][fc.N_PARAMS].any()
    assert fc.LAUNCHES == {"csl_tsit5_fwd": 1, "csl_tsit5_bwd": 1}


@pytest.mark.cuda
def test_csl_kernels_are_deterministic(cuda):
    """Per-tile norm-sum slots and per-block parameter-cotangent slots
    summed in order, no atomics: two launches are bitwise equal."""
    y, k1, leaves, cts = _csl_inputs(1024, 43, 100, True, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    a = fc.csl_normed_sweep(t, dt, y, k1, leaves, 1e-6, 1e-6)
    b = fc.csl_normed_sweep(t, dt, y, k1, leaves, 1e-6, 1e-6)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    ga = fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-6, 1e-6)
    gb = fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-6, 1e-6)
    assert all(torch.equal(u, v) for u, v in zip([*ga[:4], *ga[4]], [*gb[:4], *gb[4]]))


def _csl_bwd_groups(g):
    """(ct_t, ct_dt), ct_y, ct_k1 and the parameters' cotangents as one
    vector."""
    return [torch.stack(g[:2]), g[2], g[3], torch.cat([x.flatten() for x in g[4][:fc.N_PARAMS]])]


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-5, 1.4e-8])
@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("shape", [(1024, 43, 100), (13, 5, 8), (7, 3, 6)])
def test_csl_bwd_matches_its_schedule(cuda, shape, kinetic, tol):
    """K8-CSL (8-row tiles, the weights' cotangents in registers) against
    its order of sums in plain PyTorch (``fc.plain_csl_bwd_tiles``) at the
    shapes of ``test_csl_kernels_match_plain_versions``: every group within
    3 times the plain version's distance from the float64 chain, plus
    1e-6."""
    y, k1, leaves, cts = _csl_inputs(*shape, kinetic, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    d = lambda x: x.double()
    kern = _csl_bwd_groups(fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol))
    sched = _csl_bwd_groups(fc.plain_csl_bwd_tiles(t, dt, y, k1, leaves, cts, tol, tol))
    plain = _csl_bwd_groups(fc._csl_bwd_math(t, dt, y, k1, leaves, cts, tol, tol))
    ref = _csl_bwd_groups(fc._csl_bwd_math(d(t), d(dt), d(y), d(k1), [d(x) for x in leaves],
                                           [d(c) for c in cts], tol, tol))
    for j, (a, b, p, r) in enumerate(zip(kern, sched, plain, ref)):
        assert _rel(a, b) <= 3 * _rel(p, r) + 1e-6, (j, _rel(a, b), _rel(p, r))


@pytest.mark.cuda
@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("shape", [(1024, 43, 100), (13, 5, 8)])
def test_csl_bwd_is_bitwise_deterministic(cuda, shape, kinetic):
    """K8-CSL's sums run in a fixed order (no atomics): three launches on
    the same inputs are bitwise equal, a ragged batch's too."""
    y, k1, leaves, cts = _csl_inputs(*shape, kinetic, cuda, seed=2)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    runs = [fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1.4e-8, 1.4e-8) for _ in range(3)]
    first = [*runs[0][:4], *runs[0][4]]
    for g in runs[1:]:
        assert all(torch.equal(u, v) for u, v in zip(first, [*g[:4], *g[4]]))


@pytest.mark.cuda
def test_csl_bwd_plan_is_the_librarys(cuda):
    """``fc.csl_bwd_plan``'s rows, tile cap and shared memory are the
    library's at every width the card tests run, and the wrapper refuses
    layers the body does not hold with a ValueError."""
    from regneuralde_tpu_torch.ops import _cuda

    lib = _cuda.library()
    for D, H in ((43, 100), (5, 16), (5, 8), (3, 6)):
        for kinetic in (False, True):
            plan = fc.check_bwd_plan(lib, D + (3 if kinetic else 1), D, H, kinetic)
            assert plan.rows == 8 and plan.smem_bytes <= fc.SMEM_LIMIT
    y, k1, leaves, cts = _csl_inputs(16, 43, 110, False, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(ValueError, match="tile body holds at most"):
        fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-5, 1e-5)


@pytest.mark.cuda
def test_csl_wrappers_refuse_bad_inputs(cuda):
    y, k1, leaves, cts = _csl_inputs(8, 5, 8, False, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(TypeError):
        fc.csl_normed_sweep(t, dt, y.double(), k1, leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fc.csl_normed_sweep(t, dt, y, k1.cpu(), leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):  # neither dim + 1 nor dim + 3 wide
        fc.csl_normed_sweep(t, dt, y[:, :5].contiguous(), k1[:, :5].contiguous(), leaves,
                            1e-4, 1e-4)
    bad = list(leaves)
    bad[5] = bad[5].t().contiguous().t()  # csl2.layer.weight, strided
    with pytest.raises(ValueError):
        fc.csl_normed_sweep(t, dt, y, k1, bad, 1e-4, 1e-4)
    with pytest.raises(ValueError):  # the probe's rows are the batch's
        fc.csl_normed_sweep(t, dt, y, k1, [*leaves[:-1], leaves[-1][:4]], 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, [cts[0].cpu(), *cts[1:]], 1e-4, 1e-4)


def _csl_solve_args(batch, dim, hidden, kinetic, device, tol=1e-5, max_steps=128, seed=0):
    """Seeded CSL leaves and probe, y0 = [x; 0] (and the kinetic zeros), and
    odeint's prologue: the arguments and keywords of ``whole_solve_fwd``."""
    _, _, leaves, _ = _csl_inputs(batch, dim, hidden, kinetic, device, seed)
    rng = np.random.default_rng(seed + 5)
    x = torch.tensor(rng.normal(size=(batch, dim)), dtype=torch.float32, device=device)
    y0 = torch.cat([x, torch.zeros(batch, 3 if kinetic else 1, device=device)], dim=1)
    func = fc.csl_aug_apply(dim, kinetic)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, tuple(leaves), tol, tol)
    return (t0, t1, dt0, y0, f0, leaves, tol, tol, CTRL, max_steps), dict(dynamics="csl")


@pytest.mark.cuda
@pytest.mark.parametrize("batch, kinetic", [(1024, False), (13, False), (13, True)])
def test_whole_solve_csl_kernels_match_plain_versions(cuda, batch, kinetic):
    """K3/K4 with the CSL tile bodies at the FFJORD width (dim 43, hidden
    100) against their plain versions at rtol=atol=1e-5: the same step
    counts and accept sequence, y1 within 1e-6, every stored trial step's
    norm sums and rows bitwise equal to K7-CSL's on its inputs. K4 over
    K3's record: seeded with a cotangent of y1, within 1e-3 of its plain
    version on all but ct_f0 (``_assert_k4_matches`` says why not ct_f0);
    with the telemetry too, every output within 3 times the float32 plain
    version's distance from a float64 walk, plus 1e-5. The probe takes no
    cotangent."""
    args, kw = _csl_solve_args(batch, 43, 100, kinetic, cuda)
    ws.reset_launches()
    rk = ws.whole_solve_fwd(*args, **kw)
    rp = ws.plain_whole_solve_fwd(*args, **kw)
    assert rk.final[3:].tolist() == rp.final[3:].tolist() and rk.final[5].item() == 1.0
    assert torch.equal(rk.streams[ws.ST_ACC], rp.streams[ws.ST_ACC])
    assert _rel(rk.y1, rp.y1) <= 1e-6
    ns = int(rk.final[3:5].sum().item())
    t0, t1, leaves = args[0], args[1], args[5]
    for i in range(ns):
        t, dt = rk.streams[ws.ST_T, i], rk.streams[ws.ST_DT, i]
        dt_eff = torch.where(dt - (t1 - t) >= 0, t1 - t, dt)
        res = fc.csl_normed_sweep(t, dt_eff, rk.hy[i], rk.hf[i], leaves, 1e-5, 1e-5)
        assert torch.equal(torch.stack(res[2:]), rk.streams[ws.ST_E:ws.ST_ACC, i])
        assert torch.equal(res.y_new, rk.hy[i + 1]) and torch.equal(res.k_last, rk.hf[i + 1])
    rng = np.random.default_rng(3)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)
    ct_y1, ct_tel = f32(rng.normal(size=tuple(args[3].shape))), f32(rng.normal(size=(4, 128)) * 0.1)
    d = lambda x: x.double()
    names = ["ct_t0|ct_t1|ct_dt0", "ct_y0", "ct_f0", "leaves"]
    group = lambda g: [torch.stack(g[:3]), *g[3:5],
                       torch.cat([x.flatten() for x in g[6:6 + fc.N_PARAMS]])]
    for tel in (torch.zeros_like(ct_tel), ct_tel):
        gk = ws.whole_solve_bwd(rk, ns, ct_y1, tel, t0, t1, leaves, 1e-5, 1e-5, CTRL, **kw)
        gp = ws.plain_whole_solve_bwd(rk, ns, ct_y1, tel, t0, t1, leaves, 1e-5, 1e-5, CTRL,
                                      **kw)
        g64 = ws.plain_whole_solve_bwd(
            ws.SolveRecord(*map(d, rk)), ns, d(ct_y1), d(tel), d(t0), d(t1),
            [d(x) for x in leaves], 1e-5, 1e-5, CTRL, **kw)
        for name, a, b, c in zip(names, group(gk), group(gp), group(g64)):
            if not tel.any() and name != "ct_f0":
                assert _rel(a, b) <= 1e-3, name
            if tel.any():
                assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5, (name, _rel(a, b), _rel(a, c))
        assert not gk[6 + fc.N_PARAMS].any()
    assert ws.LAUNCHES == {"whole_solve_fwd": 0, "whole_solve_bwd": 0,
                           "whole_solve_altmlp_fwd": 0, "whole_solve_altmlp_bwd": 0,
                           "whole_solve_csl_fwd": 1, "whole_solve_csl_bwd": 2}


@pytest.mark.cuda
def test_whole_solve_csl_kernels_are_deterministic(cuda):
    """Per-tile slots summed in tile order, per-block parameter-cotangent
    slots summed in block order, no atomics: two runs are bitwise equal."""
    args, kw = _csl_solve_args(1024, 43, 100, False, cuda)
    a, b = ws.whole_solve_fwd(*args, **kw), ws.whole_solve_fwd(*args, **kw)
    ns = int(a.final[3:5].sum().item())
    for x, y in ((a.final, b.final), (a.streams, b.streams), (a.y1, b.y1),
                 (a.hy[:ns + 1], b.hy[:ns + 1]), (a.hf[:ns + 1], b.hf[:ns + 1])):
        assert torch.equal(x, y)
    rng = np.random.default_rng(4)
    ct_y1 = torch.tensor(rng.normal(size=(1024, 44)), dtype=torch.float32, device=cuda)
    ct_tel = torch.tensor(rng.normal(size=(4, 128)) * 0.1, dtype=torch.float32, device=cuda)
    rest = (ct_y1, ct_tel, args[0], args[1], args[5], 1e-5, 1e-5, CTRL)
    ga, gb = ws.whole_solve_bwd(a, ns, *rest, **kw), ws.whole_solve_bwd(a, ns, *rest, **kw)
    assert all(torch.equal(u, v) for u, v in zip(ga, gb))


# (batch, dim, hidden, kinetic): FFJORD's width with and without the
# kinetic terms, ragged batches (a last 8-row tile of 5 rows, its last 2-row
# slot of one), small widths
CSL_FWD_SHAPES = [(1024, 43, 100, False), (1024, 43, 100, True), (1021, 43, 100, False),
                  (13, 5, 8, True), (7, 3, 6, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-5, 1.4e-8])
@pytest.mark.parametrize("shape", CSL_FWD_SHAPES)
def test_csl_fwd_matches_its_schedule(cuda, shape, tol):
    """K7-CSL (8-row tiles, one norm-sum slot a 2-row sub-tile) bitwise:
    y_new and k7 equal the plain version's, the three sums its schedule's
    (``fc.plain_csl_fwd_tiles``: the plain terms summed slot by slot as
    the kernel sums them); ceil(B/8) blocks, one launch."""
    batch, dim, hidden, kinetic = shape
    y, k1, leaves, _ = _csl_inputs(batch, dim, hidden, kinetic, cuda, seed=batch)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    fc.reset_launches()
    kern = fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    plain = fc.plain_csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    sched = fc.plain_csl_fwd_tiles(t, dt, y, k1, leaves, tol, tol)
    assert torch.equal(kern.y_new, plain.y_new) and torch.equal(kern.k_last, plain.k_last)
    assert torch.equal(sched.y_new, plain.y_new) and torch.equal(sched.k_last, plain.k_last)
    for a, b in zip(kern[2:], sched[2:]):
        assert torch.equal(a, b), (a.item(), b.item())
    assert fc.LAUNCHES == {"csl_tsit5_fwd": 1, "csl_tsit5_bwd": 0}
    assert fc.csl_fwd_plan(batch, dim, hidden, kinetic).tiles == -(-batch // 8)


@pytest.mark.cuda
@pytest.mark.parametrize("batch, kinetic, tol", [(1024, False, 1.4e-8), (1021, True, 1e-5),
                                                 (13, True, 1.4e-8)])
def test_csl_whole_solve_steps_are_k7s(cuda, batch, kinetic, tol):
    """K3-CSL runs K7-CSL's tile body, one 8-row tile a block of its
    cooperative grid: every stored trial step (rows and norm sums) equals a
    K7-CSL launch on its inputs bitwise, at FFJORD's width, a ragged batch
    and a small one."""
    from regneuralde_tpu_torch.ops import _cuda

    args, kw = _csl_solve_args(batch, 43, 100, kinetic, cuda, tol=tol, seed=batch)
    A = args[3].shape[1]
    grid = _cuda.library().regnde_whole_solve_csl_fwd_grid(batch, A, 100, int(kinetic))
    assert grid == -(-batch // 8)
    rk = ws.whole_solve_fwd(*args, **kw)
    ns = int(rk.final[3:5].sum().item())
    assert rk.final[5].item() == 1.0 and ns > 2
    t1, leaves = args[1], args[5]
    for i in range(ns):
        t, dt = rk.streams[ws.ST_T, i], rk.streams[ws.ST_DT, i]
        dt_eff = torch.where(dt - (t1 - t) >= 0, t1 - t, dt)
        res = fc.csl_normed_sweep(t, dt_eff, rk.hy[i], rk.hf[i], leaves, tol, tol)
        assert torch.equal(torch.stack(res[2:]), rk.streams[ws.ST_E:ws.ST_ACC, i]), i
        if rk.streams[ws.ST_ACC, i] == 1:
            assert torch.equal(res.y_new, rk.hy[i + 1]) and torch.equal(res.k_last, rk.hf[i + 1])


@pytest.mark.cuda
@pytest.mark.parametrize("batch, kinetic", [(1024, True), (1021, False)])
def test_csl_fwd_is_bitwise_deterministic(cuda, batch, kinetic):
    """K7-CSL's slots and K3-CSL's are summed in a fixed order (no atomics):
    three K7-CSL launches, and two K3-CSL solves, are bitwise equal."""
    y, k1, leaves, _ = _csl_inputs(batch, 43, 100, kinetic, cuda, seed=5)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    runs = [fc.csl_normed_sweep(t, dt, y, k1, leaves, 1.4e-8, 1.4e-8) for _ in range(3)]
    for r in runs[1:]:
        assert all(torch.equal(u, v) for u, v in zip(runs[0], r))
    args, kw = _csl_solve_args(batch, 43, 100, kinetic, cuda, tol=1.4e-8, seed=5)
    a, b = ws.whole_solve_fwd(*args, **kw), ws.whole_solve_fwd(*args, **kw)
    ns = int(a.final[3:5].sum().item())
    for x, z in ((a.final, b.final), (a.streams, b.streams), (a.y1, b.y1),
                 (a.hy[:ns + 1], b.hy[:ns + 1]), (a.hf[:ns + 1], b.hf[:ns + 1])):
        assert torch.equal(x, z)


@pytest.mark.cuda
def test_csl_fwd_plan_is_the_librarys(cuda):
    """``fc.csl_fwd_plan``'s rows, slot rows and shared memory are the
    library's at every width the card tests run, and both forward wrappers
    refuse layers the body does not hold with a ValueError."""
    from regneuralde_tpu_torch.ops import _cuda

    lib = _cuda.library()
    for D, H in ((43, 100), (5, 16), (5, 8), (3, 6)):
        for kinetic in (False, True):
            plan = fc.check_fwd_plan(lib, D + (3 if kinetic else 1), D, H, kinetic)
            assert (plan.rows, plan.slot_rows) == (8, 2) and plan.smem_bytes <= fc.SMEM_LIMIT
    y, k1, leaves, _ = _csl_inputs(16, 43, 170, False, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(ValueError, match="tile body holds at most"):
        fc.csl_normed_sweep(t, dt, y, k1, leaves, 1e-5, 1e-5)
    args, kw = _csl_solve_args(16, 43, 170, False, cuda)
    with pytest.raises(ValueError, match="tile body holds at most"):
        ws.whole_solve_fwd(*args, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", ["step", True])
def test_ffjord_trains_through_the_csl_kernels(cuda, fused):
    """``FFJORD(CSLDynamics(5, 16))`` on ``fused`` (K7/K8-CSL on
    ``"step"``, K3/K4-CSL on ``True``) against ``fused=False`` on the card
    at rtol=atol=1e-5, batch 37, the same probe: the same NFE and accept
    sequence, logpx within 1e-6 and the gradients of -mean(logpx) within
    1e-3 (relative); the launches of the route's kernels only."""
    from regneuralde_tpu_torch.models import FFJORD, CSLDynamics

    outs = {}
    for route in (fused, False):
        gen = torch.Generator().manual_seed(0)
        ff = FFJORD(CSLDynamics(5, 16, device=cuda, generator=gen), 5, rtol=1e-5,
                    atol=1e-5, max_steps=128, fused=route)
        x = torch.randn(37, 5, generator=gen).to(cuda)
        ws.reset_launches()
        fc.reset_launches()
        out = ff(x, generator=gen)
        grads = torch.autograd.grad(-out.logpx.mean(), list(ff.parameters()))
        outs[route] = (out, grads, {**ws.LAUNCHES, **fc.LAUNCHES})
    (a, ga, la), (b, gb, lb) = outs[fused], outs[False]
    n = int(a.telemetry.live.sum())
    want = {k: 0 for k in la}
    if fused == "step":
        want.update(csl_tsit5_fwd=n, csl_tsit5_bwd=n)
    else:
        want.update(whole_solve_csl_fwd=1, whole_solve_csl_bwd=1)
    assert la == want and not any(lb.values())
    assert a.nfe == b.nfe and torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    assert a.solution.stats.success and a.logpx.shape == (37,)
    assert _rel(a.logpx, b.logpx) <= 1e-6
    for u, v in zip(ga, gb):
        assert _rel(u, v) <= 1e-3


def _sde_args(batch, dim, hidden, device, tol, max_steps, saveat=None, seed=0):
    """Seeded MLP-pair leaves (drift dim -> hidden -> dim, diffusion dim ->
    dim), y0 and draws, and the whole solve's arguments."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(s, generator=g) * sc).to(device)
    leaves = [r(hidden, dim, sc=dim ** -0.5), r(hidden, sc=0.1), r(dim, hidden, sc=hidden ** -0.5),
              r(dim, sc=0.1), r(dim, dim, sc=dim ** -0.5), r(dim, sc=0.1)]
    y0 = r(batch, dim, sc=0.5)
    xi = tuple(r(max_steps, batch, dim) for _ in range(2))
    t0, t1 = torch.tensor(0.0, device=device), torch.tensor(1.0, device=device)
    args = (t0, t1, torch.tensor(0.01, device=device), y0, leaves, tol, tol,
            PIController(beta1=0.5, beta2=0.0), max_steps, *xi)
    kw = dict(n_drift=2, solver="sosri2")
    if saveat is not None:
        sa, ys_init = sde_ops.save_rows_at_start(torch.tensor(saveat, device=device), t0, y0)
        kw.update(saveat=sa, ys_init=ys_init)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("batch, dim, hidden, tol, saveat", [
    (512, 32, 64, 1.4e-1, None), (13, 5, 8, 1e-2, None),
    (512, 32, 64, 1.4e-2, [0.0, 0.25, 0.5, 0.75, 1.0])])
def test_sde_whole_solve_kernels_match_plain_versions(cuda, batch, dim, hidden, tol, saveat):
    """K9 takes the plain version's steps and save cursors, y1 and the saves
    within 1e-5 (relative); K10, seeded with the cotangents of y1, the
    saves and the telemetry, within 1e-3 of the plain version on every
    output and within 3 times the plain version's distance from a float64
    walk, plus 1e-5."""
    S = 256
    args, kw = _sde_args(batch, dim, hidden, cuda, tol, S, saveat)
    rk = sw.sde_whole_solve_fwd(*args, **kw)
    rp = sw.plain_sde_whole_solve_fwd(*args, **kw)
    assert rk.final[3:].tolist() == rp.final[3:].tolist() and rk.final[5] == 1.0
    assert torch.equal(rk.streams[sw.ST_ACC], rp.streams[sw.ST_ACC])
    assert torch.equal(rk.cursors, rp.cursors)
    assert _rel(rk.y1, rp.y1) <= 1e-5
    if saveat is not None:
        assert _rel(rk.ys, rp.ys) <= 1e-5
    ns = int(rk.final[3:5].sum())
    g = torch.Generator().manual_seed(7)
    ct_y1 = torch.randn(batch, dim, generator=g).to(cuda)
    ct_tel = (0.1 * torch.randn(4, S, generator=g)).to(cuda)
    ct_ys = None if saveat is None else torch.randn(len(saveat), batch, dim, generator=g).to(cuda)
    t0, t1, _, _, leaves, _, _, ctrl = args[:8]
    bargs = (ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl, *args[9:])
    bkw = dict(n_drift=2, solver="sosri2", saveat=kw.get("saveat"), ct_ys=ct_ys)
    gk = sw.sde_whole_solve_bwd(rk, *bargs, **bkw)
    gp = sw.plain_sde_whole_solve_bwd(rk, *bargs, **bkw)
    d = lambda x: None if x is None else x.double()
    g64 = sw.plain_sde_whole_solve_bwd(
        sw.SDERecord(*map(d, rk)), ns, d(ct_y1), d(ct_tel), d(t0), d(t1), [d(x) for x in leaves],
        tol, tol, ctrl, d(args[9]), d(args[10]), n_drift=2, solver="sosri2",
        saveat=d(kw.get("saveat")), ct_ys=d(ct_ys))
    groups = lambda g: [torch.stack(g[:3]), *g[3:]]
    for a, b, c in zip(groups(gk), groups(gp), groups(g64)):
        if b.numel():
            assert _rel(a, b) <= 1e-3
            assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5


@pytest.mark.cuda
def test_sde_whole_solve_kernels_are_deterministic(cuda):
    args, kw = _sde_args(512, 32, 64, cuda, 1.4e-2, 256, [0.0, 0.5, 1.0])
    a, b = sw.sde_whole_solve_fwd(*args, **kw), sw.sde_whole_solve_fwd(*args, **kw)
    ns = int(a.final[3:5].sum())
    # the history's rows past the last trial step are undefined
    assert all(torch.equal(getattr(a, n), getattr(b, n))
               for n in ("y1", "streams", "final", "ys", "cursors"))
    assert all(torch.equal(getattr(a, n)[:ns + 1], getattr(b, n)[:ns + 1])
               for n in ("hy", "hw", "hz"))
    bargs = (ns, torch.ones_like(a.y1), torch.full((4, 256), 0.1, device=cuda), args[0], args[1],
             args[4], 1.4e-2, 1.4e-2, args[7], *args[9:])
    bkw = dict(n_drift=2, solver="sosri2", saveat=kw["saveat"], ct_ys=torch.ones_like(a.ys))
    u, v = sw.sde_whole_solve_bwd(a, *bargs, **bkw), sw.sde_whole_solve_bwd(a, *bargs, **bkw)
    assert all(torch.equal(x, y) for x, y in zip(u, v))


@pytest.mark.cuda
def test_sde_wrappers_refuse_bad_inputs(cuda):
    args, kw = _sde_args(16, 4, 8, cuda, 1e-2, 32)
    t0, t1, dt0, y0, leaves = args[:5]
    rest = args[5:9]
    xi = args[9:]
    with pytest.raises(ValueError, match="float32"):
        sw.sde_whole_solve_fwd(t0, t1, dt0, y0.double(), leaves, *rest, *xi, **kw)
    with pytest.raises(ValueError, match="xi_w"):
        sw.sde_whole_solve_fwd(t0, t1, dt0, y0, leaves, *rest, xi[0][:8], xi[1], **kw)
    with pytest.raises(ValueError, match="chain"):
        sw.sde_whole_solve_fwd(t0, t1, dt0, y0, [leaves[0].t().contiguous(), *leaves[1:]], *rest,
                               *xi, **kw)
    with pytest.raises(ValueError, match="1 to 4 layers"):
        sw.sde_whole_solve_fwd(t0, t1, dt0, y0, leaves, *rest, *xi, n_drift=3, solver="sosri2")


@pytest.mark.cuda
@pytest.mark.parametrize("saveat", [None, [0.0, 0.5, 1.0]])
def test_nsde_trains_through_k9_k10(cuda, saveat):
    """``NeuralSDE(MLP(8, (12, 8)), MLP(8, (8,)))`` on ``fused=True``
    against ``fused=False`` on the card at rtol=atol=1e-2, batch 37, the
    same draws: the same NFE and accept sequence, the value within 1e-5 and
    the gradients of ``sum(v^2) + 10 * error_estimate`` within 1e-3
    (relative); one K9 and one K10 launch, no other kernel."""
    from regneuralde_tpu_torch import reg
    from regneuralde_tpu_torch.models import MLP, NeuralSDE

    outs = {}
    for route in (True, False):
        gen = torch.Generator().manual_seed(0)
        m = NeuralSDE(MLP(8, (12, 8), device=cuda, generator=gen),
                      MLP(8, (8,), device=cuda, generator=gen), solver="sosri2", rtol=1e-2,
                      atol=1e-2, max_steps=128, fused=route)
        x = torch.randn(37, 8, generator=gen).to(cuda)
        noise = sde_ops.presample_noise(torch.Generator(device=cuda).manual_seed(1), x.shape, 128)
        for mod in (ws, fm, fg, fc, sw):
            mod.reset_launches()
        out = m(x, noise=noise, saveat=None if saveat is None else torch.tensor(saveat))
        loss = out.value.square().sum() + 10 * reg.error_estimate(out.telemetry, "mean")
        grads = torch.autograd.grad(loss, list(m.parameters()))
        outs[route] = (out, grads, {k: v for mod in (ws, fm, fg, fc, sw)
                                    for k, v in mod.LAUNCHES.items()})
    (a, ga, la), (b, gb, lb) = outs[True], outs[False]
    want = {k: 0 for k in la}
    want.update(sde_whole_solve_fwd=1, sde_whole_solve_bwd=1)
    assert la == want and not any(lb.values())
    assert a.nfe1 == b.nfe1 and torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    assert a.solution.stats.success
    assert _rel(a.value, b.value) <= 1e-5
    for u, v in zip(ga, gb):
        assert _rel(u, v) <= 1e-3


def _lane_times(batch, device, seed=0):
    """Per-lane (t, dt) spread over [0, 1] x [1e-3, 0.1], every fourth lane
    finished (dt = 0)."""
    rng = np.random.default_rng(seed + 20)
    t = torch.tensor(rng.uniform(0.0, 1.0, batch), dtype=torch.float32, device=device)
    dt = torch.tensor(rng.uniform(1e-3, 0.1, batch), dtype=torch.float32, device=device)
    dt[::4] = 0.0
    return t, dt


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 784, 100), (13, 40, 24), (5, 8, 5)])
def test_lane_kernels_match_plain_versions(cuda, shape):
    """K11/K12 against their plain versions, ragged row tiles included (13
    and 5 rows). K11's five outputs bitwise equal (each affine map rounded
    once from float64, each lincomb op rounded as ATen's); a finished lane
    keeps y and has zero error. K12 within 1e-3 (relative Frobenius) of its
    plain version on every output; both bitwise deterministic."""
    y, k1, leaves, _ = _inputs(*shape, cuda)
    t, dt = _lane_times(shape[0], cuda)
    rng = np.random.default_rng(9)
    cts = [torch.tensor(rng.normal(size=tuple(y.shape)), dtype=torch.float32, device=cuda)
           for _ in range(5)]
    parts = fm._split_params(*leaves)
    fl.reset_launches()
    kern = fl.sweep_lanes_fwd(t, dt, y, k1, leaves)
    plain = fl._reference_sweep_lanes(t[:, None], dt[:, None], y, k1, parts)
    for a, b in zip(kern, plain):
        assert torch.equal(a, b)
    done = dt == 0
    assert torch.equal(kern[0][done], y[done]) and not kern[2][done].any()
    flat = lambda g: [*g[:4], *g[4]]
    kern_b = flat(fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts))
    plain_b = flat(fl._lanes_bwd_math(t[:, None], dt[:, None], y, k1, parts, cts))
    for a, b in zip(kern_b, plain_b):
        assert a.shape == b.shape and _rel(a, b) <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(kern, fl.sweep_lanes_fwd(t, dt, y, k1, leaves)))
    assert all(torch.equal(a, b)
               for a, b in zip(kern_b, flat(fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts))))
    assert fl.LAUNCHES == {"mlp_lanes_tsit5_fwd": 2, "mlp_lanes_tsit5_bwd": 2}


@pytest.mark.cuda
def test_lane_wrappers_refuse_bad_inputs(cuda):
    y, k1, leaves, _ = _inputs(8, 16, 12, cuda)
    t, dt = _lane_times(8, cuda)
    cts = [torch.zeros_like(y)] * 5
    with pytest.raises(TypeError):
        fl.sweep_lanes_fwd(t.double(), dt, y, k1, leaves)
    with pytest.raises(ValueError):
        fl.sweep_lanes_fwd(t[:4], dt, y, k1, leaves)
    with pytest.raises(ValueError):
        fl.sweep_lanes_fwd(t, dt.cpu(), y, k1, leaves)
    with pytest.raises(ValueError):
        fl.sweep_lanes_bwd(t, dt, y, k1, leaves, [cts[0].cpu(), *cts[1:]])


@pytest.mark.cuda
def test_per_sample_node_trains_through_k11_k12(cuda):
    """``NeuralODE(MLPDynamics, per_sample="batched", fused=True)`` against
    ``fused=False`` on the card at rtol=atol=1e-4, batch 13, a per-lane t1:
    the same per-lane NFE and accept sequences, y1 within 1e-6 and the
    gradients of sum(y1^2) within 1e-3 (relative); one K11 and one K12
    launch an engine iteration and no other kernel."""
    from regneuralde_tpu_torch.models import MLPDynamics, NeuralODE

    outs = {}
    for fused in (True, False):
        gen = torch.Generator().manual_seed(0)
        node = NeuralODE(MLPDynamics(40, 24, device=cuda, generator=gen), rtol=1e-4,
                         atol=1e-4, max_steps=96, per_sample="batched", fused=fused)
        x = torch.rand(13, 40, generator=gen).to(cuda)
        t1 = (0.5 + torch.rand(13, generator=gen)).to(cuda)
        for mod in (ws, fm, fl):
            mod.reset_launches()
        out = node(x, tspan=(0.0, t1))
        grads = torch.autograd.grad(out.value.square().sum(), list(node.parameters()))
        outs[fused] = (out, grads, {k: v for mod in (ws, fm, fl) for k, v in mod.LAUNCHES.items()})
    (a, ga, la), (b, gb, lb) = outs[True], outs[False]
    iters = int(a.telemetry.live.any(0).sum())
    want = {k: 0 for k in la}
    want.update(mlp_lanes_tsit5_fwd=iters, mlp_lanes_tsit5_bwd=iters)
    assert la == want and not any(lb.values())
    assert a.solution.stats.success.all()
    assert torch.equal(a.nfe, b.nfe) and torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    assert _rel(a.value, b.value) <= 1e-6
    for u, v in zip(ga, gb):
        assert _rel(u, v) <= 1e-3


def _assert_k13_matches(kern, t, dt, y, k1, leaves):
    """K13's rows ``kern`` against the plain step and against its schedule
    (``plain_tuple_solve_step`` on the card's plan): within 1e-4 of each
    (the error row within 3e-4) and within 3 times its distance from its
    float64 twin, plus 1e-7. Returns the plan."""
    plan = ws.walk_plan(*y.shape, leaves[0].shape[0],
                        torch.cuda.get_device_properties(y.device).multi_processor_count)
    d = lambda x: x.double()
    parts = fm._split_params(*leaves)
    refs = {"plain": (fm._reference_sweep(t, dt, y, k1, parts),
                      fm._reference_sweep(d(t), d(dt), d(y), d(k1), [d(x) for x in parts])),
            "schedule": (ws.plain_tuple_solve_step(t, dt, y, k1, leaves, plan),
                         ws.plain_tuple_solve_step(d(t), d(dt), d(y), d(k1),
                                                   [d(x) for x in leaves], plan))}
    for ref, (plain, plain64) in refs.items():
        for name, a, b, c in zip(["y_new", "k7", "err", "k6", "g6"], kern, plain, plain64):
            assert _rel(a, c) <= 3 * _rel(b, c) + 1e-7, (ref, name, _rel(a, c), _rel(b, c))
            assert _rel(a, b) <= (3e-4 if name == "err" else 1e-4), (ref, name, _rel(a, b))
    return plan


@pytest.mark.cuda
def test_tuple_step_in_row_chunks_matches_its_schedule(cuda, monkeypatch):
    """K13 on the plan of a card of 4 multiprocessors: 4 tiles, the batch of
    256 in row chunks one after another; bitwise deterministic."""
    plan = ws.walk_plan

    def small_card(B, D, H, sms, limit=ws.SMEM_LIMIT):
        return plan(B, D, H, 4, limit)

    monkeypatch.setattr(ws, "walk_plan", small_card)
    y, k1, leaves, _ = _inputs(256, 64, 32, cuda)
    t, dt = torch.tensor(0.3, device=cuda), torch.tensor(0.3, device=cuda)
    kern = fm.stage_sweep_fwd(t, dt, y, k1, leaves)
    assert _assert_k13_matches(kern, t, dt, y, k1, leaves).chunks > 1
    again = fm.stage_sweep_fwd(t, dt, y, k1, leaves)
    assert all(torch.equal(a, b) for a, b in zip(kern, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, tol", [((13, 40, 24), 1e-4), ((512, 784, 100), 1.4e-8)])
def test_tuple_step_is_one_trial_step_of_k3(cuda, shape, tol):
    """K13 at each trial step of a streamed K3 record (``whole_solve_fwd``
    for MLPDynamics), at that step's own t, dt_eff, y and k1: its k6 and k7
    rows equal K3's streamed ``ks[i, 4]`` and ``ks[i, 5]`` bitwise, and its
    y_new equals ``hy[i + 1]`` bitwise where the step was accepted. K13 is
    one trial step of K3's stages on the same plan."""
    args = _solve_args(*shape, cuda, tol=tol)
    rec = ws.whole_solve_fwd(*args)
    ns = int(rec.final[3:5].sum().item())
    st = rec.streams
    accepted = 0
    for i in range(ns):
        y_new, k7, _, k6, _ = fm.stage_sweep_fwd(st[ws.ST_T, i], st[ws.TEL_DT, i], rec.hy[i],
                                                 rec.hf[i], args[5])
        assert torch.equal(k6, rec.ks[i, 4]) and torch.equal(k7, rec.ks[i, 5]), i
        if st[ws.ST_ACC, i].item() == 1.0:
            assert torch.equal(y_new, rec.hy[i + 1]), i
            accepted += 1
    assert ns > 1 and accepted >= 1


def _row_cts(batch, dim, device, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(batch, dim)).astype(np.float32), device=device)
            for _ in range(5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape", [(13, 40, 24), (5, 8, 5), (512, 784, 100),
                                   (1024, 784, 100)])
def test_tuple_kernels_match_plain_versions(cuda, shape, dt):
    """K13/K14 against their plain versions, ragged row tiles included and,
    at 1024x784x100, both on the batch in two row chunks on 132
    multiprocessors: K13's rows within 1e-4 (relative, Frobenius; the error
    row, a cancellation, within 3e-4, chip_smoke.py's TUPLE_ERR_BOUND) of
    the plain step and of its schedule (``plain_tuple_solve_step`` on the
    card's plan), and within 3 times their distance from float64, the
    backward within 1e-3; both bitwise deterministic; one launch a call."""
    y, k1, leaves, _ = _inputs(*shape, cuda)
    cts = _row_cts(shape[0], shape[1], cuda)
    t, dt_ = torch.tensor(0.3, device=cuda), torch.tensor(dt, device=cuda)
    parts = fm._split_params(*leaves)
    fm.reset_launches()
    kern = fm.stage_sweep_fwd(t, dt_, y, k1, leaves)
    _assert_k13_matches(kern, t, dt_, y, k1, leaves)
    kern_b = fm.stage_sweep_bwd(t, dt_, y, k1, leaves, cts)
    plain_b = fm._bwd_math(t, dt_, y, k1, parts, cts)
    flat = lambda g: [*g[:4], *g[4]]
    for a, b in zip(flat(kern_b), flat(plain_b)):
        assert _rel(a, b) <= 1e-3
    assert all(torch.equal(a, b) for a, b in zip(kern, fm.stage_sweep_fwd(t, dt_, y, k1, leaves)))
    again = fm.stage_sweep_bwd(t, dt_, y, k1, leaves, cts)
    assert all(torch.equal(a, b) for a, b in zip(flat(kern_b), flat(again)))
    assert fm.LAUNCHES == {"normed_tsit5_fwd": 0, "normed_tsit5_bwd": 0, "mlp_tsit5_fwd": 2,
                           "mlp_tsit5_bwd": 2}


def _assert_k14_matches_schedule(cuda, shape, dt):
    """K14 against its schedule (``plain_tuple_walk_step`` on the card's
    plan) at the walk's bounds: every output within 1e-3 of the float32
    schedule and within 3 times its distance from the float64 schedule,
    plus 1e-5."""
    y, k1, leaves, _ = _inputs(*shape, cuda)
    cts = _row_cts(shape[0], shape[1], cuda)
    t, dt_ = torch.tensor(0.3, device=cuda), torch.tensor(dt, device=cuda)
    plan = ws.walk_plan(*shape, torch.cuda.get_device_properties(cuda).multi_processor_count)
    d = lambda x: x.double()
    flat = lambda g: [*g[:4], *g[4]]
    rows = lambda g: [*g[:4], *wc.weight_cotangents_plain(*g[4])]
    kern = flat(fm.stage_sweep_bwd(t, dt_, y, k1, leaves, cts))
    plain = rows(ws.plain_tuple_walk_step(t, dt_, y, k1, leaves, cts, plan))
    plain64 = rows(ws.plain_tuple_walk_step(d(t), d(dt_), d(y), d(k1), [d(x) for x in leaves],
                                            [d(c) for c in cts], plan))
    for name, a, b, c in zip(["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"],
                             kern, plain, plain64):
        assert _rel(a, b) <= 1e-3, (name, _rel(a, b))
        assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5, (name, _rel(a, c), _rel(b, c))
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape", [(13, 40, 24), (5, 8, 5), (96, 200, 48), (512, 784, 100),
                                   (1024, 784, 100)])
def test_tuple_walk_matches_its_schedule(cuda, shape, dt):
    """K14 (``csrc/mlp_step_walk.cuh``) against ``plain_tuple_walk_step``,
    the same walk in the kernel's order of summation, on the card's plan:
    one column block (13x40x24, 5x8x5), seven of 32 columns (96x200x48),
    the flagship's 8 of 100, and two row chunks (1024x784x100)."""
    plan = _assert_k14_matches_schedule(cuda, shape, dt)
    assert plan.chunks == (2 if shape[0] == 1024 else 1)


@pytest.mark.cuda
def test_tuple_walk_in_row_chunks_matches_its_schedule(cuda, monkeypatch):
    """K14 on the plan of a card of 4 multiprocessors: 4 tiles, the batch of
    256 walked in row chunks one after another."""
    plan = ws.walk_plan

    def small_card(B, D, H, sms, limit=ws.SMEM_LIMIT):
        return plan(B, D, H, 4, limit)

    monkeypatch.setattr(ws, "walk_plan", small_card)
    assert _assert_k14_matches_schedule(cuda, (256, 64, 32), 0.3).chunks > 1


def _assert_k2_matches_schedule(cuda, shape, dt, tol):
    """K2 against its schedule (``plain_normed_walk_step`` on the card's
    plan) at the walk's bounds: every output within 1e-3 of the float32
    schedule and within 3 times its distance from the float64 schedule, plus
    1e-5 (ct_t, whose terms cancel, plus float32's unit roundoff times its
    terms' magnitudes); bitwise deterministic."""
    y, k1, leaves, cts = _inputs(*shape, cuda)
    t, dt_ = torch.tensor(0.3, device=cuda), torch.tensor(dt, device=cuda)
    plan = ws.walk_plan(*shape, torch.cuda.get_device_properties(cuda).multi_processor_count)
    d = lambda x: x.double()
    flat = lambda g: [*g[:4], *g[4]]
    kern = flat(fm.normed_sweep_bwd(t, dt_, y, k1, leaves, cts, tol, tol))
    plain = ws.plain_normed_walk_step(t, dt_, y, k1, leaves, cts, tol, tol, plan)
    plain64 = ws.plain_normed_walk_step(d(t), d(dt_), d(y), d(k1), [d(x) for x in leaves],
                                        [d(c) for c in cts], tol, tol, plan)
    cp2, _, cp1, _ = plain64[4]
    t_terms = ((cp2.abs() @ d(leaves[2])[:, -1].abs()).sum()
               + (cp1.abs() @ d(leaves[0])[:, -1].abs()).sum()).item()
    plain, plain64 = ([*g[:4], *wc.weight_cotangents_plain(*g[4])] for g in (plain, plain64))
    dist = lambda u: abs(u.double() - plain64[0]).item()
    assert dist(kern[0]) <= 3 * dist(plain[0]) + 2.0 ** -24 * t_terms
    for name, a, b, c in zip(["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"],
                             kern, plain, plain64):
        assert _rel(a, b) <= 1e-3, (name, _rel(a, b))
        if name != "ct_t":
            assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5, (name, _rel(a, c), _rel(b, c))
    again = flat(fm.normed_sweep_bwd(t, dt_, y, k1, leaves, cts, tol, tol))
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape", [(13, 40, 24), (5, 8, 5), (96, 200, 48), (512, 784, 100),
                                   (1024, 784, 100)])
def test_normed_walk_matches_its_schedule(cuda, shape, dt, tol):
    """K2 (``csrc/mlp_step_walk.cuh`` with the normed seeds) against
    ``plain_normed_walk_step``, the same walk in the kernel's order of
    summation, on the card's plan: one column block (13x40x24, 5x8x5), seven
    of 32 columns (96x200x48), the flagship's 8 of 100, and two row chunks
    (1024x784x100); one launch a call."""
    fm.reset_launches()
    plan = _assert_k2_matches_schedule(cuda, shape, dt, tol)
    assert plan.chunks == (2 if shape[0] == 1024 else 1)
    assert fm.LAUNCHES["normed_tsit5_bwd"] == 2


@pytest.mark.cuda
def test_normed_walk_in_row_chunks_matches_its_schedule(cuda, monkeypatch):
    """K2 on the plan of a card of 4 multiprocessors: 4 tiles, the batch of
    256 walked in row chunks one after another."""
    plan = ws.walk_plan

    def small_card(B, D, H, sms, limit=ws.SMEM_LIMIT):
        return plan(B, D, H, 4, limit)

    monkeypatch.setattr(ws, "walk_plan", small_card)
    assert _assert_k2_matches_schedule(cuda, (256, 64, 32), 0.3, 1e-4).chunks > 1


@pytest.mark.cuda
def test_normed_walk_refuses_bad_inputs(cuda):
    """K2's wrapper refuses what the kernel does not take, and a shape no
    tile plan fits raises walk_plan's ValueError (no fallback)."""
    y, k1, leaves, cts = _inputs(8, 16, 12, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(TypeError):
        fm.normed_sweep_bwd(t, dt, y, k1, leaves, [cts[0].double(), *cts[1:]], 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_bwd(t, dt, y, k1, leaves, [cts[0].t(), *cts[1:]], 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_bwd(t, dt, y, k1, leaves, [cts[0], cts[1][:4], *cts[2:]], 1e-4, 1e-4)
    y, k1, leaves, cts = _inputs(8, 8, 20_000, cuda)
    with pytest.raises(ValueError, match="no tile plan"):
        fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-4, 1e-4)


def _assert_k1_matches_schedule(cuda, shape, dt, tol):
    """K1 (``csrc/mlp_step_solve.cuh`` with ``NormedEnd``) against its
    schedule (``plain_normed_solve_step`` on the card's plan) and the plain
    step: its rows within 1e-4 of each and within 3 times the float32
    schedule's distance from the float64 schedule, plus 1e-7; its three norm
    sums within 1e-4 of each (``chip_smoke.py``'s FWD_BOUND); y_new and k7
    bitwise K13's on the same inputs (one kernel, the same stages); bitwise
    deterministic. Returns the plan."""
    y, k1, leaves, _ = _inputs(*shape, cuda)
    t, dt_ = torch.tensor(0.3, device=cuda), torch.tensor(dt, device=cuda)
    plan = ws.walk_plan(*shape, torch.cuda.get_device_properties(cuda).multi_processor_count)
    d = lambda x: x.double()
    kern = fm.normed_sweep_fwd(t, dt_, y, k1, leaves, tol, tol)
    sched = ws.plain_normed_solve_step(t, dt_, y, k1, leaves, plan, tol, tol)
    sched64 = ws.plain_normed_solve_step(d(t), d(dt_), d(y), d(k1), [d(x) for x in leaves],
                                         plan, tol, tol)
    plain = fm._reference_normed_sweep(t, dt_, y, k1, fm._split_params(*leaves), tol, tol)
    for name, a, b, c, p in zip(["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"], kern, sched,
                                sched64, plain):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= 1e-4 and _rel(a, p) <= 1e-4, (name, _rel(a, b), _rel(a, p))
        if a.dim():
            assert _rel(a, c) <= 3 * _rel(b, c) + 1e-7, (name, _rel(a, c), _rel(b, c))
    tup = fm.stage_sweep_fwd(t, dt_, y, k1, leaves)
    assert torch.equal(kern[0], tup[0]) and torch.equal(kern[1], tup[1])
    again = fm.normed_sweep_fwd(t, dt_, y, k1, leaves, tol, tol)
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("dt", [0.05, 0.3])
@pytest.mark.parametrize("shape", [(13, 40, 24), (5, 8, 5), (96, 200, 48), (512, 784, 100),
                                   (1024, 784, 100)])
def test_normed_step_matches_its_schedule(cuda, shape, dt, tol):
    """K1 against ``plain_normed_solve_step``, the same step in the kernel's
    order of summation, on the card's plan: one column block (13x40x24,
    5x8x5), seven of 32 columns (96x200x48), the flagship's 8 of 100, and two
    row chunks (1024x784x100); one launch a call."""
    fm.reset_launches()
    plan = _assert_k1_matches_schedule(cuda, shape, dt, tol)
    assert plan.chunks == (2 if shape[0] == 1024 else 1)
    assert fm.LAUNCHES["normed_tsit5_fwd"] == 2


@pytest.mark.cuda
def test_normed_step_in_row_chunks_matches_its_schedule(cuda, monkeypatch):
    """K1 on the plan of a card of 4 multiprocessors: 4 tiles, the batch of
    256 in row chunks one after another, each tile's norm sums carried over
    the chunks before the slots are summed."""
    plan = ws.walk_plan

    def small_card(B, D, H, sms, limit=ws.SMEM_LIMIT):
        return plan(B, D, H, 4, limit)

    monkeypatch.setattr(ws, "walk_plan", small_card)
    assert _assert_k1_matches_schedule(cuda, (256, 64, 32), 0.3, 1e-4).chunks > 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape, tol", [((13, 40, 24), 1e-4), ((512, 784, 100), 1.4e-8)])
def test_normed_step_sums_are_k3s(cuda, shape, tol):
    """K1 at each trial step of a streamed K3 record (``whole_solve_fwd``
    for MLPDynamics), at that step's own t, dt_eff, y and k1: its three norm
    sums equal the ones K3 recorded for the step bitwise (the same stages,
    the same per-tile algebra, block sums and tile order), and its k7 equals
    K3's streamed ``ks[i, 5]``."""
    args = _solve_args(*shape, cuda, tol=tol)
    rec = ws.whole_solve_fwd(*args)
    ns = int(rec.final[3:5].sum().item())
    st = rec.streams
    for i in range(ns):
        _, k7, *sums = fm.normed_sweep_fwd(st[ws.ST_T, i], st[ws.TEL_DT, i], rec.hy[i],
                                           rec.hf[i], args[5], tol, tol)
        assert torch.equal(k7, rec.ks[i, 5]), i
        assert torch.equal(torch.stack(sums), st[[ws.ST_E, ws.ST_N, ws.ST_D], i]), i
    assert ns > 1


@pytest.mark.cuda
def test_normed_step_refuses_bad_inputs(cuda):
    """K1's wrapper refuses what the kernel does not take, and a shape no
    tile plan fits raises walk_plan's ValueError (no fallback)."""
    y, k1, leaves, _ = _inputs(8, 16, 12, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(TypeError):
        fm.normed_sweep_fwd(t, dt, y, k1.double(), leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_fwd(t, dt, y, k1.t(), leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_fwd(t, dt, y, k1[:4], leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_fwd(t, dt, y, k1, [leaves[0][:, :-1], *leaves[1:]], 1e-4, 1e-4)
    y, k1, leaves, _ = _inputs(8, 8, 20_000, cuda)
    with pytest.raises(ValueError, match="no tile plan"):
        fm.normed_sweep_fwd(t, dt, y, k1, leaves, 1e-4, 1e-4)


def _assert_k12_matches_schedule(cuda, shape):
    """K12 against its schedule (``plain_lanes_walk_step`` on the card's
    plan with K12's state) at the walk's bounds, per-lane (t, dt) with
    finished lanes: every output within 1e-3 of the float32 schedule and
    within 3 times its distance from the float64 schedule, plus 1e-5 (ct_t,
    whose rows' terms cancel, plus float32's unit roundoff times its terms'
    magnitudes, the norm over the rows); the finished lanes' rows finite;
    bitwise deterministic."""
    y, k1, leaves, _ = _inputs(*shape, cuda)
    t, dt = _lane_times(shape[0], cuda)
    cts = _row_cts(shape[0], shape[1], cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ws.walk_plan(*shape, sms, state=ws.LANE_STATE)
    d = lambda x: x.double()
    flat = lambda g: [*g[:4], *g[4]]
    kern = flat(fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts))
    plain = ws.plain_lanes_walk_step(t, dt, y, k1, leaves, cts, plan)
    plain64 = ws.plain_lanes_walk_step(d(t), d(dt), d(y), d(k1), [d(x) for x in leaves],
                                       [d(c) for c in cts], plan)
    B = shape[0]
    cp2, _, cp1, _ = plain64[4]
    t_terms = ((cp2.abs() @ d(leaves[2])[:, -1].abs()).reshape(6, B).sum(0)
               + (cp1.abs() @ d(leaves[0])[:, -1].abs()).reshape(6, B).sum(0))
    plain, plain64 = ([*g[:4], *wc.weight_cotangents_plain(*g[4])] for g in (plain, plain64))
    dist = lambda u: torch.linalg.vector_norm(u.double() - plain64[0]).item()
    assert dist(kern[0]) <= (3 * dist(plain[0])
                             + 2.0 ** -24 * torch.linalg.vector_norm(t_terms).item())
    for name, a, b, c in zip(["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"],
                             kern, plain, plain64):
        assert a.shape == b.shape and torch.isfinite(a).all(), name
        assert _rel(a, b) <= 1e-3, (name, _rel(a, b))
        if name != "ct_t":
            assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5, (name, _rel(a, c), _rel(b, c))
    again = flat(fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts))
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 40, 24), (5, 8, 5), (96, 200, 48), (512, 784, 100),
                                   (1024, 784, 100)])
def test_lanes_walk_matches_its_schedule(cuda, shape):
    """K12 (``csrc/mlp_step_walk.cuh`` with ``LaneSeed``) against
    ``plain_lanes_walk_step``, the same walk in the kernel's order of
    summation, on the card's plan: one column block (13x40x24, 5x8x5), seven
    of 32 columns (96x200x48), the flagship's 8 of 100, and two row chunks
    (1024x784x100); one launch a call."""
    fl.reset_launches()
    plan = _assert_k12_matches_schedule(cuda, shape)
    assert plan.chunks == (2 if shape[0] == 1024 else 1)
    assert fl.LAUNCHES == {"mlp_lanes_tsit5_fwd": 0, "mlp_lanes_tsit5_bwd": 2}


@pytest.mark.cuda
def test_lanes_walk_in_row_chunks_matches_its_schedule(cuda, monkeypatch):
    """K12 on the plan of a card of 4 multiprocessors: 4 tiles, the batch of
    256 walked in row chunks one after another."""
    plan = ws.walk_plan

    def small_card(B, D, H, sms, limit=ws.SMEM_LIMIT, state=ws.WALK_STATE):
        return plan(B, D, H, 4, limit, state)

    monkeypatch.setattr(ws, "walk_plan", small_card)
    assert _assert_k12_matches_schedule(cuda, (256, 64, 32)).chunks > 1


def _assert_k11_matches_schedule(cuda, shape):
    """K11 (``csrc/mlp_step_solve.cuh`` with ``LaneEnd``) against its
    schedule (``plain_lanes_solve_step`` on the card's plan with K12's
    state) and against its plain version ``_reference_sweep_lanes``, per-lane
    (t, dt) with finished lanes: all five rows bitwise equal to both (each
    affine map summed in float64 and rounded once, every other op as ATen's);
    the finished lanes keep y and have zero error; bitwise deterministic.
    Returns the plan."""
    y, k1, leaves, _ = _inputs(*shape, cuda)
    t, dt = _lane_times(shape[0], cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = ws.walk_plan(*shape, sms, state=ws.LANE_STATE)
    kern = fl.sweep_lanes_fwd(t, dt, y, k1, leaves)
    sched = ws.plain_lanes_solve_step(t, dt, y, k1, leaves, plan)
    plain = fl._reference_sweep_lanes(t[:, None], dt[:, None], y, k1,
                                      fm._split_params(*leaves))
    for name, a, b, c in zip(["y_new", "k7", "err", "k6", "g6"], kern, sched, plain):
        assert torch.equal(a, b), (name, int((a != b).sum()))
        assert torch.equal(a, c), (name, int((a != c).sum()))
    done = dt == 0
    assert torch.equal(kern[0][done], y[done]) and not kern[2][done].any()
    again = fl.sweep_lanes_fwd(t, dt, y, k1, leaves)
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 40, 24), (5, 8, 5), (96, 200, 48), (512, 784, 100),
                                   (1024, 784, 100)])
def test_lanes_step_matches_its_schedule(cuda, shape):
    """K11 against ``plain_lanes_solve_step`` and its plain version on the
    card's plan: one column block (13x40x24, 5x8x5), seven of 32 columns
    (96x200x48), the flagship's 8 of 100, and two row chunks
    (1024x784x100); one launch a call."""
    fl.reset_launches()
    plan = _assert_k11_matches_schedule(cuda, shape)
    assert plan.chunks == (2 if shape[0] == 1024 else 1)
    assert fl.LAUNCHES == {"mlp_lanes_tsit5_fwd": 2, "mlp_lanes_tsit5_bwd": 0}


@pytest.mark.cuda
def test_lanes_step_in_row_chunks_matches_its_schedule(cuda, monkeypatch):
    """K11 on the plan of a card of 4 multiprocessors: 4 tiles, the batch of
    256 solved in row chunks one after another."""
    plan = ws.walk_plan

    def small_card(B, D, H, sms, limit=ws.SMEM_LIMIT, state=ws.WALK_STATE):
        return plan(B, D, H, 4, limit, state)

    monkeypatch.setattr(ws, "walk_plan", small_card)
    assert _assert_k11_matches_schedule(cuda, (256, 64, 32)).chunks > 1


@pytest.mark.cuda
def test_lanes_walk_refuses_bad_inputs(cuda):
    """K12's wrapper refuses what the kernel does not take, and a shape no
    tile plan fits raises walk_plan's ValueError (no fallback)."""
    y, k1, leaves, _ = _inputs(8, 16, 12, cuda)
    t, dt = _lane_times(8, cuda)
    cts = _row_cts(8, 16, cuda)
    with pytest.raises(TypeError):
        fl.sweep_lanes_bwd(t, dt, y, k1, leaves, [cts[0].double(), *cts[1:]])
    with pytest.raises(TypeError):
        fl.sweep_lanes_bwd(t, dt.double(), y, k1, leaves, cts)
    with pytest.raises(ValueError):
        fl.sweep_lanes_bwd(t, dt, y, k1, leaves, [cts[0].t(), *cts[1:]])
    with pytest.raises(ValueError):
        fl.sweep_lanes_bwd(t[:4], dt, y, k1, leaves, cts)
    y, k1, leaves, _ = _inputs(8, 8, 20_000, cuda)
    with pytest.raises(ValueError, match="no tile plan"):
        fl.sweep_lanes_bwd(t, dt, y, k1, leaves, _row_cts(8, 8, cuda))


@pytest.mark.cuda
def test_tuple_wrappers_refuse_bad_inputs(cuda):
    y, k1, leaves, _ = _inputs(8, 16, 12, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    cts = _row_cts(8, 16, cuda)
    with pytest.raises(TypeError):
        fm.stage_sweep_fwd(t, dt, y.double(), k1, leaves)
    with pytest.raises(ValueError):
        fm.stage_sweep_fwd(t, dt, y, k1.cpu(), leaves)
    with pytest.raises(ValueError):
        fm.stage_sweep_bwd(t, dt, y, k1, leaves, [c.t() for c in cts])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["adjoint", "scan"])
def test_tuple_sweep_solve_matches_plain_version(cuda, mode):
    """``odeint`` with ``mlp_dynamics_stage_sweep`` (K13/K14) against the
    same solve with its plain version, MLPDynamics(784, 100) at batch 64 and
    rtol=atol=1e-5 (chip_smoke.py phase 26 at a smaller batch), on the
    replay adjoint and the checkpointed scan: the same NFE and accepts, y1
    within 1e-5, the gradients of sum(y1^2) within 1e-3 and of sum(y1^2) +
    100 * error_estimate within 5e-2 (relative); K13 launched twice a trial
    step, K14 once, and no other step kernel."""
    from regneuralde_tpu_torch import reg
    from regneuralde_tpu_torch.models import MLPDynamics, NeuralODE

    gen = torch.Generator().manual_seed(0)
    node = NeuralODE(MLPDynamics(784, 100, device=cuda, generator=gen), rtol=1e-5, atol=1e-5,
                     max_steps=96)
    x = torch.rand(64, 784, generator=gen).to(cuda)
    leaves = tuple(node.dynamics.parameters())
    outs = {}
    for name, sweep in (("kernel", fm.mlp_dynamics_stage_sweep),
                        ("plain", fm.plain_mlp_stage_sweep)):
        fm.reset_launches()
        res = []
        for reg_weight in (0.0, 100.0):
            sol = ode.odeint(node._func, x, 0.0, 1.0, leaves, rtol=1e-5, atol=1e-5,
                             max_steps=96, mode=mode, stage_sweep=sweep)
            val = sol.y1.square().sum() + reg_weight * reg.error_estimate(sol.telemetry,
                                                                          "mean")
            res.append((sol, torch.autograd.grad(val, leaves)))
        outs[name] = (res, dict(fm.LAUNCHES))
    (ka, la), (pa, lp) = outs["kernel"], outs["plain"]
    steps = sum(int(s.telemetry.live.sum()) for s, _ in ka)
    assert la == {"normed_tsit5_fwd": 0, "normed_tsit5_bwd": 0, "mlp_tsit5_fwd": 2 * steps,
                  "mlp_tsit5_bwd": steps}
    assert not any(lp.values())
    for (a, ga), (b, gb), bound in zip(ka, pa, (1e-3, 5e-2)):
        assert a.stats == b.stats and a.stats.success
        assert torch.equal(a.telemetry.accepted, b.telemetry.accepted)
        assert _rel(a.y1, b.y1) <= 1e-5
        for u, v in zip(ga, gb):
            assert _rel(u, v) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("mode, sweep", [("adjoint", None), ("scan", None),
                                         ("adjoint", "k13"), ("scan", "k13")])
def test_matmul_precision_holds_in_the_backward_on_the_card(cuda, mode, sweep):
    """With the caller's float32 products at TF32 (``"high"``), every
    matrix product of a card solve's backward (the engine's device thread
    included) runs at ``odeint``'s ``matmul_precision="highest"``: the
    replay adjoint and the scan, over the generic sweep and over K13/K14;
    the caller's precision holds again after the backward."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from regneuralde_tpu_torch.models import MLPDynamics, NeuralODE

    class Precisions(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
                self.seen.append(torch.get_float32_matmul_precision())
            return func(*args, **(kwargs or {}))

    gen = torch.Generator().manual_seed(1)
    node = NeuralODE(MLPDynamics(40, 24, device=cuda, generator=gen), rtol=1e-4, atol=1e-4,
                     max_steps=64)
    x = torch.rand(13, 40, generator=gen).to(cuda).requires_grad_(True)
    leaves = tuple(node.dynamics.parameters())
    kw = {} if sweep is None else dict(stage_sweep=fm.mlp_dynamics_stage_sweep)
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        sol = ode.odeint(node._func, x, 0.0, 1.0, leaves, rtol=1e-4, atol=1e-4, max_steps=64,
                         mode=mode, saveat=[0.0, 0.5, 1.0], matmul_precision="highest", **kw)
        with Precisions() as bwd:
            torch.autograd.grad(sol.y1.square().sum() + sol.ys.square().sum(), (*leaves, x))
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(old)
    assert after == "high" and len(bwd.seen) > 0 and set(bwd.seen) == {"highest"}


@pytest.mark.cuda
@pytest.mark.parametrize("t0", [0.0, 0.1, 0.9, -5.0])
@pytest.mark.parametrize("shape", [(32, 20), (512, 784)])
def test_spike_kernel_matches_plain_version(cuda, shape, t0):
    """K15 against its plain version: the same iteration count, y1 and tel
    within 1e-6, the history rows < n bitwise (copies), run-to-run bitwise;
    one launch a call."""
    y0 = torch.randn(shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    sp.reset_launches()
    y1, tel, hy, n = sp.spike_wholesolve(t0, y0)
    assert sp.LAUNCHES == {"spike_wholesolve": 1}
    py1, ptel, phy, pn = sp.plain_spike_wholesolve(t0, y0)
    assert n == pn == {0.0: 4, 0.1: 4, 0.9: 1, -5.0: 16}[t0]
    assert (y1 - py1).abs().max().item() <= 1e-6
    assert (tel - ptel).abs().max().item() <= 1e-6
    assert torch.equal(hy[:n], phy[:n])
    again = sp.spike_wholesolve(t0, y0)
    assert torch.equal(again[0], y1) and torch.equal(again[1], tel)
    assert torch.equal(again[2][:n], hy[:n])


@pytest.mark.cuda
def test_spike_wrapper_refuses_bad_inputs(cuda):
    with pytest.raises(ValueError, match="multiple of 4"):
        sp.spike_wholesolve(0.0, torch.zeros(3, 5, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        sp.spike_wholesolve(0.0, torch.zeros(4, 4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="maxs"):
        sp.spike_wholesolve(0.0, torch.zeros(4, 4, device=cuda), maxs=0)


def _cubic_args(batch, hidden, device, tol, max_steps, saveat=None, seed=2):
    """Seeded cubic-pair leaves (drift 2 -> hidden -> 2 after the cube,
    diffusion 2 -> 2), y0 near the toy's u0 = [2, 0] and draws."""
    args, kw = _sde_args(batch, 2, hidden, device, tol, max_steps, saveat, seed)
    y0 = args[3] + torch.tensor([[1.5, 0.0]], device=device)
    if saveat is not None:
        kw["saveat"], kw["ys_init"] = sde_ops.save_rows_at_start(
            torch.tensor(saveat, device=device), args[0], y0)
    kw.update(solver="sosri", body="cubic")
    return (*args[:3], y0, *args[4:]), kw


CUBIC_SAVES = np.linspace(0.0, 1.0, 30).astype(np.float32).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("batch, hidden, tol, saveat", [
    (100, 50, 3e-1, CUBIC_SAVES), (100, 50, 3e-2, CUBIC_SAVES), (13, 8, 1e-2, None)])
def test_sde_whole_solve_cubic_kernels_match_plain_versions(cuda, batch, hidden, tol, saveat):
    """K9/K10<CubicPair> as the MLP pair's test: the same steps and save
    cursors, y1 and the saves within 1e-5, K10 within 1e-3 of the plain
    version and within 3 times the plain version's distance from a float64
    walk, plus 1e-5; both bitwise deterministic."""
    S = 256
    args, kw = _cubic_args(batch, hidden, cuda, tol, S, saveat)
    rk = sw.sde_whole_solve_fwd(*args, **kw)
    rp = sw.plain_sde_whole_solve_fwd(*args, **kw)
    assert rk.final[3:].tolist() == rp.final[3:].tolist() and rk.final[5] == 1.0
    assert torch.equal(rk.streams[sw.ST_ACC], rp.streams[sw.ST_ACC])
    assert torch.equal(rk.cursors, rp.cursors)
    assert _rel(rk.y1, rp.y1) <= 1e-5
    if saveat is not None:
        assert _rel(rk.ys, rp.ys) <= 1e-5
    if tol == 3e-2:
        assert rk.final[4].item() > 0, "the case needs rejections"
    ns = int(rk.final[3:5].sum())
    g = torch.Generator().manual_seed(7)
    ct_y1 = torch.randn(batch, 2, generator=g).to(cuda)
    ct_tel = (0.1 * torch.randn(4, S, generator=g)).to(cuda)
    ct_ys = None if saveat is None else torch.randn(len(saveat), batch, 2, generator=g).to(cuda)
    t0, t1, _, _, leaves, _, _, ctrl = args[:8]
    bargs = (ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl, *args[9:])
    bkw = dict(n_drift=2, solver="sosri", saveat=kw.get("saveat"), ct_ys=ct_ys, body="cubic")
    gk = sw.sde_whole_solve_bwd(rk, *bargs, **bkw)
    gp = sw.plain_sde_whole_solve_bwd(rk, *bargs, **bkw)
    d = lambda x: None if x is None else x.double()
    g64 = sw.plain_sde_whole_solve_bwd(
        sw.SDERecord(*map(d, rk)), ns, d(ct_y1), d(ct_tel), d(t0), d(t1), [d(x) for x in leaves],
        tol, tol, ctrl, d(args[9]), d(args[10]), n_drift=2, solver="sosri",
        saveat=d(kw.get("saveat")), ct_ys=d(ct_ys), body="cubic")
    groups = lambda g: [torch.stack(g[:3]), *g[3:]]
    for a, b, c in zip(groups(gk), groups(gp), groups(g64)):
        if b.numel():
            assert _rel(a, b) <= 1e-3
            assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5
    again = sw.sde_whole_solve_bwd(rk, *bargs, **bkw)
    assert all(torch.equal(x, y) for x, y in zip(gk, again))
    rk2 = sw.sde_whole_solve_fwd(*args, **kw)
    assert torch.equal(rk.y1, rk2.y1) and torch.equal(rk.streams, rk2.streams)


@pytest.mark.cuda
def test_sde_toy_trains_through_cubic_k9_k10(cuda):
    """The toy SDE's training step (``training.sde_toy``, 100 trajectories,
    30 saves) on ``fused=True`` against ``fused=False`` on the card, on the
    same weights and draws: the same NFE and accepts, the loss within 1e-5
    and the gradients within 1e-3 (relative); one K9 and one K10 launch, no
    other kernel."""
    from regneuralde_tpu_torch.data import make_sde_demo
    from regneuralde_tpu_torch.training import sde_toy as st

    means, vars_, tsteps, _ = make_sde_demo()
    means, vars_ = torch.from_numpy(means).to(cuda), torch.from_numpy(vars_).to(cuda)
    u0 = st.sde_toy_u0(device=cuda)
    noise = sde_ops.presample_noise(torch.Generator(device=cuda).manual_seed(1), u0.shape,
                                    st.MAX_STEPS)
    outs = {}
    for route in (True, False):
        m = st.build_sde_toy(tsteps, route, device=cuda,
                             generator=torch.Generator().manual_seed(0))
        for mod in (ws, fm, fg, fc, sw, fl, sp):
            mod.reset_launches()
        loss, out = st.sde_toy_loss(m, u0, means, vars_, noise)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        outs[route] = (loss, out, grads, {k: v for mod in (ws, fm, fg, fc, sw, fl, sp)
                                          for k, v in mod.LAUNCHES.items()})
    (la, a, ga, na), (lb, b, gb, nb) = outs[True], outs[False]
    want = {k: 0 for k in na}
    want.update(sde_whole_solve_cubic_fwd=1, sde_whole_solve_cubic_bwd=1)
    assert na == want and not any(nb.values())
    assert (a.nfe1, a.nfe2) == (b.nfe1, b.nfe2)
    assert torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    assert a.solution.stats.success
    assert abs(la.item() - lb.item()) <= 1e-5 * abs(lb.item())
    for u, v in zip(ga, gb):
        assert _rel(u, v) <= 1e-3


def _wcot_rows(K, D, H, device, seed=0, offset=0):
    """Seeded random rows of the weight-cotangent contraction: cp2 (K, D),
    he (K, H+2), cp1 (K, H), ye (K, D+2). ``offset`` rows are cut from the
    front of each, so a row array may start off a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(K + offset, w)).astype(np.float32),
                         device=device)[offset:]
            for w in (D, H + 2, H, D + 2)]


def _wcot_errors(got, rows):
    """Per product (cW2 | cb2, cW1 | cb1): the largest distance of ``got``
    and of the float32 ``torch.mm`` at "highest" (TF32 off) from the float64
    product."""
    cp2, he, cp1, ye = rows
    prev = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = []
        for a, b, main, last in ((cp2, he, got[2], got[3]), (cp1, ye, got[0], got[1])):
            exact = torch.mm(a.double().t(), b.double())
            mm = torch.mm(a.t(), b).double()
            kern = torch.cat([main, last[:, None]], dim=1).double()
            out.append(((kern - exact).abs().max().item(), (mm - exact).abs().max().item()))
        return out
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cuda.matmul.allow_tf32 = prev[1]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [78, 384, 3072, 101_376])
@pytest.mark.parametrize("D, H", [(40, 24), (784, 100), (8, 5)])
def test_weight_cotangents_kernel_within_float64_bound(cuda, K, D, H):
    """The split-K contraction against the float64 product: within 3 times
    the float32 ``torch.mm``'s distance plus 1e-7, in nn.Linear layout; one
    launch a call. 8 x 5 has odd row widths (4-byte copies)."""
    from regneuralde_tpu_torch.ops import weight_cotangents as wc

    rows = _wcot_rows(K, D, H, cuda)
    wc.reset_launches()
    got = wc.weight_cotangents(*rows)
    torch.cuda.synchronize()
    assert [tuple(x.shape) for x in got] == [(H, D + 1), (H,), (D, H + 1), (D,)]
    assert wc.LAUNCHES == {"weight_cotangents": 1}
    for d_kern, d_mm in _wcot_errors(got, rows):
        assert d_kern <= 3 * d_mm + 1e-7, (d_kern, d_mm)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
def test_weight_cotangents_kernel_is_deterministic(cuda, offset):
    """Chunks summed in a fixed order, no atomics: two runs bitwise equal,
    also on rows that start off a 16-byte boundary (narrower copies)."""
    from regneuralde_tpu_torch.ops import weight_cotangents as wc

    rows = _wcot_rows(3072 + 13, 40, 24, cuda, seed=1, offset=offset)
    a = wc.weight_cotangents(*rows)
    b = wc.weight_cotangents(*rows)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    for d_kern, d_mm in _wcot_errors(a, rows):
        assert d_kern <= 3 * d_mm + 1e-7, (d_kern, d_mm)
    zero = wc.weight_cotangents(*(x[:0] for x in rows))
    assert all(torch.equal(x, torch.zeros_like(x)) for x in zero)


@pytest.mark.cuda
def test_weight_cotangents_counted_inside_each_backward(cuda):
    """K2, K14, K12 and K4<MlpDyn> each end in one launch of the
    contraction, counted in its own counter and nowhere else."""
    from regneuralde_tpu_torch.ops import weight_cotangents as wc

    y, k1, leaves, cts = _inputs(13, 40, 24, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    rows = _row_cts(13, 40, cuda)
    lane_t = torch.full((13,), T, device=cuda)
    lane_dt = torch.full((13,), DT, device=cuda)
    args = _solve_args(13, 40, 24, cuda, scale=3.0)
    rec = ws.whole_solve_fwd(*args)
    ns = int(rec.final[3:5].sum().item())
    ct_y1, ct_tel = _bwd_seeds(13, 40, cuda)
    calls = [lambda: fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-4, 1e-4),
             lambda: fm.stage_sweep_bwd(t, dt, y, k1, leaves, rows),
             lambda: fl.sweep_lanes_bwd(lane_t, lane_dt, y, k1, leaves, rows),
             lambda: ws.whole_solve_bwd(rec, ns, ct_y1, ct_tel, args[0], args[1], args[5],
                                        1e-4, 1e-4, CTRL)]
    for i, call in enumerate(calls, 1):
        if i == 1:
            wc.reset_launches()
        before = {**fm.LAUNCHES, **fl.LAUNCHES, **ws.LAUNCHES}
        call()
        after = {**fm.LAUNCHES, **fl.LAUNCHES, **ws.LAUNCHES}
        assert wc.LAUNCHES == {"weight_cotangents": i}
        assert sum(after.values()) - sum(before.values()) == 1
        assert "weight_cotangents" not in after


def _phase19_args(device, tol):
    """Phase 19's inputs (``chip_smoke.phase_sde_kernels``): the MNIST NSDE
    pair at 512 x 32 (drift 32 -> 64 -> 32, diffusion 32 -> 32), SOSRI2, at
    1.4e-1 (max_steps 128) or 1.4e-2 (256, 5 saves)."""
    gen = torch.Generator().manual_seed(21)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(device)
    B, D, H = 512, 32, 64
    leaves = [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1), rnd(D, H, scale=H ** -0.5),
              rnd(D, scale=0.1), rnd(D, D, scale=D ** -0.5), rnd(D, scale=0.1)]
    y0 = rnd(B, D, scale=0.5)
    S, sa = (128, None) if tol > 1e-1 else (256, [0.0, 0.25, 0.5, 0.75, 1.0])
    xi = sde_ops.presample_noise(torch.Generator(device=device).manual_seed(22), (B, D), S)
    t0, t1 = torch.tensor(0.0, device=device), torch.tensor(1.0, device=device)
    kw = dict(n_drift=2, solver="sosri2")
    if sa is not None:
        kw["saveat"], kw["ys_init"] = sde_ops.save_rows_at_start(
            torch.tensor(sa, device=device), t0, y0)
    return (t0, t1, torch.tensor(0.01, device=device), y0, leaves, tol, tol,
            PIController(beta1=0.5, beta2=0.0), S, *xi), kw


@pytest.mark.cuda
@pytest.mark.parametrize("pair,batch,tol,saves", [
    ("mlp", 512, 1.4e-2, True), ("mlp", 13, 1e-2, True), ("mlp", 7, 1e-2, False),
    ("cubic", 100, 3e-2, True), ("cubic", 13, 1e-2, False)])
def test_sde_bwd_matches_its_schedule(cuda, pair, batch, tol, saves):
    """K10 (the reverse tile body) against its order of sums in plain
    PyTorch on the card (``sw.plain_sde_bwd_tiles``): every output bitwise,
    seeded with the cotangents of y1, the saves and the telemetry, on the
    MLP pair (512 x 32 x 64: the compile-time instance; 13 and 7 rows of 5 x
    8: the generic one, ragged tiles) and the cubic pair."""
    S = 256
    if pair == "mlp":
        D, H = (32, 64) if batch == 512 else (5, 8)
        sa = [0.0, 0.25, 0.5, 0.75, 1.0] if saves else None
        args, kw = _sde_args(batch, D, H, cuda, tol, S, sa)
    else:
        D = 2
        args, kw = _cubic_args(batch, 50 if batch == 100 else 8, cuda, tol, S,
                               CUBIC_SAVES if saves else None)
    rk = sw.sde_whole_solve_fwd(*args, **kw)
    ns = int(rk.final[3:5].sum())
    g = torch.Generator().manual_seed(7)
    ct_y1 = torch.randn(batch, D, generator=g).to(cuda)
    ct_tel = (0.1 * torch.randn(4, S, generator=g)).to(cuda)
    ct_ys = torch.randn(rk.ys.shape[0], batch, D, generator=g).to(cuda) if saves else None
    t0, t1, _, _, leaves, _, _, ctrl = args[:8]
    bargs = (rk, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl, *args[9:])
    bkw = {k: v for k, v in kw.items() if k != "ys_init"}
    got = sw.sde_whole_solve_bwd(*bargs, ct_ys=ct_ys, **bkw)
    want = sw.plain_sde_bwd_tiles(*bargs, ct_ys=ct_ys, **bkw)
    for j, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), (j, (a - b).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1.4e-1, 1.4e-2])
def test_sde_fwd_rows_are_the_plain_versions(cuda, tol):
    """K9 at phase 19's inputs, every stored trial step teacher-forced: the
    plain trial step from K9's own start row, tail and scalars takes K9's
    decision, and its rows (the state after the step, the tail's rows) are
    K9's history bitwise (each affine map an f64 sum rounded once, each
    lincomb op by op, accurate tanhf); an element where they differ is named
    with its step and both values (an f64 sum within its rounding error of
    an f32 tie rounds either way). The three sums, reduced in another order
    than ``torch.sum``'s, within 1e-5; the solve takes the plain version's
    steps and save cursors."""
    from regneuralde_tpu_torch.ops.sri import get_tableau

    args, kw = _phase19_args(cuda, tol)
    rk = sw.sde_whole_solve_fwd(*args, **kw)
    rp = sw.plain_sde_whole_solve_fwd(*args, **kw)
    assert rk.final[3:].tolist() == rp.final[3:].tolist() and rk.final[5] == 1.0
    assert torch.equal(rk.cursors, rp.cursors)
    ns = int(rk.final[3:5].sum())
    t0, t1, _, _, leaves, rtol, atol, ctrl = args[:8]
    st = rk.streams
    for i in range(ns):
        o = sw.plain_sde_trial_step(get_tableau("sosri2"), ctrl, rtol, atol, st[sw.ST_T, i],
                                    st[sw.ST_DT, i], st[sw.ST_QOLD, i], st[sw.ST_H, i],
                                    rk.hy[i], rk.hw[i], rk.hz[i], args[9][i], args[10][i], t1,
                                    t1 - t0, leaves, 2)
        assert bool(o.accept) == bool(st[sw.ST_ACC, i] > 0.5), i
        for name, a, b in (("y", rk.hy[i + 1], o.y), ("tail_w", rk.hw[i + 1], o.tail.w),
                           ("tail_z", rk.hz[i + 1], o.tail.z)):
            bad = (a != b).nonzero()
            assert not bad.numel(), (i, name, bad[:4].tolist(), a[tuple(bad[0])].item(),
                                     b[tuple(bad[0])].item())
        for q, v in zip((sw.ST_E, sw.ST_N, sw.ST_D), o.sums):
            assert abs(st[q, i].item() - v.item()) <= 1e-5 * abs(v.item()), (i, q)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["sriw1", "sosri", "sosri2"])
@pytest.mark.parametrize("pair", ["nsde", "mlp", "cubic"])
def test_sde_whole_solve_takes_every_tableau(cuda, solver, pair):
    """K9/K10 on each SRI tableau (SRIW1's aliased and unused drift stages
    among them), on the compile-time instance (the NSDE widths) and the
    generic one: the plain version's steps, y1 and saves within 1e-5, K10
    within 3 times the plain walk's distance from a float64 walk plus 1e-5
    and bitwise its schedule."""
    S = 256
    if pair == "cubic":
        args, kw = _cubic_args(16, 8, cuda, 1e-2, S, [0.0, 0.5, 1.0])
    else:
        D, H = (32, 64) if pair == "nsde" else (6, 10)
        args, kw = _sde_args(64, D, H, cuda, 1e-2, S, [0.0, 0.5, 1.0])
    kw["solver"] = solver
    rk = sw.sde_whole_solve_fwd(*args, **kw)
    rp = sw.plain_sde_whole_solve_fwd(*args, **kw)
    assert rk.final[3:].tolist() == rp.final[3:].tolist() and rk.final[5] == 1.0
    assert torch.equal(rk.streams[sw.ST_ACC], rp.streams[sw.ST_ACC])
    assert _rel(rk.y1, rp.y1) <= 1e-5 and _rel(rk.ys, rp.ys) <= 1e-5
    ns = int(rk.final[3:5].sum())
    B, D = rk.y1.shape
    g = torch.Generator().manual_seed(7)
    ct_y1, ct_ys = torch.randn(B, D, generator=g).to(cuda), torch.randn(
        3, B, D, generator=g).to(cuda)
    ct_tel = (0.1 * torch.randn(4, S, generator=g)).to(cuda)
    t0, t1, _, _, leaves, _, _, ctrl = args[:8]
    bargs = (rk, ns, ct_y1, ct_tel, t0, t1, leaves, 1e-2, 1e-2, ctrl, *args[9:])
    bkw = {k: v for k, v in kw.items() if k != "ys_init"}
    gk = sw.sde_whole_solve_bwd(*bargs, ct_ys=ct_ys, **bkw)
    gp = sw.plain_sde_whole_solve_bwd(*bargs, ct_ys=ct_ys, **bkw)
    gs = sw.plain_sde_bwd_tiles(*bargs, ct_ys=ct_ys, **bkw)
    d = lambda x: x.double()
    g64 = sw.plain_sde_whole_solve_bwd(
        sw.SDERecord(*map(d, rk)), ns, d(ct_y1), d(ct_tel), d(t0), d(t1),
        [d(x) for x in leaves], 1e-2, 1e-2, ctrl, d(args[9]), d(args[10]), ct_ys=d(ct_ys),
        **dict(bkw, saveat=d(bkw["saveat"])))
    groups = lambda g: [torch.stack(g[:3]), *g[3:]]
    for a, b, c in zip(groups(gk), groups(gp), groups(g64)):
        if b.numel():
            assert _rel(a, c) <= 3 * _rel(b, c) + 1e-5
    assert all(torch.equal(a, b) for a, b in zip(gk, gs))


@pytest.mark.cuda
def test_sde_plan_is_the_librarys(cuda):
    """``sde_tile_plan``'s sizes are the library's (``check_sde_plan``) for
    the NSDE pair, the toy's cubic pair, a generic MLP pair, a deep one and
    one whose leaf cotangents outgrow the registers."""
    from regneuralde_tpu_torch.ops import _cuda

    lib = _cuda.library()
    cases = [(((32, 64, 32), (32, 32)), "mlp", True), (((2, 50, 2), (2, 2)), "cubic", True),
             (((32, 64, 32), (32, 32)), "cubic", False), (((2, 50, 2), (2, 2)), "mlp", False),
             (((5, 8, 5), (5, 5)), "mlp", False),
             (((4, 8, 8, 8, 4), (4, 6, 4)), "mlp", False),
             (((32, 256, 32), (32, 32)), "mlp", False)]
    for nets, body, inst in cases:
        widths = (len(nets[0]) - 1, len(nets[1]) - 1, *nets[0], *nets[1])
        plan = sw.check_sde_plan(lib, widths, body)
        assert plan == sw.sde_tile_plan(0, nets, body) and plan.fixed_instance == inst
