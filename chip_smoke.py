#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MNIST Neural-ODE and latent-ODE training
steps on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and ``nvcc``; the
kernels are built from ``regneuralde_tpu_torch/csrc`` into ``build/kernels/``
at first use. Phases (each checks its results; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), versions, kernel build;
2. K1 and K2 (the normed Tsit5 step kernels) against their plain PyTorch
   versions at B=512, D=784, H=100, at rtol=atol=1e-4 and 1.4e-8, with
   CUDA-event times of both;
3. one forward+backward of the training step at full width (rtol=atol=1e-5),
   step kernels (``fused="step"``) against the plain path (``fused=False``):
   identical NFE and accept sequence, relative gradient error <= 1e-3;
4. three training steps of the flagship configuration (Tsit5 at
   rtol=atol=1.4e-8, max_steps=96, batch 512, CE + 100 * error_estimate,
   InvDecay(1e-5) then Momentum(0.1, 0.9)) on ``fused="step"``, with the
   step kernels' launch counts;
5. the whole-solve kernels K3/K4 against their plain versions at
   512x784x100 on seeded random weights and inputs, with CUDA-event times
   of the forward solve and the backward walk;
6. phase 3 for the whole solve: ``fused=True`` against ``fused=False``;
7. phase 4 on ``fused=True``: one forward and one backward launch per step,
   no step-kernel launch;
8. K7 and K8 (the AlternatingMLP trial-step kernels) against their plain
   versions at B=256, D=20, H=50, depth 4, at rtol=atol=1e-4 and 1.4e-8,
   bitwise determinism, and CUDA-event times of both;
9. one forward+backward of the latent-ODE training step at full width
   (rtol=atol=1e-5), ``fused="step"`` against ``fused=False``: identical NFE
   and accept sequence, gradient bounds as in phase 3;
10. three training steps of the latent ODE of ``bench.py:139-210``
   (``LatentGRU(37, 40, 50)``, ``MLP((50, 40))``, ``AlternatingMLP(20, 50,
   4)``, ``Dense(37)``, batch 256, 49 ``saveat`` stamps, Tsit5 at
   rtol=atol=1.4e-8, max_steps=256, masked Gaussian log-likelihood + KL +
   1e3 * error_estimate, InvDecay(1e-5) then AdaMax(0.01)) on
   ``fused="step"``: one K7 and one K8 launch per trial step.

The last two lines of standard output are the kernels' JSON record and the
device record ``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

SEED = 0
BATCH, DIM, HIDDEN = 512, 784, 100
FLAGSHIP_TOL = 1.4e-8
MAX_STEPS = 96
LATENT_BATCH, LATENT_OBS, LATENT_DIM, LATENT_HIDDEN, LATENT_DEPTH = 256, 37, 20, 50, 4
LATENT_MAX_STEPS = 256
LATENT_SIGMA, LATENT_REG = 0.01, 1e3
FWD_BOUND, BWD_BOUND, GRAD_BOUND, REG_GRAD_BOUND = 1e-4, 1e-3, 1e-3, 5e-2
WS_CTRL_BOUND = 1e-5
REPS = 7  # timed runs per kernel (median), after two warm-up runs


def _check(ok, what):
    """A failed check ends the run with a non-zero exit (kept under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _rel(a, b):
    import torch

    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


def _time_ms(fn):
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def build_classifier(tol, fused, device, seed=SEED, max_steps=MAX_STEPS):
    import torch

    from regneuralde_tpu_torch.models import ClassifierNODE, MLPDynamics, NeuralODE

    gen = torch.Generator().manual_seed(seed)
    node = NeuralODE(MLPDynamics(DIM, HIDDEN, device=device, generator=gen),
                     tspan=(0.0, 1.0), rtol=tol, atol=tol,
                     max_steps=max_steps, fused=fused)
    return ClassifierNODE(None, node, torch.nn.LazyLinear(10, device=device)), gen


def mnist_loss(clf, x, y, reg_weight=100.0):
    """CE + reg_weight * error_estimate(mean), the regularized MNIST
    objective (reg_weight 100 in training)."""
    import torch

    from regneuralde_tpu_torch import reg

    out = clf(x)
    ce = -(y * torch.log_softmax(out.logits, dim=-1)).sum(-1).mean()
    return ce + reg_weight * reg.error_estimate(out.telemetry, "mean"), out


def synthetic_batches(n, device):
    import torch

    from regneuralde_tpu_torch.data import load_mnist

    train, _ = load_mnist(BATCH, flatten=True, seed=SEED)
    out = []
    for xb, yb in train:
        if xb.shape[0] == BATCH:
            out.append((torch.as_tensor(xb, device=device),
                        torch.as_tensor(yb, device=device)))
        if len(out) == n:
            return out
    raise AssertionError(f"the loader gave fewer than {n} full batches")


def phase_kernels(device):
    """K1/K2 against their plain versions on random inputs from a seed.

    Random k1 (not f(t, y)) keeps the embedded error far above float32
    rounding, so the three norm sums are compared, not rounding noise."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm

    gen = torch.Generator().manual_seed(SEED + 1)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    leaves = [rnd(HIDDEN, DIM + 1, scale=(DIM + 1) ** -0.5), rnd(HIDDEN, scale=0.1),
              rnd(DIM, HIDDEN + 1, scale=(HIDDEN + 1) ** -0.5), rnd(DIM, scale=0.1)]
    y, k1 = rnd(BATCH, DIM, scale=0.5), rnd(BATCH, DIM, scale=0.3)
    t = torch.tensor(0.07, device=device)
    dt = torch.tensor(0.11, device=device)
    cts = [rnd(BATCH, DIM), rnd(BATCH, DIM), torch.tensor(0.7, device=device),
           torch.tensor(1.3, device=device), torch.tensor(-0.4, device=device)]
    names_f = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]
    names_b = ["ct_t", "ct_dt", "ct_y", "ct_k1", "cW1", "cb1", "cW2", "cb2"]
    parts = fm._split_params(*leaves)
    for tol in (1e-4, FLAGSHIP_TOL):
        kf = fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)
        pf = fm._reference_normed_sweep(t, dt, y, k1, parts, tol, tol)
        kb = fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
        pb = fm._normed_bwd_math(t, dt, y, k1, parts, cts, tol, tol)
        torch.cuda.synchronize()
        errs_f = {n: _rel(a, b) for n, a, b in zip(names_f, kf, pf)}
        errs_b = {n: _rel(a, b) for n, a, b in zip(
            names_b, [*kb[:4], *kb[4]], [*pb[:4], *pb[4]])}
        print(f"[kernels] tol={tol:g} fwd rel err " + json.dumps(errs_f))
        print(f"[kernels] tol={tol:g} bwd rel err " + json.dumps(errs_b))
        for n, v in {**errs_f, **errs_b}.items():
            _check(v == v, f"{n}: NaN relative error at tol {tol}")
        _check(max(errs_f.values()) <= FWD_BOUND, f"K1 at tol {tol}: {errs_f}")
        _check(max(errs_b.values()) <= BWD_BOUND, f"K2 at tol {tol}: {errs_b}")

    # max_abs_err of the record, at the flagship tolerance: K1 over its row
    # outputs (y_new, k7); K2 with only the row cotangents seeded (the norm
    # sums' cotangents scale every output by 1/atol, which leaves an
    # absolute error without meaning).
    tol = FLAGSHIP_TOL
    kf = fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)
    pf = fm._reference_normed_sweep(t, dt, y, k1, parts, tol, tol)
    row_cts = [cts[0], cts[1], *(torch.zeros((), device=device) for _ in range(3))]
    kb = fm.normed_sweep_bwd(t, dt, y, k1, leaves, row_cts, tol, tol)
    pb = fm._normed_bwd_math(t, dt, y, k1, parts, row_cts, tol, tol)
    torch.cuda.synchronize()
    abs_f = max((a - b).abs().max().item() for a, b in zip(kf[:2], pf[:2]))
    abs_b = max((a - b).abs().max().item()
                for a, b in zip([*kb[:4], *kb[4]], [*pb[:4], *pb[4]]))
    errs_rows = {n: _rel(a, b) for n, a, b in zip(
        names_b, [*kb[:4], *kb[4]], [*pb[:4], *pb[4]])}
    print(f"[kernels] tol={tol:g} bwd rel err, row cotangents only "
          + json.dumps(errs_rows))
    print(f"[kernels] max abs err: fwd (y_new, k7) {abs_f!r}, "
          f"bwd (row cotangents) {abs_b!r}")
    _check(max(errs_rows.values()) <= BWD_BOUND, f"K2 row cotangents: {errs_rows}")

    times = {
        "fwd_kernel": _time_ms(lambda: fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)),
        "fwd_plain": _time_ms(lambda: fm._reference_normed_sweep(t, dt, y, k1, parts, tol, tol)),
        "bwd_kernel": _time_ms(lambda: fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)),
        "bwd_plain": _time_ms(lambda: fm._normed_bwd_math(t, dt, y, k1, parts, cts, tol, tol)),
    }
    print("[kernels] median ms over %d runs at %dx%dx%d: %s"
          % (REPS, BATCH, DIM, HIDDEN, json.dumps(times)))
    return {
        "normed_tsit5_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_mlp.py:1290",
            max_abs_err=abs_f, ms=times["fwd_kernel"],
            plain_ms=times["fwd_plain"]),
        "normed_tsit5_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_mlp.py:1334",
            max_abs_err=abs_b, ms=times["bwd_kernel"],
            plain_ms=times["bwd_plain"]),
    }


def _teacher_forced_steps(rec, ns, args, parts):
    """Holds each trial step of K3's record against the plain versions on
    the record's own inputs (its stored t, dt, y, f0 rows): the norm sums
    and the y_new/k7 rows against K1's plain version in float32 and in
    float64, and the stored controller updates (the next step's t, dt,
    qold; the telemetry; the accept flag) against ``ode._post`` on the
    stored sums. Returns, per quantity, the worst relative errors
    (kernel vs plain, kernel vs float64, plain vs float64); None where
    there is no float64 side."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws

    t0, t1, _, _, _, _, rtol, atol, ctrl, _ = args
    st = rec.streams
    tdir, span = torch.sign(t1 - t0), torch.abs(t1 - t0)
    count = float(rec.y1.numel())
    parts64 = [x.double() for x in parts]
    worst = {}

    def note(name, k_p, k_64=0.0, p_64=None):
        old = worst.get(name, (0.0, 0.0, None if p_64 is None else 0.0))
        worst[name] = (max(old[0], k_p), max(old[1], k_64),
                       None if p_64 is None else max(old[2], p_64))

    for i in range(ns):
        t, dt, qold, e, n, d = st[:ws.ST_ACC, i]
        remaining = t1 - t
        is_last = (dt - remaining) * tdir >= 0
        dt_eff = torch.where(is_last, remaining, dt)
        p32 = fm._reference_normed_sweep(t, dt_eff, rec.hy[i], rec.hf[i], parts, rtol, atol)
        p64 = fm._reference_normed_sweep(t.double(), dt_eff.double(), rec.hy[i].double(),
                                         rec.hf[i].double(), parts64, rtol, atol)
        for name, k, a, b in zip(["err_ssq", "num_ssq", "den_ssq"], (e, n, d),
                                 p32[2:], p64[2:]):
            note(name, _rel(k, a), _rel(k, b), _rel(a, b))
        acc = bool(st[ws.ST_ACC, i] > 0.5)
        if acc:  # an accepted step's y_new, k7 start the next step
            note("y_new", _rel(rec.hy[i + 1], p32[0]), _rel(rec.hy[i + 1], p64[0]),
                 _rel(p32[0], p64[0]))
            if i + 1 < ns:  # hf[ns] is not part of the record
                note("k7", _rel(rec.hf[i + 1], p32[1]), _rel(rec.hf[i + 1], p64[1]),
                     _rel(p32[1], p64[1]))
        post = ode._post(ctrl, count, t, dt_eff, qold, e, n, d, t1, span, is_last)
        _check(acc == bool(post[4] <= 1.0), f"K3 step {i}: accept flag")
        for name, j, want in (("tel_t_end", ws.TEL_T, post[3]), ("tel_dt", ws.TEL_DT, dt_eff),
                              ("tel_eest", ws.TEL_EEST, post[4]),
                              ("tel_eigen", ws.TEL_EIGEN, post[5])):
            note(name, _rel(st[j, i], want))
        if i + 1 < ns:
            for name, j, want in (("t_next", ws.ST_T, post[0]), ("dt_next", ws.ST_DT, post[1]),
                                  ("qold_next", ws.ST_QOLD, post[2])):
                note(name, _rel(st[j, i + 1], want))
    return worst


def phase_whole_solve_kernels(device):
    """K3/K4 against their plain versions on seeded random weights and
    inputs, at rtol=atol=1e-4. The forward against the plain solve: the
    same step counts and accept sequence, y1 within FWD_BOUND. The first
    steps' embedded error sits near its float32 rounding floor, so the two
    solves' step sizes drift apart by about 1% (measured on the H100); each
    stored trial step is therefore also held against the plain versions on
    its own stored inputs (``_teacher_forced_steps``): the norm sums and
    rows within 3 times the float32 plain version's distance from float64,
    plus 1e-6, and the controller within WS_CTRL_BOUND (powf against
    ATen's pow).

    K4, its float32 plain version and a float64 plain walk run over the
    same record (K3's). Seeded with a random cotangent of y1, K4 agrees
    with its plain version within BWD_BOUND on the well-conditioned
    outputs (the time scalars as one vector, ct_y0 and the weights).
    Seeded with random telemetry cotangents too, the seeds pass through
    1/(atol + |y| rtol) and the error estimate's rounding floor, so
    float32 itself drifts from float64: every output of K4 is held to 3
    times the float32 plain version's distance from float64, plus 1e-5.
    Times at the flagship tolerance."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    gen = torch.Generator().manual_seed(SEED + 2)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    leaves = [rnd(HIDDEN, DIM + 1, scale=(DIM + 1) ** -0.5), rnd(HIDDEN, scale=0.1),
              rnd(DIM, HIDDEN + 1, scale=(HIDDEN + 1) ** -0.5), rnd(DIM, scale=0.1)]
    y0 = torch.rand(BATCH, DIM, generator=gen).to(device)
    parts = fm._split_params(*leaves)
    ctrl = PIController.for_order(5)
    func = lambda t, y, _: fm._mlp_k(y, t, parts)[0]

    def inputs(tol):
        t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, (), tol, tol)
        return t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl, MAX_STEPS

    args = inputs(1e-4)
    rk = ws.whole_solve_fwd(*args)
    rp = ws.plain_whole_solve_fwd(*args)
    torch.cuda.synchronize()
    counts_k, counts_p = rk.final[3:].tolist(), rp.final[3:].tolist()
    ns = int(counts_k[0] + counts_k[1])
    print(f"[whole] tol=1e-4 (naccept, nreject, done) kernel={counts_k} plain={counts_p}")
    _check(counts_k == counts_p, "K3: the same step counts as its plain version")
    _check(counts_k[2] == 1.0, "K3: the solve reached t1")
    _check(torch.equal(rk.streams[ws.ST_ACC], rp.streams[ws.ST_ACC]),
           "K3: the same accept sequence")
    names = ["t", "dt", "qold", "err_ssq", "num_ssq", "den_ssq", "accepted",
             "tel_t", "tel_dt", "tel_eest", "tel_eigen"]
    drift = {n: _rel(rk.streams[j, :ns], rp.streams[j, :ns]) for j, n in enumerate(names)}
    print(f"[whole] K3 y1 rel err {_rel(rk.y1, rp.y1)!r}; free-running record against "
          "the plain solve's (rounding drift, not checked) " + json.dumps(drift))
    _check(_rel(rk.y1, rp.y1) <= FWD_BOUND, "K3 y1")
    errs = _teacher_forced_steps(rk, ns, args, parts)
    print("[whole] K3 per trial step, on its own stored inputs: rel err (kernel vs "
          "plain, kernel vs float64, plain vs float64), worst over the steps "
          + json.dumps(errs))
    for n, (k_p, k_64, p_64) in errs.items():
        _check(k_p == k_p and k_64 == k_64, f"K3 {n}: no NaN")
        if p_64 is None:  # the controller: the same formula in float32
            _check(k_p <= WS_CTRL_BOUND, f"K3 {n}: {errs[n]}")
        else:
            _check(k_64 <= 3 * p_64 + 1e-6, f"K3 {n}: {errs[n]}")
    abs_f = (rk.y1 - rp.y1).abs().max().item()

    t0, t1 = args[0], args[1]
    ct_y1 = rnd(BATCH, DIM)
    ct_tel = rnd(4, MAX_STEPS, scale=0.1).contiguous()
    groups = ["ct_t0|ct_t1|ct_dt0", "ct_y0", "ct_f0", "cW1", "cb1", "cW2", "cb2"]
    as_groups = lambda g: [torch.stack(g[:3]), *g[3:]]
    d = lambda x: x.double()
    rec64 = ws.SolveRecord(*map(d, rk))
    for seeds in ("y1", "y1+telemetry"):
        tel = ct_tel if seeds == "y1+telemetry" else torch.zeros_like(ct_tel)
        gk = ws.whole_solve_bwd(rk, ns, ct_y1, tel, t0, t1, leaves, 1e-4, 1e-4, ctrl)
        gp = ws.plain_whole_solve_bwd(rk, ns, ct_y1, tel, t0, t1, leaves, 1e-4, 1e-4,
                                      ctrl)
        g64 = ws.plain_whole_solve_bwd(rec64, ns, d(ct_y1), d(tel), d(t0), d(t1),
                                       [d(x) for x in leaves], 1e-4, 1e-4, ctrl)
        torch.cuda.synchronize()
        errs = {n: (_rel(a, b), _rel(a, c), _rel(b, c)) for n, a, b, c in zip(
            groups, *map(as_groups, (gk, gp, g64)))}
        print(f"[whole] K4 cotangents of {seeds}: rel err (kernel vs plain, kernel vs "
              f"float64, plain vs float64) " + json.dumps(errs))
        for n, (k_p, k_64, p_64) in errs.items():
            _check(k_p == k_p and k_64 == k_64, f"K4 {n}: no NaN")
            _check(k_64 <= 3 * p_64 + 1e-5, f"K4 {n}: {errs[n]}")
            if seeds == "y1" and n != "ct_f0":
                _check(k_p <= BWD_BOUND, f"K4 {n}: {errs[n]}")
        if seeds == "y1":
            abs_b = max((a - b).abs().max().item() for a, b in zip(gk[3:], gp[3:]))
    again = ws.whole_solve_bwd(rk, ns, ct_y1, ct_tel, t0, t1, leaves, 1e-4, 1e-4, ctrl)
    first = ws.whole_solve_bwd(rk, ns, ct_y1, ct_tel, t0, t1, leaves, 1e-4, 1e-4, ctrl)
    rk2 = ws.whole_solve_fwd(*args)
    _check(all(torch.equal(a, b) for a, b in zip(again, first)), "K4 is deterministic")
    _check(torch.equal(rk.streams, rk2.streams) and torch.equal(rk.y1, rk2.y1),
           "K3 is deterministic")
    print(f"[whole] max abs err: K3 y1 {abs_f!r}, K4 (cotangent of y1 only) {abs_b!r}")

    args = inputs(FLAGSHIP_TOL)
    rec = ws.whole_solve_fwd(*args)
    ns = int(rec.final[3:5].sum().item())
    t0, t1 = args[0], args[1]
    bwd_args = (ns, ct_y1, ct_tel, t0, t1, leaves, FLAGSHIP_TOL, FLAGSHIP_TOL, ctrl)
    times = {
        "fwd_kernel": _time_ms(lambda: ws.whole_solve_fwd(*args)),
        "fwd_plain": _time_ms(lambda: ws.plain_whole_solve_fwd(*args)),
        "bwd_kernel": _time_ms(lambda: ws.whole_solve_bwd(rec, *bwd_args)),
        "bwd_plain": _time_ms(lambda: ws.plain_whole_solve_bwd(rec, *bwd_args)),
    }
    print("[whole] median ms over %d runs at %dx%dx%d, tol %g, %d trial steps: %s"
          % (REPS, BATCH, DIM, HIDDEN, FLAGSHIP_TOL, ns, json.dumps(times)))
    return {
        "whole_solve_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_solve.py:357",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"]),
        "whole_solve_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_solve.py:559",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"]),
    }


def phase_kernel_vs_plain_step(device, batch, fused):
    """One forward+backward of the training step: kernels against plain.

    The cross-entropy gradient is held to GRAD_BOUND. The full gradient adds
    100 * error_estimate, whose gradient at rtol=atol=1e-5 in float32 is
    dominated by the rounding noise of the embedded error estimate: a change
    of summation order alone moves it by about 1.5e-2 (relative), so it is
    held to REG_GRAD_BOUND."""
    import torch

    x, y = batch
    tol = 1e-5
    kern, gen = build_classifier(tol, fused, device)
    kern.init(x, generator=gen)
    plain, _ = build_classifier(tol, False, device)
    plain.init(x)
    plain.load_state_dict(kern.state_dict())
    results = {}
    for name, clf in (("kernel", kern), ("plain", plain)):
        for reg_weight in (0.0, 100.0):
            clf.zero_grad(set_to_none=True)
            loss, out = mnist_loss(clf, x, y, reg_weight)
            loss.backward()
            torch.cuda.synchronize()
            tel = out.telemetry
            results[name, reg_weight] = dict(
                loss=loss.item(), nfe=out.nfe, success=out.success,
                accepted=tel.accepted[tel.live].tolist(),
                grad=torch.cat([p.grad.flatten() for p in clf.parameters()]),
                logits=out.logits.detach())
    for reg_weight, bound in ((0.0, GRAD_BOUND), (100.0, REG_GRAD_BOUND)):
        k, p = results["kernel", reg_weight], results["plain", reg_weight]
        g_err = _rel(k["grad"], p["grad"])
        print(f"[step] fused={fused!r} rtol=atol={tol:g} reg_weight={reg_weight:g} "
              f"nfe kernel={k['nfe']} plain={p['nfe']} "
              f"loss kernel={k['loss']!r} plain={p['loss']!r} "
              f"logits rel err={_rel(k['logits'], p['logits']):.3e} "
              f"grad rel err={g_err:.3e} (bound {bound:g})")
        _check(k["success"] and p["success"], "both solves reached t1")
        _check(k["nfe"] == p["nfe"], f"NFE kernel {k['nfe']} plain {p['nfe']}")
        _check(k["accepted"] == p["accepted"], "same accept sequence")
        _check(tuple(k["logits"].shape) == (BATCH, 10), "logits shape")
        _check(torch.isfinite(k["grad"]).all().item(), "finite gradients")
        _check(g_err <= bound, f"gradient rel err {g_err} > {bound}")


def phase_slice(device, batches, fused):
    """Three training steps of the flagship configuration on ``fused``.
    Returns the launch counts of the four kernels in those steps: each
    step kernel once per trial step on ``"step"``; each whole-solve
    kernel once per training step on ``True``, and no step kernel."""
    import torch

    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        mnist_node_optimizer,
    )

    clf, gen = build_classifier(FLAGSHIP_TOL, fused, device)
    clf.init(batches[0][0], generator=gen)
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(lambda m, x, y: mnist_loss(m, x, y), optimizer)
    before = [p.detach().clone() for p in clf.parameters()]

    torch.cuda.synchronize()
    for mod in (fg, fm, ws):  # count only this path's launches
        mod.reset_launches()
    launches = {**fm.LAUNCHES, **ws.LAUNCHES, **fg.LAUNCHES}
    trial_steps = 0
    for i, (x, y) in enumerate(batches):
        start = time.perf_counter()
        state, loss, out = step(state, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        sol = out.telemetry
        naccept = int(sol.accepted.sum().item())
        nlive = int(sol.live.sum().item())
        trial_steps += nlive
        launches = {**fm.LAUNCHES, **ws.LAUNCHES, **fg.LAUNCHES}
        print(f"[slice] fused={fused!r} step {i}: loss={loss.item()!r} nfe={out.nfe} "
              f"naccept={naccept} nreject={nlive - naccept} "
              f"success={out.success} wall_s={wall!r} "
              f"launches={json.dumps(launches)}")
        _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
        _check(out.success, "the solve reached t1")
        _check(out.nfe == 2 + 6 * nlive, "NFE = 2 + 6 * trial steps")
        _check(torch.isfinite(out.logits).all().item(), "finite logits")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(clf.parameters(), before))
    print(f"[slice] fused={fused!r} trial steps={trial_steps} "
          f"launches={json.dumps(launches)} max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    none = dict(altmlp_tsit5_fwd=0, altmlp_tsit5_bwd=0)
    per_step = {"step": dict(normed_tsit5_fwd=trial_steps, normed_tsit5_bwd=trial_steps,
                             whole_solve_fwd=0, whole_solve_bwd=0, **none),
                True: dict(normed_tsit5_fwd=0, normed_tsit5_bwd=0,
                           whole_solve_fwd=len(batches), whole_solve_bwd=len(batches),
                           **none)}
    _check(launches == per_step[fused],
           f"fused={fused!r}: launches {launches}, expected {per_step[fused]}")
    return launches


# ---------------------------------------------------------------------------
# The latent ODE (phases 8-10).
# ---------------------------------------------------------------------------


def build_latent(tol, fused, device, saveat, seed=SEED):
    """The latent ODE of ``bench.py:139-210`` at full width, weights from
    ``torch.Generator(seed)``; the decoder is sized by ``init``."""
    import torch

    from regneuralde_tpu_torch.models import (
        MLP,
        AlternatingMLP,
        LatentGRU,
        LatentTimeSeriesModel,
        NeuralODE,
    )

    gen = torch.Generator().manual_seed(seed)
    node = NeuralODE(AlternatingMLP(LATENT_DIM, LATENT_HIDDEN, LATENT_DEPTH, device=device,
                                    generator=gen),
                     time_dep=False, rtol=tol, atol=tol, max_steps=LATENT_MAX_STEPS,
                     saveat=saveat, fused=fused)
    model = LatentTimeSeriesModel(
        rnn=LatentGRU(LATENT_OBS, 40, 50, device=device, generator=gen),
        enc=MLP(100, (50, 2 * LATENT_DIM), device=device, generator=gen), node=node,
        dec=torch.nn.LazyLinear(LATENT_OBS, device=device))
    return model, gen


def latent_inputs(d, m, tp):
    """``[data, mask, delta_t]`` per stamp, as ``bench.py`` builds it."""
    import torch

    dt = torch.cat([tp[:, 1:] - tp[:, :-1], torch.zeros_like(tp[:, :1])], 1)
    return torch.cat([d, m, dt[..., None]], dim=-1)


def latent_loss(model, d, m, tp, eps, reg_weight=LATENT_REG):
    """``bench.py:186-194``: the masked Gaussian log-likelihood (sigma 0.01)
    and KL, plus reg_weight * error_estimate(mean)."""
    import torch

    from regneuralde_tpu_torch import reg

    out = model(latent_inputs(d, m, tp), eps=eps)
    err = (out.result - d) * m
    ll = torch.sum(-torch.square(err) / (2 * LATENT_SIGMA ** 2), dim=(1, 2))
    ll = ll / torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
    kl = torch.mean(torch.exp(out.logvar) + torch.square(out.mu0) - 1 - out.logvar,
                    dim=-1) / 2
    return -torch.mean(ll - kl) + reg_weight * reg.error_estimate(out.telemetry, "mean"), out


def latent_batches(n, device):
    """``n`` full batches ``(d, m, tp, eps)`` of the physionet surrogate
    (``load_physionet`` without data files), the reparameterization noise
    drawn from a seeded generator; and the saveat grid of ``bench.py``, the
    sorted stamps of the first batch."""
    import torch

    from regneuralde_tpu_torch.data import load_physionet

    train, _ = load_physionet(LATENT_BATCH, seed=SEED)
    gen = torch.Generator().manual_seed(SEED + 9)
    out = []
    for b in train:
        d, m, tp = (torch.as_tensor(b[i], device=device) for i in (0, 1, 4))
        eps = torch.randn(LATENT_BATCH, LATENT_DIM, generator=gen).to(device)
        out.append((d, m, tp, eps))
        if len(out) == n:
            return out, torch.sort(out[0][2][0]).values
    raise AssertionError(f"the loader gave fewer than {n} full batches")


def phase_altmlp_kernels(device):
    """K7/K8 against their plain versions on seeded random inputs at the
    latent shape (random k1 keeps the embedded error far above float32
    rounding), at rtol=atol=1e-4 and 1.4e-8; bitwise determinism; times."""
    import torch

    from regneuralde_tpu_torch.ops import fused_generic as fg

    gen = torch.Generator().manual_seed(SEED + 3)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    B, D, H = LATENT_BATCH, LATENT_DIM, LATENT_HIDDEN
    leaves = []
    for _ in range(LATENT_DEPTH):
        leaves += [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1),
                   rnd(D, H, scale=H ** -0.5), rnd(D, scale=0.1)]
    y, k1 = rnd(B, D, scale=0.5), rnd(B, D, scale=0.3)
    t = torch.tensor(0.07, device=device)
    dt = torch.tensor(0.11, device=device)
    cts = [rnd(B, D), rnd(B, D), torch.tensor(0.7, device=device),
           torch.tensor(1.3, device=device), torch.tensor(-0.4, device=device)]
    names_f = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]
    names_b = ["ct_dt", "ct_y", "ct_k1"] + [f"c_leaf{j}" for j in range(len(leaves))]
    flat_b = lambda g: [*g[1:4], *g[4]]
    for tol in (1e-4, FLAGSHIP_TOL):
        kf = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
        pf = fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
        kb = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
        pb = fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, tol, tol)
        torch.cuda.synchronize()
        errs_f = {n: _rel(a, b) for n, a, b in zip(names_f, kf, pf)}
        errs_b = {n: _rel(a, b) for n, a, b in zip(names_b, flat_b(kb), flat_b(pb))}
        print(f"[altmlp] tol={tol:g} K7 rel err " + json.dumps(errs_f))
        print(f"[altmlp] tol={tol:g} K8 rel err " + json.dumps(errs_b))
        for n, v in {**errs_f, **errs_b}.items():
            _check(v == v, f"{n}: NaN relative error at tol {tol}")
        _check(max(errs_f.values()) <= FWD_BOUND, f"K7 at tol {tol}: {errs_f}")
        _check(max(errs_b.values()) <= BWD_BOUND, f"K8 at tol {tol}: {errs_b}")
        _check(kb[0].item() == 0.0, "K8: ct_t is exactly zero")

    tol = FLAGSHIP_TOL
    again_f = fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    again_b = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    _check(all(torch.equal(a, b) for a, b in zip(kf, again_f)), "K7 is deterministic")
    _check(all(torch.equal(a, b) for a, b in zip(flat_b(kb), flat_b(again_b))),
           "K8 is deterministic")
    # max_abs_err of the record: K7 over its row outputs, K8 with only the
    # row cotangents seeded (as phase 2)
    row_cts = [cts[0], cts[1], *(torch.zeros((), device=device) for _ in range(3))]
    kb = fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, row_cts, tol, tol)
    pb = fg._altmlp_bwd_math(t, dt, y, k1, leaves, row_cts, tol, tol)
    torch.cuda.synchronize()
    abs_f = max((a - b).abs().max().item() for a, b in zip(kf[:2], pf[:2]))
    abs_b = max((a - b).abs().max().item() for a, b in zip(flat_b(kb), flat_b(pb)))
    print(f"[altmlp] max abs err: K7 (y_new, k7) {abs_f!r}, K8 (row cotangents) {abs_b!r}")

    times = {
        "fwd_kernel": _time_ms(lambda: fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)),
        "fwd_plain": _time_ms(lambda: fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves,
                                                                   tol, tol)),
        "bwd_kernel": _time_ms(lambda: fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts,
                                                                  tol, tol)),
        "bwd_plain": _time_ms(lambda: fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, tol,
                                                          tol)),
    }
    print("[altmlp] median ms over %d runs at %dx%dx%dx%d: %s"
          % (REPS, B, D, H, LATENT_DEPTH, json.dumps(times)))
    return {
        "altmlp_tsit5_fwd": dict(
            replaces="regneuralde_tpu/ops/pallas_generic.py:208",
            max_abs_err=abs_f, ms=times["fwd_kernel"], plain_ms=times["fwd_plain"]),
        "altmlp_tsit5_bwd": dict(
            replaces="regneuralde_tpu/ops/pallas_generic.py:278",
            max_abs_err=abs_b, ms=times["bwd_kernel"], plain_ms=times["bwd_plain"]),
    }


def phase_latent_kernel_vs_plain_step(device, batch, saveat):
    """One forward+backward of the latent training step at rtol=atol=1e-5:
    K7/K8 (``fused="step"``) against their plain versions (``fused=False``)
    on the same weights and noise. The loss without the regularizer is held
    to GRAD_BOUND; with 1e3 * error_estimate, whose gradient sits at the
    error estimate's float32 rounding floor, to REG_GRAD_BOUND (phase 3's
    bounds)."""
    import torch

    d, m, tp, eps = batch
    tol = 1e-5
    x = latent_inputs(d, m, tp)
    kern, gen = build_latent(tol, "step", device, saveat)
    kern.init(x, generator=gen)
    plain, _ = build_latent(tol, False, device, saveat)
    plain.init(x)
    plain.load_state_dict(kern.state_dict())
    results = {}
    for name, model in (("kernel", kern), ("plain", plain)):
        for reg_weight in (0.0, LATENT_REG):
            model.zero_grad(set_to_none=True)
            loss, out = latent_loss(model, d, m, tp, eps, reg_weight)
            loss.backward()
            torch.cuda.synchronize()
            tel = out.telemetry
            results[name, reg_weight] = dict(
                loss=loss.item(), nfe=out.nfe, success=out.success,
                accepted=tel.accepted[tel.live].tolist(),
                grad=torch.cat([p.grad.flatten() for p in model.parameters()]),
                result=out.result.detach())
    for reg_weight, bound in ((0.0, GRAD_BOUND), (LATENT_REG, REG_GRAD_BOUND)):
        k, p = results["kernel", reg_weight], results["plain", reg_weight]
        g_err = _rel(k["grad"], p["grad"])
        print(f"[latent-step] rtol=atol={tol:g} reg_weight={reg_weight:g} "
              f"nfe kernel={k['nfe']} plain={p['nfe']} "
              f"loss kernel={k['loss']!r} plain={p['loss']!r} "
              f"result rel err={_rel(k['result'], p['result']):.3e} "
              f"grad rel err={g_err:.3e} (bound {bound:g})")
        _check(k["success"] and p["success"], "both solves reached t1")
        _check(k["nfe"] == p["nfe"], f"NFE kernel {k['nfe']} plain {p['nfe']}")
        _check(k["accepted"] == p["accepted"], "same accept sequence")
        _check(tuple(k["result"].shape) == (LATENT_BATCH, saveat.shape[0], LATENT_OBS),
               "result shape")
        _check(torch.isfinite(k["grad"]).all().item(), "finite gradients")
        _check(g_err <= bound, f"gradient rel err {g_err} > {bound}")


def phase_latent_slice(device, batches, saveat):
    """Three training steps of the latent ODE at full width on
    ``fused="step"``. Returns the launch counts of that run: K7 and K8
    once per trial step, no other kernel."""
    import torch

    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.training import (
        create_train_state,
        latent_ode_optimizer,
        make_train_step,
    )

    model, gen = build_latent(FLAGSHIP_TOL, "step", device, saveat)
    model.init(latent_inputs(*batches[0][:3]), generator=gen)
    optimizer = latent_ode_optimizer()
    state = create_train_state(model, optimizer)
    step = make_train_step(latent_loss, optimizer)
    before = [p.detach().clone() for p in model.parameters()]

    torch.cuda.synchronize()
    counters = (fg, fm, ws)
    for mod in counters:  # count only this path's launches
        mod.reset_launches()
    trial_steps = 0
    for i, batch in enumerate(batches):
        start = time.perf_counter()
        state, loss, out = step(state, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        tel = out.telemetry
        naccept = int(tel.accepted.sum().item())
        nlive = int(tel.live.sum().item())
        trial_steps += nlive
        launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items()}
        print(f"[latent] step {i}: loss={loss.item()!r} nfe={out.nfe} "
              f"naccept={naccept} nreject={nlive - naccept} success={out.success} "
              f"wall_s={wall!r} launches={json.dumps(launches)}")
        _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
        _check(out.success, f"the solve reached t1 within {LATENT_MAX_STEPS} trial steps")
        _check(out.nfe == 2 + 6 * nlive, "NFE = 2 + 6 * trial steps")
        _check(tuple(out.result.shape) == (LATENT_BATCH, saveat.shape[0], LATENT_OBS),
               "result shape")
        _check(torch.isfinite(out.result).all().item(), "finite result")
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(model.parameters(), before))
    print(f"[latent] trial steps={trial_steps} launches={json.dumps(launches)} "
          f"max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    want = dict(altmlp_tsit5_fwd=trial_steps, altmlp_tsit5_bwd=trial_steps,
                normed_tsit5_fwd=0, normed_tsit5_bwd=0, whole_solve_fwd=0,
                whole_solve_bwd=0)
    _check(launches == want, f"latent launches {launches}, expected {want}")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from regneuralde_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    device = torch.device("cuda", 0)
    start = time.perf_counter()
    _cuda.library()
    print(f"[build] kernels ready in {time.perf_counter() - start:.1f} s "
          f"(nvcc {_cuda.build_seconds!r} s)")
    for line in _cuda.ptxas_report().splitlines():
        print(f"[build] {line}")

    batches = synthetic_batches(3, device)
    kernels = phase_kernels(device)
    phase_kernel_vs_plain_step(device, batches[0], "step")
    launches = phase_slice(device, batches, "step")
    kernels.update(phase_whole_solve_kernels(device))
    phase_kernel_vs_plain_step(device, batches[0], True)
    whole = phase_slice(device, batches, True)
    launches.update({k: whole[k] for k in ("whole_solve_fwd", "whole_solve_bwd")})

    kernels.update(phase_altmlp_kernels(device))
    lbatches, saveat = latent_batches(3, device)
    phase_latent_kernel_vs_plain_step(device, lbatches[0], saveat)
    latent = phase_latent_slice(device, lbatches, saveat)
    launches.update({k: latent[k] for k in ("altmlp_tsit5_fwd", "altmlp_tsit5_bwd")})

    sources = {"normed_tsit5_fwd": "normed_tsit5.cu", "normed_tsit5_bwd": "normed_tsit5.cu",
               "whole_solve_fwd": "whole_solve.cu", "whole_solve_bwd": "whole_solve.cu",
               "altmlp_tsit5_fwd": "altmlp_tsit5.cu", "altmlp_tsit5_bwd": "altmlp_tsit5.cu"}
    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "regneuralde_tpu_torch/csrc/" + sources[name],
         "replaces": info["replaces"], "launches": launches[name],
         "max_abs_err": info["max_abs_err"], "ms": info["ms"],
         "plain_ms": info["plain_ms"]}
        for name, info in kernels.items()]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
