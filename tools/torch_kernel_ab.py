#!/usr/bin/env python3
"""Time the port's step and whole-solve kernels in two source trees on one
GPU, in the order A, B, B, A (``--rounds`` times), one process each.

    python3 tools/torch_kernel_ab.py --a DIR [--b .] [--phases altmlp,csl] [--rounds N]

``DIR`` is an unpacked checkout of another commit (for example ``git
archive <commit> | tar -x -C build/parent``). Each run imports that tree's
``chip_smoke.py``, builds its kernels into the tree's own ``build/``, runs
the named phases' kernel checks (``altmlp``: K7/K8 and K3/K4 for
AlternatingMLP, with K8's and K7's device time under ``torch.profiler`` at
phase 8's inputs (each kernel and its slot sum apart) and K4's and K3's
over phase 11's solves (by tolerance and trial steps), and a hash of each
one's outputs on fixed inputs (K4's over the plain forward's record), so
that equal hashes in the two trees say the same bits, ``csl``: K7/K8-CSL
and K3/K4-CSL, with K8-CSL's device time under ``torch.profiler`` at phase 15's inputs (its kernel and its slot
sum apart) and K4-CSL's over phase 16's solves (by tolerance), and K7-CSL's
and K3-CSL's likewise, ``mlp``: K1/K2 and K3/K4
for MLPDynamics, with K1's and K2's device time under ``torch.profiler`` at
phase 2's inputs, K2's kernels and its contraction apart, whichever kernels
the tree has for them, ``sde``: K9/K10 for the MLP pair, with their
device time under ``torch.profiler`` over phase 19's solves (K10's kernel
and its slot sum apart, by tolerance and trial steps) and hashes of their
outputs, ``sdecubic``: the same for the cubic pair over phase 29's solves,
``lanes``: K11/K12,
and their device time under ``torch.profiler`` at phase 22's inputs, K12's
kernels and its contraction apart, whichever kernels the tree has for them,
``tuple``: K13/K14, and their device time under ``torch.profiler`` at
phase 25's inputs, K13's kernel, K14's kernels and its contraction apart,
whichever kernels the tree has for them; a phase the tree lacks is skipped;
``wcot``: the device time, under ``torch.profiler``, of the
weight-cotangent contraction inside K2 at 512x784x100 (K = 3072 rows) and
inside K4<MlpDyn> over the flagship's whole solve at 1.4e-8 (K = 6 * 512 *
its trial steps), whichever kernels the tree has for it, and of that
call's walk, on the stage residuals' stream and replaying them; ``k3``: K3 for MLPDynamics alone over that solve, CUDA-event
and device ms, whichever kernel the tree has for it; ``fwd``: the device
ms a launch of K3 for
AlternatingMLP and for CSL over their whole-solve phases) and prints, per
kernel, the median of ``chip_smoke``'s CUDA-event times and what ``ptxas``
reported for it (registers, stack, spills). Last it says, for every kernel
of either library, whether the two trees' SASS (``cuobjdump -sass``) is
the same instruction for instruction; a kernel of one tree only is named
beside the kernel of the other tree whose SASS it equals, if any (a kernel
renamed, or made an instance of a template). Two compiles of one source
can give different SASS for ``whole_solve.cu``'s 255-register kernels
(``ptxas`` is not deterministic there, more so in a loaded build), so a
``differs`` is evidence of a change only when two compiles of each tree
agree.
"""

import argparse
import json
import subprocess
import sys

_RUN = r'''
import contextlib, hashlib, io, json, re, shutil, subprocess, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from regneuralde_tpu_torch.ops import _cuda

phases = sys.argv[1].split(",")
DIGESTS = {}  # hashes of kernels' outputs on fixed inputs, by kernel


def device_ms(fn, names):
    """Device ms a call of fn of the kernels whose names hold one of names,
    under torch.profiler over cs.REPS calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(cs.REPS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and any(n in e.key for n in names))
    return us / 1e3 / cs.REPS


def flagship(dev):
    """Phase 5's seeded leaves and y0, the prologue at the flagship's
    tolerance, and K3's record of the solve (through the wrapper both trees
    share): (leaves, K3's arguments, the record, its trial steps)."""
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    B, D, H, tol = cs.BATCH, cs.DIM, cs.HIDDEN, cs.FLAGSHIP_TOL
    gen = torch.Generator().manual_seed(cs.SEED + 2)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
    leaves = [rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1),
              rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)]
    y0 = torch.rand(B, D, generator=gen).to(dev)
    parts = fm._split_params(*leaves)
    func = lambda t, y, _: fm._mlp_k(y, t, parts)[0]
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, (), tol, tol)
    args = (t0, t1, dt0, y0, f0, leaves, tol, tol, PIController.for_order(5), cs.MAX_STEPS)
    rec = ws.whole_solve_fwd(*args)
    return leaves, args, rec, int(rec.final[3:5].sum().item())


def k3(dev):
    """K3 for MLPDynamics over the flagship's solve: CUDA-event ms a call
    (median of cs.REPS) and the device ms of its kernel (the old
    whole_solve_fwd_kernel<MlpDyn> or mlp_solve_kernel)."""
    from regneuralde_tpu_torch.ops import whole_solve as ws

    _, args, _, ns = flagship(dev)
    call = lambda: ws.whole_solve_fwd(*args)
    return {f"K3_events_ns={ns}": {"ms": cs._time_ms(call)},
            f"K3_device_ns={ns}": {"ms": device_ms(call, ("whole_solve_fwd_kernel",
                                                          "mlp_solve_kernel"))}}


def fwd(dev):
    """Device ms a launch of K3 for AlternatingMLP and for CSL
    (whole_solve_fwd_kernel<AltDyn|CslDyn>), averaged over every launch of
    their whole-solve phases (the same solves in either tree): each such
    call of the wrapper under its own torch.profiler, the rest of the
    phases unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from regneuralde_tpu_torch.ops import whole_solve as ws

    inner, sums = ws.whole_solve_fwd, {}

    def profiled(*a, **k):
        if k.get("dynamics") not in ("altmlp", "csl"):
            return inner(*a, **k)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = inner(*a, **k)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and "whole_solve_fwd_kernel" in e.key:
                us, n = sums.get(k["dynamics"], (0.0, 0))
                sums[k["dynamics"]] = (us + e.self_device_time_total, n + e.count)
        return out

    _, saveat = cs.latent_batches(1, dev)
    batch = cs.ffjord_batches(1, dev)[0]
    ws.whole_solve_fwd = profiled
    try:
        cs.phase_whole_solve_altmlp_kernels(dev, saveat)
        cs.phase_whole_solve_csl_kernels(dev, batch)
    finally:
        ws.whole_solve_fwd = inner
    return {f"K3_{dyn}_device_a_launch": {"ms": us / n / 1e3} for dyn, (us, n) in sums.items()}


def solve_device(dynamics, run_phase):
    """Device ms a launch of K3 and K4 for ``dynamics``
    (whole_solve_fwd_kernel<...>, whole_solve_bwd_kernel<...>) over the
    solves of ``run_phase()``, each call of their wrappers under its own
    torch.profiler, by tolerance and trial steps (the same names in either
    tree). The phase's own device-time readings are left out (one profiler
    at a time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from regneuralde_tpu_torch.ops import whole_solve as ws

    sums = {}

    def profiled(inner, tag, kernel, key):
        def call(*a, **k):
            if k.get("dynamics") != dynamics:
                return inner(*a, **k)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = inner(*a, **k)
                torch.cuda.synchronize()
            name = f"{tag}_{dynamics}_device_{key(a, res)}"
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and kernel in e.key:
                    us, n = sums.get(name, (0.0, 0))
                    sums[name] = (us + e.self_device_time_total, n + e.count)
            return res
        return call

    inner_f, inner_b = ws.whole_solve_fwd, ws.whole_solve_bwd
    ns_of = lambda rec: int(rec.final[3:5].sum().item())
    device_ms_of_phase = getattr(cs, "_device_ms", None)
    ws.whole_solve_fwd = profiled(inner_f, "K3", "whole_solve_fwd_kernel",
                                  lambda a, res: f"tol={a[6]:g}_ns={ns_of(res)}")
    ws.whole_solve_bwd = profiled(inner_b, "K4", "whole_solve_bwd_kernel",
                                  lambda a, res: f"tol={a[7]:g}_ns={a[1]}")
    cs._device_ms = lambda *a, **k: None
    try:
        run_phase()
    finally:
        ws.whole_solve_fwd, ws.whole_solve_bwd = inner_f, inner_b
        cs._device_ms = device_ms_of_phase
    return {key: {"ms": us / n / 1e3} for key, (us, n) in sums.items()}


def csl_device(dev):
    """Device ms a launch of K7-CSL and of K8-CSL at phase 15's inputs
    (1.4e-8, without the kinetic terms), each kernel (csl_fwd_kernel,
    csl_bwd_kernel) and its slot sum (sum_slots_warp_kernel,
    sum_slots_kernel) apart, and of K3-CSL and K4-CSL over phase 16's solves
    (``solve_device``)."""
    from regneuralde_tpu_torch.ops import fused_csl as fc

    B, D, H, tol = cs.FFJORD_BATCH, cs.FFJORD_DIM, cs.FFJORD_HIDDEN, cs.FLAGSHIP_TOL
    gen = torch.Generator().manual_seed(cs.SEED + 12)
    leaves, y, k1 = cs._csl_inputs(gen, B, D, H, False, dev)
    cts = [torch.randn(y.shape, generator=gen).to(dev), torch.randn(y.shape, generator=gen).to(dev),
           *(torch.tensor(v, device=dev) for v in (0.7, 1.3, -0.4))]
    t, dt = torch.tensor(0.07, device=dev), torch.tensor(0.11, device=dev)
    fwd = lambda: fc.csl_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    bwd = lambda: fc.csl_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    out = {"K7_csl_device_kernel": {"ms": device_ms(fwd, ("csl_fwd_kernel",))},
           "K7_csl_device_slot_sum": {"ms": device_ms(fwd, ("sum_slots_warp_kernel",))},
           "K8_csl_device_kernel": {"ms": device_ms(bwd, ("csl_bwd_kernel",))},
           "K8_csl_device_slot_sum": {"ms": device_ms(bwd, ("sum_slots_kernel",))}}
    out.update(solve_device("csl", lambda: cs.phase_whole_solve_csl_kernels(
        dev, cs.ffjord_batches(1, dev)[0])))
    return out


def altmlp_device(dev):
    """Device ms a launch of K7 and of K8 at phase 8's inputs (1.4e-8),
    each kernel (altmlp_fwd_kernel, altmlp_bwd_kernel) and its slot sum
    (sum_slots_warp_kernel, sum_slots_kernel) apart, and of K3 and K4 for
    AlternatingMLP over phase 11's solves (``solve_device``): K8 and K4 run
    the reverse body, K7 and K3 are the control."""
    from regneuralde_tpu_torch.ops import fused_generic as fg

    B, D, H, tol = cs.LATENT_BATCH, cs.LATENT_DIM, cs.LATENT_HIDDEN, cs.FLAGSHIP_TOL
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
    leaves = []
    for _ in range(cs.LATENT_DEPTH):
        leaves += [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1),
                   rnd(D, H, scale=H ** -0.5), rnd(D, scale=0.1)]
    y, k1 = rnd(B, D, scale=0.5), rnd(B, D, scale=0.3)
    t, dt = torch.tensor(0.07, device=dev), torch.tensor(0.11, device=dev)
    cts = [rnd(B, D), rnd(B, D), *(torch.tensor(v, device=dev) for v in (0.7, 1.3, -0.4))]
    fwd = lambda: fg.altmlp_normed_sweep(t, dt, y, k1, leaves, tol, tol)
    bwd = lambda: fg.altmlp_normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    out = {"K7_device_kernel": {"ms": device_ms(fwd, ("altmlp_fwd_kernel",))},
           "K7_device_slot_sum": {"ms": device_ms(fwd, ("sum_slots_warp_kernel",))},
           "K8_device_kernel": {"ms": device_ms(bwd, ("altmlp_bwd_kernel",))},
           "K8_device_slot_sum": {"ms": device_ms(bwd, ("sum_slots_kernel",))}}
    _, saveat = cs.latent_batches(1, dev)
    out.update(solve_device("altmlp", lambda: cs.phase_whole_solve_altmlp_kernels(dev, saveat)))
    DIGESTS["K7"] = digest(fwd())
    DIGESTS["K8"] = digest(bwd())
    DIGESTS.update(altmlp_solve_digests(dev))
    return out


def digest(outs):
    """A hash of the bytes of every tensor in outs (nested sequences
    flattened): two trees' kernels gave the same bits where it is the same."""
    h = hashlib.sha256()

    def add(x):
        if isinstance(x, torch.Tensor):
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
        elif x is not None:
            for v in x:
                add(v)

    add(outs)
    return h.hexdigest()[:16]


def altmlp_solve_digests(dev):
    """Hashes of K3's record for AlternatingMLP on phase 11's inputs at
    1.4e-8 (49 saves) and of K4's cotangents over the plain forward's
    record of the same solve, y1's cotangent seeded (K4's input is then
    independent of K3)."""
    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    gen = torch.Generator().manual_seed(cs.SEED + 4)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    B, D, H, depth, tol = (cs.LATENT_BATCH, cs.LATENT_DIM, cs.LATENT_HIDDEN, cs.LATENT_DEPTH,
                           cs.FLAGSHIP_TOL)
    leaves = []
    for _ in range(depth):
        leaves += [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1), rnd(D, H, scale=H ** -0.5),
                   rnd(D, scale=0.1)]
    y0 = rnd(B, D, scale=0.8)
    _, saveat = cs.latent_batches(1, dev)
    ctrl = PIController.for_order(5)
    t0, t1, f0, dt0 = ode.solve_prologue(fg.alternating_mlp_apply(depth), y0, 0.0, 1.0,
                                         tuple(leaves), tol, tol)
    sa, ys_init = ode.saveat_rows(saveat, t0, t1, y0)
    args = (t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl, cs.LATENT_MAX_STEPS)
    kw = dict(dynamics="altmlp", saveat=sa, ys_init=ys_init)
    rk = ws.whole_solve_fwd(*args, **kw)
    nk = int(rk.final[3:5].sum().item())
    rec = ws.plain_whole_solve_fwd(*args, **kw)
    ns = int(rec.final[3:5].sum().item())
    ct_y1 = torch.randn(B, D, generator=torch.Generator().manual_seed(cs.SEED + 5)).to(dev)
    tel = torch.zeros(4, cs.LATENT_MAX_STEPS, device=dev)
    g = ws.whole_solve_bwd(rec, ns, ct_y1, tel, t0, t1, leaves, tol, tol, ctrl,
                           dynamics="altmlp", saveat=sa, ct_ys=torch.zeros_like(rec.ys))
    return {"K3": digest([rk.final, rk.streams[:, :nk], rk.hy[:nk + 1], rk.hf[:nk + 1],
                          rk.y1, rk.ys]),
            "K4": digest(g)}


def normed_device(dev):
    """Device ms a launch of K1 and of K2 at phase 2's inputs (rtol=atol=
    1.4e-8): K1's kernels (the old normed_fwd_kernel + reduce_partials_kernel,
    or mlp_step_solve_kernel<NormedEnd>), K2's own (the old normed_bwd_kernel
    + reduce_partials_kernel or mlp_step_walk_kernel<NormedSeed>) and the
    weight-cotangent contraction after them apart."""
    from regneuralde_tpu_torch.ops import fused_mlp as fm

    B, D, H, tol = cs.BATCH, cs.DIM, cs.HIDDEN, cs.FLAGSHIP_TOL
    gen = torch.Generator().manual_seed(cs.SEED + 1)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
    leaves = [rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1),
              rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)]
    y, k1 = rnd(B, D, scale=0.5), rnd(B, D, scale=0.3)
    t, dt = torch.tensor(0.07, device=dev), torch.tensor(0.11, device=dev)
    cts = [rnd(B, D), rnd(B, D), *(torch.tensor(v, device=dev) for v in (0.7, 1.3, -0.4))]
    bwd = lambda: fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    return {
        "K1_device": {"ms": device_ms(lambda: fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol),
                                      ("normed_fwd_kernel", "reduce_partials_kernel",
                                       "NormedEnd"))},
        "K2_device_kernel": {"ms": device_ms(bwd, ("normed_bwd_kernel", "reduce_partials_kernel",
                                                   "mlp_step_walk_kernel"))},
        "K2_device_wcot": {"ms": device_ms(bwd, ("wcot_chunk_kernel", "wcot_sum_kernel"))},
    }


def tuple_device(dev):
    """Device ms a launch of K13 and of K14 at phase 25's inputs (dt 0.05):
    K13's kernel (the old tuple_fwd_kernel, or mlp_step_solve_kernel<TupleEnd>),
    K14's own kernels (the old tuple_bwd_kernel + tuple_reduce_kernel or
    mlp_tuple_walk_kernel, now mlp_step_walk_kernel<TupleSeed>) and the
    weight-cotangent contraction after them apart."""
    from regneuralde_tpu_torch.ops import fused_mlp as fm

    B, D, H = cs.BATCH, cs.DIM, cs.HIDDEN
    gen = torch.Generator().manual_seed(cs.SEED + 41)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
    leaves = [rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1),
              rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)]
    y, k1 = rnd(B, D, scale=0.5), rnd(B, D, scale=0.3)
    cts = [rnd(B, D) for _ in range(5)]
    t, dt = torch.tensor(0.3, device=dev), torch.tensor(0.05, device=dev)
    bwd = lambda: fm.stage_sweep_bwd(t, dt, y, k1, leaves, cts)
    return {
        "K13_device": {"ms": device_ms(lambda: fm.stage_sweep_fwd(t, dt, y, k1, leaves),
                                       ("tuple_fwd_kernel", "mlp_step_solve_kernel"))},
        "K14_device_kernel": {"ms": device_ms(bwd, ("tuple_bwd_kernel", "tuple_reduce_kernel",
                                                    "mlp_tuple_walk_kernel",
                                                    "mlp_step_walk_kernel"))},
        "K14_device_wcot": {"ms": device_ms(bwd, ("wcot_chunk_kernel", "wcot_sum_kernel"))},
    }


def lanes_device(dev):
    """Device ms a launch of K11 and of K12 at phase 22's inputs: K11's
    kernel (the old lanes_fwd_kernel, or mlp_step_solve_kernel<LaneEnd>),
    K12's own kernel (the old lanes_bwd_kernel, or
    mlp_step_walk_kernel<LaneSeed>) and the weight-cotangent contraction
    after it apart."""
    from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl

    leaves, y, k1, t, dt, cts = cs._lane_inputs(dev)
    bwd = lambda: fl.sweep_lanes_bwd(t, dt, y, k1, leaves, cts)
    return {
        "K11_device": {"ms": device_ms(lambda: fl.sweep_lanes_fwd(t, dt, y, k1, leaves),
                                       ("lanes_fwd_kernel", "LaneEnd"))},
        "K12_device_kernel": {"ms": device_ms(bwd, ("lanes_bwd_kernel",
                                                    "mlp_step_walk_kernel"))},
        "K12_device_wcot": {"ms": device_ms(bwd, ("wcot_chunk_kernel", "wcot_sum_kernel"))},
    }


def sde_device(dev, body):
    """K9's and K10's device ms a solve under the profiler at phase 19's
    inputs (body "mlp": 512 x 32, drift 32-64-32, SOSRI2, at 1.4e-1 and at
    1.4e-2 with 5 saves) or phase 29's ("cubic": 100 x 2, drift 2-50-2 after
    the cube, SOSRI, 30 saves, at 3e-1 and 3e-2), K10's kernel and its slot
    sum apart, by tolerance and trial steps; and hashes of both kernels'
    outputs."""
    import numpy as np
    from regneuralde_tpu_torch.ops import sde as sde_ops
    from regneuralde_tpu_torch.ops import sde_whole_solve as sw
    from regneuralde_tpu_torch.ops.controller import PIController
    from regneuralde_tpu_torch.training import sde_toy as st

    ctrl = PIController(beta1=0.5, beta2=0.0)
    t0, t1 = torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev)
    dt0 = torch.tensor(0.01, device=dev)
    if body == "mlp":
        gen = torch.Generator().manual_seed(cs.SEED + 21)
        rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
        B, D, H = cs.NSDE_BATCH, cs.NSDE_DIM, cs.NSDE_HIDDEN
        leaves = [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1), rnd(D, H, scale=H ** -0.5),
                  rnd(D, scale=0.1), rnd(D, D, scale=D ** -0.5), rnd(D, scale=0.1)]
        y0 = rnd(B, D, scale=0.5)
        cases = [(cs.NSDE_TOL, cs.NSDE_MAX_STEPS, None),
                 (cs.NSDE_TIGHT_TOL, 256, [0.0, 0.25, 0.5, 0.75, 1.0])]
        kw0 = dict(n_drift=2, solver="sosri2")
    else:
        S = st.MAX_STEPS
        leaves, y0, xi = cs._toy_inputs(dev, S, torch.Generator().manual_seed(cs.SEED + 47),
                                        2.0)
        B, D = y0.shape
        sa = np.linspace(0.0, 1.0, 30).astype(np.float32).tolist()
        cases = [(st.TOL, S, sa), (cs.TOY_TIGHT_TOL, S, sa)]
        kw0 = dict(n_drift=2, solver="sosri", body="cubic")
    out = {}
    for tol, S, sa in cases:
        if body == "mlp":
            xi = sde_ops.presample_noise(torch.Generator(device=dev).manual_seed(cs.SEED + 22),
                                         (B, D), S)
        kw = dict(kw0)
        if sa is not None:
            kw["saveat"], kw["ys_init"] = sde_ops.save_rows_at_start(
                torch.tensor(sa, device=dev), t0, y0)
        args = (t0, t1, dt0, y0, leaves, tol, tol, ctrl, S, *xi)
        rec = sw.sde_whole_solve_fwd(*args, **kw)
        ns = int(rec.final[3:5].sum().item())
        g = torch.Generator().manual_seed(7)
        ct_y1 = torch.randn(B, D, generator=g).to(dev)
        ct_tel = (0.1 * torch.randn(4, S, generator=g)).to(dev)
        ct_ys = None if sa is None else torch.randn(len(sa), B, D, generator=g).to(dev)
        bkw = {k: v for k, v in kw.items() if k != "ys_init"}
        bwd = lambda: sw.sde_whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol,
                                             ctrl, *xi, ct_ys=ct_ys, **bkw)
        fwd = lambda: sw.sde_whole_solve_fwd(*args, **kw)
        tag = f"{body}_tol={tol:g}_ns={ns}"
        out[f"K9_{tag}_device"] = {"ms": device_ms(fwd, ("sde_whole_solve_fwd_kernel",))}
        out[f"K10_{tag}_device"] = {"ms": device_ms(bwd, ("sde_whole_solve_bwd_kernel",))}
        out[f"K10_slot_sum_{tag}_device"] = {"ms": device_ms(bwd, ("sum_slots_kernel",))}
        DIGESTS[f"K9_{tag}"] = digest([rec.y1, rec.ys, rec.hy[:ns + 1], rec.hw[:ns + 1],
                                       rec.hz[:ns + 1], rec.streams, rec.final, rec.cursors])
        DIGESTS[f"K10_{tag}"] = digest(list(bwd()))
    return out


def wcot(dev):
    """Device ms a call of the weight-cotangent contraction's kernels (the
    old atb_split_kernel or wcot_chunk_kernel + wcot_sum_kernel) inside K2
    and inside K4<MlpDyn>, both through the wrappers both trees share."""
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import whole_solve as ws

    B, D, tol = cs.BATCH, cs.DIM, cs.FLAGSHIP_TOL
    leaves, args, rec, ns = flagship(dev)
    t0, t1, y0, ctrl = args[0], args[1], args[3], args[8]
    gen = torch.Generator().manual_seed(cs.SEED + 3)
    rnd = lambda *shape, scale=1.0: (torch.randn(*shape, generator=gen) * scale).to(dev)
    k1 = rnd(B, D, scale=0.3)
    ct_y1, ct_tel = rnd(B, D), torch.zeros(4, cs.MAX_STEPS, device=dev)
    t, dt = torch.tensor(0.07, device=dev), torch.tensor(0.11, device=dev)
    cts = [rnd(B, D), rnd(B, D), *(torch.tensor(v, device=dev) for v in (0.7, 1.3, -0.4))]
    calls = {
        f"wcot_in_K2_K={6 * B}": lambda: fm.normed_sweep_bwd(t, dt, y0, k1, leaves, cts,
                                                             tol, tol),
        f"wcot_in_K4_K={6 * B * ns}": lambda: ws.whole_solve_bwd(
            rec, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl),
    }
    names = ("atb_split_kernel", "wcot_chunk_kernel", "wcot_sum_kernel")
    out = {key: {"ms": device_ms(fn, names)} for key, fn in calls.items()}
    # the walk itself on the same call (mlp_walk_kernel<true>, or the old
    # whole_solve_bwd_kernel<MlpDyn>), and replaying the stages
    # (mlp_walk_kernel<false>)
    walks = ("mlp_walk_kernel", "whole_solve_bwd_kernel")
    out[f"K4_walk_device_ns={ns}"] = {"ms": device_ms(calls[f"wcot_in_K4_K={6 * B * ns}"],
                                                      walks)}
    out[f"K4_replay_walk_device_ns={ns}"] = {"ms": device_ms(
        lambda: ws.whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl,
                                   cache_residuals=False), walks)}
    return out

lib = _cuda.library()
dev = torch.device("cuda", 0)
ms = {}
with contextlib.redirect_stdout(io.StringIO()):
    if "mlp" in phases:
        ms.update(cs.phase_kernels(dev))
        ms.update(normed_device(dev))
        ms.update(cs.phase_whole_solve_kernels(dev))
    if "altmlp" in phases:
        ms.update(cs.phase_altmlp_kernels(dev))
        _, saveat = cs.latent_batches(1, dev)
        ms.update(cs.phase_whole_solve_altmlp_kernels(dev, saveat))
        ms.update(altmlp_device(dev))
    if "csl" in phases and hasattr(cs, "phase_csl_kernels"):
        ms.update(cs.phase_csl_kernels(dev))
        ms.update(cs.phase_whole_solve_csl_kernels(dev, cs.ffjord_batches(1, dev)[0]))
        ms.update(csl_device(dev))
    if "sde" in phases and hasattr(cs, "phase_sde_kernels"):
        ms.update(cs.phase_sde_kernels(dev))
        ms.update(sde_device(dev, "mlp"))
    if "sdecubic" in phases and hasattr(cs, "phase_sde_cubic_kernels"):
        ms.update(cs.phase_sde_cubic_kernels(dev))
        ms.update(sde_device(dev, "cubic"))
    if "lanes" in phases and hasattr(cs, "phase_lanes_kernels"):
        ms.update(cs.phase_lanes_kernels(dev))
        ms.update(lanes_device(dev))
    if "tuple" in phases and hasattr(cs, "phase_tuple_kernels"):
        ms.update(cs.phase_tuple_kernels(dev))
        ms.update(tuple_device(dev))
    if "wcot" in phases:
        ms.update(wcot(dev))
    if "k3" in phases:
        ms.update(k3(dev))
    if "fwd" in phases:
        ms.update(fwd(dev))
ptxas, name = {}, None
for line in _cuda.ptxas_report().splitlines():
    m = re.search(r"Compiling entry function '(\S+)'", line)
    if m:
        name = m.group(1)
    elif name and ("registers" in line or "stack frame" in line):
        ptxas.setdefault(name, []).append(line.split(":", 1)[-1].strip())
# each kernel's SASS, hashed, under its name with the tree's anonymous-
# namespace tags taken out (the second one hashes the translation unit, so it
# changes with any edit of the file); cuobjdump numbers branch labels and
# pads columns across the whole library, so labels are numbered from 0
# within the kernel and runs of blanks count as one; the compiler numbers
# its internal functions (the division slow path a kernel calls,
# $__internal_<n>_...) across the translation unit, so a kernel added to it
# renumbers them: the number is taken out of the calls
cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
dump = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True, text=True,
                      check=True).stdout
sass, name = {}, None
for line in dump.splitlines():
    m = re.match(r"\s*Function : (\S+)", line)
    if m:
        name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", m.group(1))
        name = re.sub(r"_cu_[0-9a-f]{8}", "_cu_", name)
        sass[name], labels = hashlib.sha256(), {}
    elif name and line.strip().startswith(("/*", ".L_x_")):  # instructions, labels
        line = re.sub(r"\.L_x_\d+",
                      lambda l: "L%d" % labels.setdefault(l.group(0), len(labels)), line)
        line = re.sub(r"\$__internal_\d+_", "$__internal_", line)
        sass[name].update(" ".join(line.split()).encode())
print(json.dumps({"ms": {k: v["ms"] for k, v in ms.items()}, "ptxas": ptxas,
                  "sass": {k: h.hexdigest() for k, h in sass.items()}, "digests": DIGESTS}))
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="the other tree")
    ap.add_argument("--b", default=".", help="this tree (default: the current directory)")
    ap.add_argument("--phases", default="altmlp,csl")
    ap.add_argument("--rounds", type=int, default=1, help="A, B, B, A this many times")
    args = ap.parse_args()
    results = []
    for tag, tree in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)) * args.rounds:
        out = subprocess.run([sys.executable, "-c", _RUN, args.phases], cwd=tree,
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(f"[ab] {tag} ({tree}) failed:\n{out.stderr[-3000:]}", file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        results.append((tag, res))
        print(f"[ab] {tag} ({tree}) ms " + json.dumps(res["ms"]))
        if res.get("digests"):
            print(f"[ab] {tag} ({tree}) output hashes " + json.dumps(res["digests"]))
    for tag, tree in (("A", args.a), ("B", args.b)):
        ptxas = next(r["ptxas"] for t, r in results if t == tag)
        for name, lines in sorted(ptxas.items()):
            print(f"[ptxas] {tag} {name[:90]}: " + "; ".join(lines))
    sass_a = next(r["sass"] for t, r in results if t == "A")
    sass_b = next(r["sass"] for t, r in results if t == "B")
    for name in sorted(set(sass_a) | set(sass_b)):
        a, b = sass_a.get(name), sass_b.get(name)
        if a and b:
            verdict = "same" if a == b else "differs"
        else:
            other = sass_b if a else sass_a
            twin = next((n for n in other if n not in (sass_a if a else sass_b)
                         and other[n] == (a or b)), None)
            verdict = ("only in A" if a else "only in B") + (
                f", the same as {twin[:90]}" if twin else ", no kernel of the other the same")
        print(f"[sass] {name[:90]}: {verdict}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
