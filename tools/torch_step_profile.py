#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's training steps on one GPU.

    python3 tools/torch_step_profile.py [--model mnist|latent|ffjord|nsde|toy]
                                        [--fused step|true|false] [--steps 3]
                                        [--tol 1.4e-8] [--per-sample]
                                        [--tuple adjoint|scan] [--pin] [--out DIR]

``--model mnist`` (the default) builds the flagship classifier of
``chip_smoke.py`` (MLPDynamics(784, 100), Tsit5, max_steps=96, batch 512),
``--model latent`` the latent ODE of ``chip_smoke.py`` (batch 256, 49
saveat stamps, max_steps=256), ``--model ffjord`` FFJORD's tabular
configuration of ``chip_smoke.py`` (CSLDynamics(43, 100), batch 1024,
max_steps=128, -mean(logpx) + 5e3 * error_estimate, WeightDecay(1e-5) then
Adam(1e-2)), ``--model nsde`` the MNIST Neural SDE of ``chip_smoke.py``
(ClassifierNSDE at 784 -> 32, drift 32-64-32, diffusion 32-32, SOSRI2 at
rtol=atol=1.4e-1, max_steps=128, batch 512, CE + 0.1 * stiffness_estimate,
InvDecay(1e-5) then Adam(0.01), fresh draws each step; ``--tol`` does not
apply), ``--model toy`` the toy 2-D SDE fit of ``chip_smoke.py`` phase 30
(``training.sde_toy``: CubicDrift(2, 50) and Dense(2), 100 trajectories,
30 saves, SOSRI at rtol=atol=3e-1, max_steps=256, the moments' loss + 0.2 *
error_estimate, AdaBelief(0.01), fresh draws each step; ``--tol`` does not
apply), on the step kernels (``--fused step``, the default: K1/K2, K7/K8
or K7/K8-CSL on every trial step; the SDEs have no step route), the
whole-solve kernels (``--fused true``: K3/K4 or K9/K10 once per solve) or
no kernel (``--fused false``, the plain PyTorch route). ``--per-sample``
(MNIST only) gives the classifier's node ``per_sample="batched"``: every
row under its own controller, on the lane-wise kernels K11/K12 (``--fused
step`` or ``true``) or their plain versions (``false``). ``--tuple
adjoint|scan`` (MNIST only) runs the classifier's solve through ``odeint``'s
generic engine on the tuple trial step K13/K14 (``chip_smoke.tuple_loss``,
as phase 27) under the replay adjoint or the checkpointed scan; ``--fused``
does not apply. ``--pin`` starts every step (the warm-up, the timed, the
counted and the traced steps) from the same parameters and optimizer
state, those before the warm-up: two source trees whose gradients differ
in rounding then run the same forward solves, so their step times compare
without the lanes' trial steps parting. It runs one warm-up step, then:

* times ``--steps`` training steps on the host clock (each ends in a
  synchronize) and reports ms per step, NFE per step and trial steps;
* counts the host synchronisations of one step (``torch.cuda`` sync debug
  mode, one warning per synchronising call);
* traces one step with ``torch.profiler`` and prints device time by kernel,
  the device-busy share of the step's wall time, the device time of the
  weight-cotangent contraction's two kernels (``wcot_chunk_kernel``,
  ``wcot_sum_kernel``) apart from the kernel that launches them, and writes
  the chrome trace to ``--out``;
* for the latent model, FFJORD and the SDEs, splits that step's host and
  device time between its parts: ``record_function`` ranges around the encoder's
  GRU loop and MLP, the node (the solve) and the decoder (FFJORD: the
  model's whole forward, the solve and logpz; the SDEs: the solve) in the
  forward, and in the
  backward the solve's autograd function against everything else (the
  GRU's, encoder's, decoder's and loss's autograd nodes); with
  ``--per-sample``, the engine's parts: its forward iteration loop, the
  sweep (K11 or its plain version), the per-lane chain after it, the
  reverse walk, the sweep's backward (K12 or its plain version) and the
  walk's recompute and autograd of the chain; with ``--tuple``, the forward's
  trial-step loop and its sweeps (K13), and in the backward the sweeps of the
  replay or of the checkpoint's recompute (K13), the sweep's backward (K14)
  and the replay adjoint's autograd function.
"""

import argparse
import json
import os
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _annotate(module, label, record_function):
    """A ``record_function`` range around each forward call of ``module``."""
    open_ranges = []
    module.register_forward_pre_hook(
        lambda m, a: open_ranges.append(record_function(label).__enter__()))
    module.register_forward_hook(
        lambda m, a, out: open_ranges.pop().__exit__(None, None, None))


def _wrap(module, name, label, record_function):
    """Replace ``module.name`` by the same function inside a
    ``record_function`` range (looked up at call time by its callers)."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)

    setattr(module, name, wrapped)


def _annotate_per_sample(record_function):
    """Ranges around the per-sample engine's parts. The per-lane chain runs
    without autograd in the forward loop and under it in the reverse walk,
    which recomputes it for ``torch.autograd.grad``."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl
    from regneuralde_tpu_torch.ops import per_sample_batched as psb

    _wrap(psb, "_solve_forward", "[part] forward: the engine's iteration loop", record_function)
    _wrap(psb, "_adjoint_walk", "[part] backward: the reverse walk", record_function)
    for name in ("mlp_dynamics_sweep_lanes", "plain_mlp_sweep_lanes"):
        _wrap(fl, name, "[part] forward: the sweep (K11 or its plain version)", record_function)
    for name in ("mlp_dynamics_sweep_lanes_bwd", "plain_mlp_sweep_lanes_bwd"):
        _wrap(fl, name, "[part] backward: the sweep's backward (K12 or its plain version)",
              record_function)
    chain = psb._chain

    def labelled_chain(*args, **kwargs):
        label = ("[part] backward: the chain's recompute in the walk" if torch.is_grad_enabled()
                 else "[part] forward: the per-lane chain after the sweep")
        with record_function(label):
            return chain(*args, **kwargs)

    psb._chain = labelled_chain


def _annotate_tuple(record_function):
    """Ranges around the generic engine's parts on the tuple step: the
    forward's trial-step loop, and the sweep (K13) inside it or, outside
    it, in the backward (the replay adjoint's rebuilt steps, the scan's
    checkpoint recompute)."""
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode

    in_loop = []
    run_steps, sweep = ode._run_steps, fm.mlp_dynamics_stage_sweep

    def labelled_run_steps(*args, **kwargs):
        in_loop.append(True)
        try:
            with record_function("[part] forward: the trial-step loop"):
                return run_steps(*args, **kwargs)
        finally:
            in_loop.pop()

    def labelled_sweep(*args, **kwargs):
        label = ("[part] forward: the sweep (K13)" if in_loop
                 else "[part] backward: the replayed or recomputed sweep (K13)")
        with record_function(label):
            return sweep(*args, **kwargs)

    ode._run_steps = labelled_run_steps
    fm.mlp_dynamics_stage_sweep = labelled_sweep
    _wrap(fm, "stage_sweep_bwd", "[part] backward: the sweep's backward (K14)",
          record_function)


def _print_split(events, wall_ms):
    """Host (CPU) and device time of the latent step's parts: the forward
    ranges of ``_annotate`` and, in the backward, the solve's autograd
    function against the other autograd nodes (those the solve's backward
    runs itself, the step route's autograd of its scalar chain, count as
    the solve's). Host-side events only: each range also has a device-side
    twin that spans its kernels."""
    from torch.autograd import DeviceType

    events = [e for e in events if e.device_type == DeviceType.CPU]
    solve_bwd = ("WholeSolveFnBackward", "FastAdjointSolveBackward",
                 "SDEWholeSolveFnBackward", "SDEAdjointSolveBackward",
                 "PerSampleAdjointSolveBackward", "ReplayAdjointSolveBackward")
    engine = "autograd::engine::evaluate_function:"
    solves = [e.time_range for e in events
              if e.name.startswith(engine) and any(k in e.name for k in solve_bwd)]
    rows = {}

    def add(name, e):
        host, dev = rows.get(name, (0.0, 0.0))
        rows[name] = (host + e.cpu_time_total, dev + e.device_time_total)

    for e in events:
        if e.name.startswith("[part]"):
            add(e.name[7:], e)
        elif e.name.startswith(engine):
            if any(k in e.name for k in solve_bwd):
                add("backward: the solve", e)
            elif not any(r.start <= e.time_range.start and e.time_range.end <= r.end
                         for r in solves):
                add("backward: the rest (every other autograd node)", e)
    for name, (host, dev) in rows.items():
        print(f"[split] {name}: host {host / 1e3:.3f} ms, device {dev / 1e3:.3f} ms "
              f"(traced step wall {wall_ms:.3f} ms)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["mnist", "latent", "ffjord", "nsde", "toy"],
                    default="mnist")
    ap.add_argument("--fused", choices=["step", "true", "false"], default="step")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1.4e-8)
    ap.add_argument("--per-sample", action="store_true",
                    help="MNIST with per_sample='batched' (K11/K12)")
    ap.add_argument("--tuple", choices=["adjoint", "scan"],
                    help="MNIST with the solve through odeint on K13/K14 in this mode")
    ap.add_argument("--pin", action="store_true",
                    help="every step from the parameters and optimizer state before the warm-up")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if (args.per_sample or args.tuple) and args.model != "mnist":
        ap.error("--per-sample and --tuple apply to --model mnist")
    if args.per_sample and args.tuple:
        ap.error("--per-sample and --tuple exclude each other")

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from regneuralde_tpu_torch.training import (
        create_train_state,
        ffjord_optimizer,
        latent_ode_optimizer,
        make_train_step,
        mnist_node_optimizer,
        mnist_nsde_optimizer,
        sde_toy_optimizer,
    )

    device = torch.device("cuda", 0)
    fused = {"true": True, "false": False, "step": "step"}[args.fused]
    if args.model in ("nsde", "toy") and fused == "step":
        ap.error("the SDEs have no step route: use --fused true or false")
    if args.model == "toy":
        from regneuralde_tpu_torch.data import make_sde_demo
        from regneuralde_tpu_torch.training import sde_toy as st

        means, vars_, tsteps, _ = make_sde_demo(seed=0)
        means, vars_ = torch.from_numpy(means).to(device), torch.from_numpy(vars_).to(device)
        u0 = st.sde_toy_u0(device=device)
        batches = [(u0, means, vars_, cs.toy_noise(i, device)) for i in range(args.steps + 2)]
        model = st.build_sde_toy(tsteps, fused, device=device,
                                 generator=torch.Generator().manual_seed(cs.SEED))
        optimizer = sde_toy_optimizer()
        loss_fn = st.sde_toy_loss
        _annotate(model, "[part] forward: the solve", record_function)
    elif args.model == "nsde":
        xy = cs.synthetic_batches(args.steps + 2, device)
        batches = [(x, y, cs.nsde_noise(i, device)) for i, (x, y) in enumerate(xy)]
        model = cs.build_nsde("sosri2", fused, device)
        optimizer = mnist_nsde_optimizer()
        loss_fn = cs.nsde_loss
        _annotate(model.nsde, "[part] forward: the solve", record_function)
    elif args.model == "latent":
        batches, saveat = cs.latent_batches(args.steps + 2, device)
        model, gen = cs.build_latent(args.tol, fused, device, saveat)
        model.init(cs.latent_inputs(*batches[0][:3]), generator=gen)
        optimizer = latent_ode_optimizer()
        loss_fn = cs.latent_loss
        ranges = {"rnn": "[part] encoder: GRU loop", "enc": "[part] encoder: MLP",
                  "node": "[part] node: the solve", "dec": "[part] decoder"}
        for attr, label in ranges.items():
            _annotate(getattr(model, attr), label, record_function)
    elif args.model == "ffjord":
        batches = cs.ffjord_batches(args.steps + 2, device)
        model = cs.build_ffjord(args.tol, fused, device)
        optimizer = ffjord_optimizer(1e-2)
        loss_fn = cs.ffjord_loss
        _annotate(model, "[part] forward: the solve and logpz", record_function)
    else:
        batches = cs.synthetic_batches(args.steps + 2, device)
        model, gen = cs.build_classifier(args.tol, fused, device,
                                         per_sample="batched" if args.per_sample else False)
        model.init(batches[0][0], generator=gen)
        optimizer = mnist_node_optimizer()
        loss_fn = cs.mnist_loss
        if args.per_sample:
            _annotate_per_sample(record_function)
        if args.tuple:
            loss_fn = lambda m, x, y: cs.tuple_loss(m, x, y, args.tuple)
            _annotate_tuple(record_function)
    state = create_train_state(model, optimizer)
    train_step = make_train_step(loss_fn, optimizer)
    state0, params0 = state, [p.detach().clone() for p in model.parameters()]

    def step(state, *batch):
        if args.pin:  # the optimizers are functional: only the parameters change in place
            with torch.no_grad():
                for p, p0 in zip(model.parameters(), params0):
                    p.copy_(p0)
            state = state0
        return train_step(state, *batch)

    counters = cs._counters()

    state, _, _ = step(state, *batches[0])  # warm-up (allocator, build)
    torch.cuda.synchronize()

    rows = []
    for batch in batches[1:1 + args.steps]:
        for mod in counters:
            mod.reset_launches()
        start = time.perf_counter()
        state, loss, out = step(state, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        nfe = [out.nfe1, out.nfe2] if args.model in ("nsde", "toy") else out.nfe
        extra = {}
        if args.per_sample:  # per-lane NFE; an engine iteration is a trial step of each live lane
            nfe = {k: getattr(out.nfe.double(), k)().item() for k in ("min", "mean", "max")}
            extra["iterations"] = int(out.telemetry.live.any(0).sum().item())
        rows.append(dict(ms=wall * 1e3, nfe=nfe,
                         trial_steps=int(out.telemetry.live.sum().item()),
                         loss=loss.item(), **extra,
                         launches={k: v for m in counters for k, v in m.LAUNCHES.items()}))
    for r in rows:
        print(f"[step] model={args.model} fused={fused!r} per_sample={args.per_sample} "
              f"tuple={args.tuple} " + json.dumps(r))

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, loss, out = step(state, *batches[-1])
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    nsync = sum("synchroniz" in str(w.message) for w in caught)
    print(f"[sync] host synchronisations in one step: {nsync} "
          f"(trial steps {int(out.telemetry.live.sum().item())})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        state, loss, out = step(state, *batches[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    # Device-side kernels only: a CPU op that launched a kernel through
    # ctypes also reports that kernel's time as its own, and a [part] range
    # has a device-side twin that spans the kernels inside it.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.key.startswith("[part]")]
    device_us = sum(e.self_device_time_total for e in events)
    median_ms = sorted(r["ms"] for r in rows)[len(rows) // 2]
    print(f"[profile] traced step wall {wall * 1e3:.3f} ms, device busy "
          f"{device_us / 1e3:.3f} ms; against the untraced median step "
          f"{median_ms:.3f} ms the device is busy "
          f"{100 * device_us / (median_ms * 1e3):.1f}% "
          f"(trial steps {int(out.telemetry.live.sum().item())})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"[profile] {e.self_device_time_total / 1e3:9.3f} ms "
              f"{e.count:6d} calls  {e.key[:90]}")
    # the weight-cotangent contraction that ends K2, K4<MlpDyn>, K12 and
    # K14 (its chunk and chunk-sum kernels), named apart from the walk
    # that launches it
    for name in ("wcot_chunk_kernel", "wcot_sum_kernel"):
        hits = [e for e in events if name in e.key]
        print(f"[profile] weight-cotangent contraction, {name}: "
              f"{sum(e.self_device_time_total for e in hits) / 1e3:.3f} ms, "
              f"{sum(e.count for e in hits)} calls")
    if args.model in ("latent", "ffjord", "nsde", "toy") or args.per_sample or args.tuple:
        _print_split(prof.events(), wall * 1e3)
    os.makedirs(args.out, exist_ok=True)
    tag = ("_per_sample" if args.per_sample else "") + (f"_tuple_{args.tuple}" if args.tuple
                                                        else "")
    prof.export_chrome_trace(os.path.join(
        args.out, f"train_step_trace_{args.model}{tag}_{args.fused}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
