#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's training steps on one GPU.

    python3 tools/torch_step_profile.py [--model mnist|latent]
                                        [--fused step|true] [--steps 3]
                                        [--tol 1.4e-8] [--out DIR]

``--model mnist`` (the default) builds the flagship classifier of
``chip_smoke.py`` (MLPDynamics(784, 100), Tsit5, max_steps=96, batch 512)
on the step kernels (``--fused step``, the default) or the whole-solve
kernels (``--fused true``); ``--model latent`` the latent ODE of
``chip_smoke.py`` (batch 256, 49 saveat stamps, max_steps=256) on the
AlternatingMLP step kernels K7/K8 (``--fused step`` only: its whole solve
is not ported). It runs one warm-up step, then:

* times ``--steps`` training steps on the host clock (each ends in a
  synchronize) and reports ms per step, NFE per step and trial steps;
* counts the host synchronisations of one step (``torch.cuda`` sync debug
  mode, one warning per synchronising call);
* traces one step with ``torch.profiler`` and prints device time by kernel,
  the device-busy share of the step's wall time, and writes the chrome trace
  to ``--out``.
"""

import argparse
import json
import os
import sys
import time
import warnings
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["mnist", "latent"], default="mnist")
    ap.add_argument("--fused", choices=["step", "true"], default="step")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1.4e-8)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.training import (
        create_train_state,
        latent_ode_optimizer,
        make_train_step,
        mnist_node_optimizer,
    )

    device = torch.device("cuda", 0)
    fused = True if args.fused == "true" else "step"
    if args.model == "latent":
        if fused != "step":
            ap.error("--model latent runs --fused step (its whole solve is not ported)")
        batches, saveat = cs.latent_batches(args.steps + 2, device)
        model, gen = cs.build_latent(args.tol, fused, device, saveat)
        model.init(cs.latent_inputs(*batches[0][:3]), generator=gen)
        optimizer = latent_ode_optimizer()
        loss_fn = cs.latent_loss
    else:
        batches = cs.synthetic_batches(args.steps + 2, device)
        model, gen = cs.build_classifier(args.tol, fused, device)
        model.init(batches[0][0], generator=gen)
        optimizer = mnist_node_optimizer()
        loss_fn = cs.mnist_loss
    state = create_train_state(model, optimizer)
    step = make_train_step(loss_fn, optimizer)
    counters = (fm, ws, fg)

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
        rows.append(dict(ms=wall * 1e3, nfe=out.nfe,
                         trial_steps=int(out.telemetry.live.sum().item()),
                         loss=loss.item(),
                         launches={k: v for m in counters for k, v in m.LAUNCHES.items()}))
    for r in rows:
        print(f"[step] model={args.model} fused={fused!r} " + json.dumps(r))

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
    # Device-side events only: a CPU op that launched a kernel through
    # ctypes also reports that kernel's time as its own.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
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
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        args.out, f"train_step_trace_{args.model}_{args.fused}.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
