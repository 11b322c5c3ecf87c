#!/usr/bin/env python3
"""Profile the PyTorch/CUDA port's flagship MNIST training step on one GPU.

    python3 tools/torch_step_profile.py [--steps 3] [--tol 1.4e-8] [--out DIR]

Builds the flagship classifier of ``chip_smoke.py`` (MLPDynamics(784, 100),
Tsit5, max_steps=96, batch 512, fused="step"), runs one warm-up step, then:

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
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        mnist_node_optimizer,
    )

    device = torch.device("cuda", 0)
    batches = cs.synthetic_batches(args.steps + 2, device)
    clf, gen = cs.build_classifier(args.tol, "step", device)
    clf.init(batches[0][0], generator=gen)
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(cs.mnist_loss, optimizer)

    state, _, _ = step(state, *batches[0])  # warm-up (allocator, build)
    torch.cuda.synchronize()

    rows = []
    for x, y in batches[1:1 + args.steps]:
        fm.reset_launches()
        start = time.perf_counter()
        state, loss, out = step(state, x, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        rows.append(dict(ms=wall * 1e3, nfe=out.nfe,
                         trial_steps=int(out.telemetry.live.sum().item()),
                         loss=loss.item(), launches=dict(fm.LAUNCHES)))
    for r in rows:
        print("[step] " + json.dumps(r))

    x, y = batches[-1]
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, loss, out = step(state, x, y)
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
    prof.export_chrome_trace(os.path.join(args.out, "train_step_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
