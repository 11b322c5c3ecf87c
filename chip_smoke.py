#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MNIST Neural-ODE training step on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA device and ``nvcc``; the
kernels are built from ``regneuralde_tpu_torch/csrc`` into ``build/kernels/``
at first use. Phases (each checks its results; any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), versions, kernel build;
2. K1 and K2 (the normed Tsit5 step kernels) against their plain PyTorch
   versions at B=512, D=784, H=100, at rtol=atol=1e-4 and 1.4e-8, with
   CUDA-event times of both;
3. one forward+backward of the training step at full width (rtol=atol=1e-5),
   kernel path (``fused="step"``) against the plain path (``fused=False``):
   identical NFE and accept sequence, relative gradient error <= 1e-3;
4. three training steps of the flagship configuration (Tsit5 at
   rtol=atol=1.4e-8, max_steps=96, batch 512, CE + 100 * error_estimate,
   InvDecay(1e-5) then Momentum(0.1, 0.9)), with the kernels' launch counts.

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
FWD_BOUND, BWD_BOUND, GRAD_BOUND, REG_GRAD_BOUND = 1e-4, 1e-3, 1e-3, 5e-2
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


def phase_kernel_vs_plain_step(device, batch):
    """One forward+backward of the training step: kernels against plain.

    The cross-entropy gradient is held to GRAD_BOUND. The full gradient adds
    100 * error_estimate, whose gradient at rtol=atol=1e-5 in float32 is
    dominated by the rounding noise of the embedded error estimate: a change
    of summation order alone moves it by about 1.5e-2 (relative), so it is
    held to REG_GRAD_BOUND."""
    import torch

    x, y = batch
    tol = 1e-5
    kern, gen = build_classifier(tol, "step", device)
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
        print(f"[step] rtol=atol={tol:g} reg_weight={reg_weight:g} "
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


def phase_slice(device, batches):
    """Three training steps of the flagship configuration."""
    import torch

    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.training import (
        create_train_state,
        make_train_step,
        mnist_node_optimizer,
    )

    clf, gen = build_classifier(FLAGSHIP_TOL, "step", device)
    clf.init(batches[0][0], generator=gen)
    optimizer = mnist_node_optimizer()
    state = create_train_state(clf, optimizer)
    step = make_train_step(lambda m, x, y: mnist_loss(m, x, y), optimizer)
    before = [p.detach().clone() for p in clf.parameters()]

    torch.cuda.synchronize()
    fm.reset_launches()  # count only the main path's launches
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
        print(f"[slice] step {i}: loss={loss.item()!r} nfe={out.nfe} "
              f"naccept={naccept} nreject={nlive - naccept} "
              f"success={out.success} wall_s={wall!r} "
              f"launches={json.dumps(fm.LAUNCHES)}")
        _check(torch.isfinite(loss).item(), f"finite loss, got {loss.item()}")
        _check(out.success, "the solve reached t1")
        _check(out.nfe == 2 + 6 * nlive, "NFE = 2 + 6 * trial steps")
        _check(torch.isfinite(out.logits).all().item(), "finite logits")
    launches = dict(fm.LAUNCHES)
    moved = max((p.detach() - b).abs().max().item()
                for p, b in zip(clf.parameters(), before))
    print(f"[slice] trial steps={trial_steps} launches={json.dumps(launches)} "
          f"max parameter change={moved!r}")
    _check(moved > 0.0, "the parameters moved")
    for name, n in launches.items():
        _check(n == trial_steps, f"{name}: {n} launches for {trial_steps} trial steps")
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
    phase_kernel_vs_plain_step(device, batches[0])
    launches = phase_slice(device, batches)

    record = {"kernels": [
        {"name": name, "route": "cuda",
         "source": "regneuralde_tpu_torch/csrc/normed_tsit5.cu",
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
