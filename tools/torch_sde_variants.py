#!/usr/bin/env python3
"""K9 and K10, the SDE whole solve's forward and reverse walk, in variants of
``csrc/sde_whole_solve.cu`` and its tile bodies (``sri_mlp.cuh``,
``sri_cubic.cuh``): each built from ``sde_whole_solve.cu`` alone into a
library of its own, swapped in under the package's wrappers, and timed at
phase 19's inputs (the MNIST NSDE pair, 512 x 32, drift 32 -> 64 -> 32,
diffusion 32 -> 32, SOSRI2; at 1.4e-1 and at 1.4e-2 with 5 saves) and
phase 29's (the cubic pair, 100 x 2, drift 2 -> 50 -> 2 after the cube,
SOSRI, 30 saves; at 3e-1 and 3e-2): device ms a solve of
``sde_whole_solve_fwd_kernel``, of ``sde_whole_solve_bwd_kernel`` and of
its ``sum_slots_kernel`` under ``torch.profiler``, and a trial step's; what
``ptxas`` reported (registers, stack, spills); a hash of each kernel's
outputs on those inputs (equal hashes: the same bits); whether K9 takes
the plain version's steps; and, where the package has it
(``sw.plain_sde_bwd_tiles``), whether K10's outputs are its schedule's
bitwise.

    python3 tools/torch_sde_variants.py [--variants shipped,chain16,chain16,shipped]
                                        [--parent DIR] [--reps N]

``--parent DIR`` adds the variant ``parent``: ``DIR``'s
``regneuralde_tpu_torch/csrc`` built as it is (an unpacked checkout of
another commit whose C entries take the same arguments). Variants of the
shipped source: ``chain4``, ``chain16`` (at most 4 or 16 terms a lane's
share of an f64 sum, not 8: more or fewer lanes a sum); ``generic`` (no
pair's widths compiled as constants); ``t128`` (128 threads a block);
``split`` (a barrier between a stage's drift and diffusion layers: each its
own phase); ``lb0`` (no bound of one block an SM, so ``ptxas`` keeps to 128
registers). A name given twice is timed twice, so ``shipped,chain16,chain16,shipped`` is an A B B A in one
process; ``a+b`` makes both variants' changes. Needs one GPU and ``nvcc``.
"""

import argparse
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "regneuralde_tpu_torch" / "csrc"

# (file, text, replacement) substitutions of each variant; each text must
# occur in its file
VARIANTS = {
    "shipped": [],
    "chain4": [("sri_mlp.cuh", "constexpr int kSdeChain = 8;", "constexpr int kSdeChain = 4;")],
    "chain16": [("sri_mlp.cuh", "constexpr int kSdeChain = 8;", "constexpr int kSdeChain = 16;")],
    "generic": [("sde_whole_solve.cu", "  return D == F::kD", "  return false && D == F::kD")],
    "t128": [("normed_tsit5.cuh", "constexpr int kThreads = 256;",
              "constexpr int kThreads = 128;")],
    "split": [("sde_whole_solve.cu", "      if (p < ng)\n", "      __syncthreads();\n      if (p < ng)\n"),
              ("sde_whole_solve.cu", "      if (rg)\n", "      __syncthreads();\n      if (rg)\n")],
    "lb0": [("sde_whole_solve.cu", "__launch_bounds__(kThreads, 1) sde_whole_solve_fwd_kernel",
             "__launch_bounds__(kThreads) sde_whole_solve_fwd_kernel"),
            ("sde_whole_solve.cu", "__launch_bounds__(kThreads, 1) sde_whole_solve_bwd_kernel",
             "__launch_bounds__(kThreads) sde_whole_solve_bwd_kernel")],
}
KERNELS = ("sde_whole_solve_fwd_kernel", "sde_whole_solve_bwd_kernel", "sum_slots_kernel")


def build(names, out, parent=None):
    """One library a variant, compiled as ``ops/_cuda.py`` compiles
    ``sde_whole_solve.cu`` (``-fmad=false``), all at once; returns the
    libraries with the package's signatures bound and prints ``ptxas``'s
    registers, stack and spills of K9 and K10."""
    from regneuralde_tpu_torch.ops import _cuda

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    procs = {}
    for name in dict.fromkeys(names):
        src = out / name
        if src.exists():
            shutil.rmtree(src)
        base = (Path(parent) / "regneuralde_tpu_torch" / "csrc") if name == "parent" else CSRC
        shutil.copytree(base, src)
        if name != "parent":
            for part in name.split("+"):
                for fname, a, b in VARIANTS[part]:
                    text = (src / fname).read_text()
                    if a not in text:
                        raise SystemExit(f"variant {part}: {a!r} is not in {fname}")
                    (src / fname).write_text(text.replace(a, b))
        procs[name] = subprocess.Popen(
            [nvcc, *_cuda._FLAGS, "-fmad=false", "-shared", "-Xptxas", "-v", "-o",
             str(out / f"{name}.so"), str(src / "sde_whole_solve.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"[build] nvcc failed on {name}:\n{err[-6000:]}")
            continue
        kernel = None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = m.group(1)
            elif kernel and "sde_whole_solve" in kernel and (
                    "registers" in line or "stack" in line or "spill" in line):
                kind = "cubic" if "Cubic" in kernel else "mlp"
                tag = "K9" if "fwd" in kernel else "K10"
                inst = " fixed" if "Fixed" in kernel else ""
                print(f"[ptxas] {name} {tag} {kind}{inst}: {line.split(':', 1)[-1].strip()}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        for fn, argtypes in _cuda._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def nsde_cases(dev):
    """Phase 19's inputs (``chip_smoke.phase_sde_kernels``): the forward's
    arguments and keywords and the backward's seeds, at both tolerances."""
    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import sde as sde_ops
    from regneuralde_tpu_torch.ops.controller import PIController

    gen = torch.Generator().manual_seed(cs.SEED + 21)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    B, D, H = cs.NSDE_BATCH, cs.NSDE_DIM, cs.NSDE_HIDDEN
    leaves = [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1), rnd(D, H, scale=H ** -0.5),
              rnd(D, scale=0.1), rnd(D, D, scale=D ** -0.5), rnd(D, scale=0.1)]
    y0 = rnd(B, D, scale=0.5)
    ctrl = PIController(beta1=0.5, beta2=0.0)
    t0, t1 = torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev)
    dt0 = torch.tensor(0.01, device=dev)
    cases = []
    for tol, S, sa in ((cs.NSDE_TOL, cs.NSDE_MAX_STEPS, None),
                       (cs.NSDE_TIGHT_TOL, 256, [0.0, 0.25, 0.5, 0.75, 1.0])):
        xi = sde_ops.presample_noise(torch.Generator(device=dev).manual_seed(cs.SEED + 22),
                                     (B, D), S)
        kw = dict(n_drift=2, solver="sosri2")
        if sa is not None:
            sat, ys_init = sde_ops.save_rows_at_start(torch.tensor(sa, device=dev), t0, y0)
            kw.update(saveat=sat, ys_init=ys_init)
        g = torch.Generator().manual_seed(7)
        seeds = (torch.randn(B, D, generator=g).to(dev),
                 (0.1 * torch.randn(4, S, generator=g)).to(dev),
                 None if sa is None else torch.randn(len(sa), B, D, generator=g).to(dev))
        cases.append((f"mlp tol={tol:g}", (t0, t1, dt0, y0, leaves, tol, tol, ctrl, S, *xi),
                      kw, seeds))
    return cases


def cubic_cases(dev):
    """Phase 29's inputs (``chip_smoke.phase_sde_cubic_kernels``)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import sde as sde_ops
    from regneuralde_tpu_torch.ops.controller import PIController
    from regneuralde_tpu_torch.training import sde_toy as st

    S = st.MAX_STEPS
    leaves, y0, xi = cs._toy_inputs(dev, S, torch.Generator().manual_seed(cs.SEED + 47), 2.0)
    B, D = 100, 2
    ctrl = PIController(beta1=0.5, beta2=0.0)
    t0, t1 = torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev)
    dt0 = torch.tensor(0.01, device=dev)
    sa = torch.tensor(np.linspace(0.0, 1.0, 30).astype(np.float32), device=dev)
    sat, ys_init = sde_ops.save_rows_at_start(sa, t0, y0)
    kw = dict(n_drift=2, solver="sosri", saveat=sat, ys_init=ys_init, body="cubic")
    cases = []
    for tol in (st.TOL, cs.TOY_TIGHT_TOL):
        g = torch.Generator().manual_seed(cs.SEED + 48)
        seeds = (torch.randn(B, D, generator=g).to(dev),
                 (0.1 * torch.randn(4, S, generator=g)).to(dev),
                 torch.randn(len(sa), B, D, generator=g).to(dev))
        cases.append((f"cubic tol={tol:g}", (t0, t1, dt0, y0, leaves, tol, tol, ctrl, S, *xi),
                      kw, seeds))
    return cases


def device_ms(fn, reps):
    """Device ms a call of fn of each of KERNELS under torch.profiler over
    reps calls (after one warm-up call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for k in KERNELS:
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and k in e.key and e.count]
        n = sum(e.count for e in hits)
        if n:
            out[k] = sum(e.self_device_time_total for e in hits) / 1e3 / n
    return out


def digest(xs):
    h = hashlib.sha256()
    for x in xs:
        if x is not None and x.numel():
            h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def run_case(case, reps, check):
    """K9 and K10 on one case under the current library: device ms, hashes,
    the checks against the plain forward and (where check) K10's against
    its schedule."""
    import torch

    from regneuralde_tpu_torch.ops import sde_whole_solve as sw

    tag, args, kw, (ct_y1, ct_tel, ct_ys) = case
    rk = sw.sde_whole_solve_fwd(*args, **kw)
    ns = int(rk.final[3:5].sum().item())
    rp = sw.plain_sde_whole_solve_fwd(*args, **kw)
    same_steps = (rk.final[3:].tolist() == rp.final[3:].tolist()
                  and torch.equal(rk.streams[sw.ST_ACC], rp.streams[sw.ST_ACC]))
    t0, t1, _, _, leaves, rtol, atol, ctrl = args[:8]
    bkw = {k: v for k, v in kw.items() if k != "ys_init"}
    bargs = (ns, ct_y1, ct_tel, t0, t1, leaves, rtol, atol, ctrl, *args[9:])
    gk = sw.sde_whole_solve_bwd(rk, *bargs, ct_ys=ct_ys, **bkw)
    res = {"ns": ns, "same_steps_as_plain": same_steps,
           "k9_hash": digest([rk.y1, rk.ys, rk.hy[:ns + 1], rk.hw[:ns + 1], rk.hz[:ns + 1],
                              rk.streams, rk.final, rk.cursors]),
           "k9_bitwise_plain": all(torch.equal(a, b) for a, b in (
               (rk.y1, rp.y1), (rk.ys, rp.ys), (rk.hy[:ns + 1], rp.hy[:ns + 1]),
               (rk.hw[:ns + 1], rp.hw[:ns + 1]), (rk.hz[:ns + 1], rp.hz[:ns + 1]))),
           "k10_hash": digest(gk)}
    if not res["k9_bitwise_plain"]:
        # the first trial step whose stored rows differ, and how many elements
        diff = [(j, int((rk.hy[j] != rp.hy[j]).sum()), int((rk.hw[j] != rp.hw[j]).sum()))
                for j in range(ns + 1) if not (torch.equal(rk.hy[j], rp.hy[j])
                                               and torch.equal(rk.hw[j], rp.hw[j]))]
        res["k9_rows_differ_from"] = diff[:3]
    if check and hasattr(sw, "plain_sde_bwd_tiles"):
        gs = sw.plain_sde_bwd_tiles(rk, *bargs, ct_ys=ct_ys, **bkw)
        res["k10_bitwise_schedule"] = all(torch.equal(a, b) for a, b in zip(gk, gs))
        res["k10_max_abs_schedule"] = [float((a - b).abs().max()) for a, b in zip(gk, gs)
                                       if b.numel()]
    fwd = device_ms(lambda: sw.sde_whole_solve_fwd(*args, **kw), reps)
    bwd = device_ms(lambda: sw.sde_whole_solve_bwd(rk, *bargs, ct_ys=ct_ys, **bkw), reps)
    res["K9_ms"] = fwd.get(KERNELS[0])
    res["K10_ms"] = bwd.get(KERNELS[1])
    res["K10_slot_sum_ms"] = bwd.get(KERNELS[2])
    for k in ("K9", "K10"):
        if res[f"{k}_ms"] is not None:
            res[f"{k}_us_a_trial_step"] = 1e3 * res[f"{k}_ms"] / max(ns, 1)
    return tag, res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="shipped")
    ap.add_argument("--parent", default=None, help="an unpacked checkout of another commit")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default=str(ROOT / "build" / "sde_variants"))
    ap.add_argument("--cases", default="mlp,cubic")
    args = ap.parse_args()
    import torch

    from regneuralde_tpu_torch.ops import _cuda
    from regneuralde_tpu_torch.ops import sde_whole_solve as sw

    names = args.variants.split(",")
    if "parent" in names and not args.parent:
        raise SystemExit("the variant parent needs --parent DIR")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    libs = build(names, out, args.parent)
    dev = torch.device("cuda", 0)
    name_limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"[card] {torch.cuda.get_device_name(0)}; {name_limit}")
    cases = []
    if "mlp" in args.cases:
        cases += nsde_cases(dev)
    if "cubic" in args.cases:
        cases += cubic_cases(dev)
    check_plan = getattr(sw, "check_sde_plan", None)
    for name in names:
        if name not in libs:
            continue
        _cuda._lib = libs[name]
        if check_plan is not None:
            # the plan's sizes are the shipped source's; a variant's (and the
            # parent's, which has no plan getters) are its own
            sw.check_sde_plan = check_plan if name == "shipped" else (lambda *a, **k: None)
        for case in cases:
            tag, res = run_case(case, args.reps, name == "shipped")
            print(f"[variant] {name} {tag} " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
