#!/usr/bin/env python3
"""Phase 16's K4-CSL readings, every check of it recorded instead of raised,
on this tree and on copies of it with one planted fault each in the CSL
reverse (``csrc/csl_tsit5.cuh``): the readings that ``chip_smoke.py``'s
``CSL_TEL_BWD_BOUND`` lies between.

    python3 tools/torch_csl_fault_probe.py [--tols 1e-3,1e-2,1e-1]
                                           [--faults no_ynew_max,no_err_dt]
                                           [--seeds 0,1,2]

Needs one GPU and ``nvcc``. The copies are made in a temporary directory and
removed at the end; their kernels are built there, all at once. The faults:
``no_err_dt`` drops the error norm's share of ct_dt, ``no_ynew_max`` the
y_new side of the norm's max(|y|, |y_new|), ``no_gate_t`` the gates'
dependence on the stage time, ``no_stage_dt`` the stage time's share of
ct_dt. For each tree it prints the lines of phase 16's K4 comparison and
the checks that failed. ``--tols`` runs phase 16 at these tolerances
instead of ``chip_smoke.CSL_K4_CASES``' (with no limit on K4 against its
plain version; those of 1e-3 and above also with the eest telemetry's
cotangent alone seeded), ``--faults`` plants only these faults, ``--seeds``
reruns phase 16 in each tree once a seed (``chip_smoke.SEED`` moved by
1000 x the seed: other weights, probes and cotangents; 0 is the script's
own draw).
"""
import argparse, shutil, subprocess, sys, tempfile
from pathlib import Path

MUTANTS = {
    "sound": None,
    "no_err_dt": ("    ct_dt += cerr * s_comb;\n  }\n  return ct_dt;", "  }\n  return ct_dt;"),
    "no_ynew_max": ("seed6[idx] = cyn + d_ynew + to_yn * sign_of(yn);",
                    "seed6[idx] = cyn + d_ynew;"),
    "no_gate_t": ("ct_ti += co * L.wb[o] + dg * L.wg[o];", "ct_ti += co * L.wb[o];"),
    "no_stage_dt": ("    ct_dt += kC[i] * ct_ti;\n", ""),
}
RUN = r'''
import sys, io, contextlib
sys.path.insert(0, ".")
import torch, chip_smoke as cs
fails = []
cs._check = lambda ok, msg: ok or fails.append(msg)
cs._time_ms = lambda fn: 0.0
if TOLS:
    cs.CSL_K4_CASES = {t: float("inf") for t in TOLS}
cs._device_ms = lambda *a, **k: None
dev = torch.device("cuda", 0)
seed0 = cs.SEED
for seed in SEEDS:
    cs.SEED = seed0 + 1000 * seed
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cs.phase_whole_solve_csl_kernels(dev, cs.ffjord_batches(1, dev)[0])
    for line in buf.getvalue().splitlines():
        if "K4 cotangents" in line or "(naccept" in line or "max abs" in line:
            print(f"[seed {seed}] " + line[:1400])
    print(f"[seed {seed}] FAILED CHECKS:", fails)
    fails.clear()
'''
BUILD = ("import sys; sys.path.insert(0, '.'); from regneuralde_tpu_torch.ops import _cuda; "
         "_cuda.library()")
ap = argparse.ArgumentParser()
ap.add_argument("--tols", default="")
ap.add_argument("--faults", default="")
ap.add_argument("--seeds", default="0")
cli = ap.parse_args()
tols = [float(t) for t in cli.tols.split(",") if t]
seeds = [int(x) for x in cli.seeds.split(",") if x]
RUN = f"TOLS = {tols!r}\nSEEDS = {seeds!r}\n" + RUN
if cli.faults:
    keep = set(cli.faults.split(","))
    MUTANTS = {n: m for n, m in MUTANTS.items() if m is None or n in keep}
root = Path(".").resolve()
tmp = Path(tempfile.mkdtemp())
trees = {}
for name, mut in MUTANTS.items():
    if mut is None:
        trees[name] = root
        continue
    d = tmp / name
    shutil.copytree(root, d, ignore=shutil.ignore_patterns("build", "chiprun_out", ".git"))
    f = d / "regneuralde_tpu_torch/csrc/csl_tsit5.cuh"
    s = f.read_text()
    assert s.count(mut[0]) == 1, name
    f.write_text(s.replace(mut[0], mut[1]))
    trees[name] = d
procs = {n: subprocess.Popen([sys.executable, "-c", BUILD], cwd=d, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for n, d in trees.items()}
for n, p in procs.items():
    out, _ = p.communicate()
    print(f"[build] {n} rc={p.returncode} {out[-2000:] if p.returncode else ''}", flush=True)
for n, d in trees.items():
    out = subprocess.run([sys.executable, "-c", RUN], cwd=d, capture_output=True, text=True)
    print(f"===== {n} rc={out.returncode}\n{out.stdout}{out.stderr[-3000:]}", flush=True)
shutil.rmtree(tmp)
