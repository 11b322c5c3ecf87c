#!/usr/bin/env python3
"""Size K14, the tuple Tsit5 step's backward (``regneuralde_tpu_torch/csrc/
mlp_step_walk.cuh`` with the tuple's seeds, the kernel K2 runs with the
normed seeds), on one GPU: its device time with parts of the launch taken
out, against K3's trial step and K4's replay, at 512 x 784 x 100.

    python3 tools/torch_k14_variants.py [--variants shipped,noreplay,...]

Each variant is the source with the substitutions of ``VARIANTS`` made in
``mlp_step_walk.cuh``, compiled by ``nvcc`` (as ``ops/_cuda.py`` compiles,
``-Xptxas -v``) with ``weight_cotangents.cu`` into a library of its own under
``build/k14_variants/``; it prints what ``ptxas`` reported for the kernel.
Every variant but ``shipped`` is wrong by design: it shows what the part it
leaves out costs (in K2's instantiation as in K14's). On chip_smoke.py
phase 25's seeded inputs (dt 0.05) it prints the device time of K14's
``mlp_step_walk_kernel`` a launch under each
variant's library (``torch.profiler``, through the package's wrapper) and
the largest relative distance of its outputs from the plain version. Then,
on the flagship's solve at 1.4e-8 (``tools/torch_kernel_ab.py``'s), the
device time a trial step of K3 (``mlp_solve_kernel``) and of K4's walk on
the stage residuals' stream and replaying them (``cache_residuals=False``),
whose difference is what the replay costs inside the walk's kernel.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import torch_variants as tv  # noqa: E402

OUT = ROOT / "build" / "k14_variants"
_REPLAY = "  walk_replay(a, w, grid, ws.yi, ws.fi, ws.tm, walk_pool);\n  grid.sync();\n"
_REVERSE = [(f"    walk_stage<{i}>(args.wa, grid, ws, s, tl, part);\n", "")
            for i in range(6, 0, -1)]
_PADS = ("  walk_pad_weights(m.W1, m.W2, w, a.D, H, s.HPP);\n"
         "  solve_pad_weights(m.W1, m.W2, w.f, a.D, H, walk_round_up(H, kWalkTN));\n")
# name -> substitutions in mlp_step_walk.cuh (each must occur in it)
VARIANTS = {
    "shipped": [],
    # the reverse on whatever the one-step scratch holds: the replay's cost
    "noreplay": [(_REPLAY, "")],
    # the replay, the seed phase and the final pass: the reverse's cost
    "noreverse": _REVERSE,
    # the weights not padded (the slabs read stale scratch): the pads' cost
    "nopads": [(_PADS, "")],
    # the launch, the pads, the seed phase, the final pass and the slot sum
    "bare": [(_REPLAY, "")] + _REVERSE,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="shipped,noreplay,noreverse,nopads,bare")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    B, D, H = cs.BATCH, cs.DIM, cs.HIDDEN
    libs = tv.build("mlp_step_walk.cuh", VARIANTS, args.variants.split(","), "", OUT,
                    ("mlp_step_walk",))

    # phase 25's inputs (chip_smoke.phase_tuple_kernels)
    gen = torch.Generator().manual_seed(cs.SEED + 41)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    leaves = [rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1),
              rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)]
    y, k1 = rnd(B, D, scale=0.5), rnd(B, D, scale=0.3)
    cts = [rnd(B, D) for _ in range(5)]
    t, dt = torch.tensor(0.3, device=dev), torch.tensor(0.05, device=dev)
    bwd = lambda: fm.stage_sweep_bwd(t, dt, y, k1, leaves, cts)
    flat = lambda g: [*g[:4], *g[4]]
    want = flat(fm._bwd_math(t, dt, y, k1, fm._split_params(*leaves), cts))
    for name, lib in libs.items():
        with tv.forced(lib=lib):
            ms = cs._device_ms(bwd, "mlp_step_walk_kernel")
            err = max(cs._rel(a, b) for a, b in zip(flat(bwd()), want))
        print(f"[k14-variants] {name}: mlp_step_walk_kernel device ms a launch {ms!r}; "
              f"largest relative distance of an output from the plain version {err!r}")

    # K3 and K4's walk a trial step on the flagship's solve
    gen = torch.Generator().manual_seed(cs.SEED + 2)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    leaves = [rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1),
              rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)]
    y0 = torch.rand(B, D, generator=gen).to(dev)
    parts = fm._split_params(*leaves)
    func = lambda tt, x, _: fm._mlp_k(x, tt, parts)[0]
    tol, ctrl = cs.FLAGSHIP_TOL, PIController.for_order(5)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, (), tol, tol)
    fwd_args = (t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl, cs.MAX_STEPS)
    rec = ws.whole_solve_fwd(*fwd_args)
    ns = int(rec.final[3:5].sum().item())
    ct_y1 = torch.randn(B, D, generator=gen).to(dev)
    ct_tel = torch.zeros(4, cs.MAX_STEPS, device=dev)
    k3 = cs._device_ms(lambda: ws.whole_solve_fwd(*fwd_args), "mlp_solve_kernel")
    walk = {}
    for replay in (False, True):
        walk[replay] = cs._device_ms(
            lambda: ws.whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl,
                                       cache_residuals=not replay), "mlp_walk_kernel")
    print(f"[k14-variants] flagship solve, {ns} trial steps: device us a trial step: K3 "
          f"{1e3 * k3 / ns!r}; K4's walk streamed {1e3 * walk[False] / ns!r}, replaying "
          f"{1e3 * walk[True] / ns!r}, the replay in the walk "
          f"{1e3 * (walk[True] - walk[False]) / ns!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
