#!/usr/bin/env python3
"""ct_f0 of ``chip_smoke.py`` phase 5's solve in float32 reverse walks that
differ only in their order of summation.

    python3 tools/torch_f0_orders.py [--device cpu|cuda] [--seeds N] [--telemetry]

Phase 5's seeded leaves and y0 (512x784x100, rtol=atol=1e-4), the solve's
record (the plain forward's on the CPU, K3's on a CUDA device), then for
each of ``--seeds`` cotangents of y1 (with ``--telemetry`` of the
telemetry too) the reverse walks over that one record: the plain float32
walk (``fused_mlp._normed_bwd_math`` a trial step), the float32 walk in
K4's own order of summation (``whole_solve.plain_walk_step`` on
``walk_plan``'s tiles, then the plain weight-cotangent contraction), K4
itself on a CUDA device, and the float64 plain walk. It prints the error
estimate of each trial step and each float32 walk's distance from float64
(relative Frobenius) on the time scalars, ct_y0, ct_f0 and cW1.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--telemetry", action="store_true")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import weight_cotangents as wc
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    dev = torch.device(args.device)
    B, D, H, tol, S = cs.BATCH, cs.DIM, cs.HIDDEN, 1e-4, cs.MAX_STEPS
    gen = torch.Generator().manual_seed(cs.SEED + 2)  # phase 5's draws
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(dev)
    leaves = [rnd(H, D + 1, scale=(D + 1) ** -0.5), rnd(H, scale=0.1),
              rnd(D, H + 1, scale=(H + 1) ** -0.5), rnd(D, scale=0.1)]
    y0 = torch.rand(B, D, generator=gen).to(dev)
    parts = fm._split_params(*leaves)
    func = lambda t, y, _: fm._mlp_k(y, t, parts)[0]
    ctrl = PIController.for_order(5)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, (), tol, tol)
    rec = ws.whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl, S)
    ns = int(rec.final[3:5].sum().item())
    print(f"[f0] {args.device}: {ns} trial steps, eest "
          f"{rec.streams[ws.TEL_EEST, :ns].tolist()}")
    plan = ws.walk_plan(B, D, H, 132)
    plain_step = fm._normed_bwd_math

    def walk_order(t, dt, y, k1, p, cts, rtol, atol, res=None):
        w1x, w1t, b1, w2h, w2t, b2 = p
        lv = (torch.cat([w1x, w1t[:, None]], 1), b1, torch.cat([w2h, w2t[:, None]], 1), b2)
        *head, rows = ws.plain_walk_step(t, dt, y, k1, lv, cts, rtol, atol,
                                         (res[0][1:], res[1]), plan)
        return (*head, wc.weight_cotangents_plain(*rows))

    d = lambda x: x.double()
    rec64 = ws.SolveRecord(*map(d, rec))
    groups = lambda g: {"time": torch.stack(g[:3]), "ct_y0": g[3], "ct_f0": g[4], "cW1": g[6]}
    for seed in range(args.seeds):
        g2 = torch.Generator().manual_seed(100 + seed)
        ct_y1 = torch.randn(B, D, generator=g2).to(dev)
        tel = torch.zeros(4, S, device=dev)
        if args.telemetry:
            tel = (torch.randn(4, S, generator=g2) * 0.1).to(dev)
        rest = (ns, ct_y1, tel, t0, t1, leaves, tol, tol, ctrl)
        walks = {"plain": ws.plain_whole_solve_bwd(rec, *rest)}
        fm._normed_bwd_math = walk_order
        try:
            walks["walk_order"] = ws.plain_whole_solve_bwd(rec, *rest)
        finally:
            fm._normed_bwd_math = plain_step
        if dev.type == "cuda":
            walks["K4"] = ws.whole_solve_bwd(rec, *rest)
        g64 = groups(ws.plain_whole_solve_bwd(rec64, ns, d(ct_y1), d(tel), d(t0), d(t1),
                                              [d(x) for x in leaves], tol, tol, ctrl))
        for name, g in walks.items():
            dist = {k: cs._rel(v, g64[k]) for k, v in groups(g).items()}
            print(f"[f0] seed {seed} {name} vs float64: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in dist.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
