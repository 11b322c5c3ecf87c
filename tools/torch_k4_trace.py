#!/usr/bin/env python3
"""Where K4's ct_f0 leaves float64: trace the whole solve's reverse walk.

    python3 tools/torch_k4_trace.py [--tol 1e-5] [--no-mlp]

Needs one CUDA device (the kernels are built as ``chip_smoke.py`` builds
them). Two parts:

* ``chip_smoke.py`` phase 11's solve (AlternatingMLP 256x20x50x4, the 49
  saves, rtol=atol=``--tol``, phase 11's 1e-5 or 1.4e-8), seeded with a
  cotangent of y1 alone. Four reverse
  walks over K3's record: K4, its float32 plain version, the plain walk
  with K8 (the kernel's trial-step pullback) in place of the plain one, and
  a float64 plain walk. It prints each walk's distance from the others on
  the time scalars, ct_y0, ct_f0 and the leaves; then, per trial step of
  the two float32 plain walks, the cotangents the scalar chain's pullback
  takes (those of t and dt from the later steps), the error estimate's
  cotangent it gives (c_err), and the trial step's own cotangent of dt_eff.
* ``tests/test_torch_kernels_cuda.py``'s MLPDynamics solve at 1040x64x32,
  rtol=atol=1e-4, with the weights at LeCun's scale and at three times it:
  the same four walks' distances, with the cotangent of y1 alone and with
  the telemetry's too (left out with ``--no-mlp``).
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _groups(g):
    import torch

    return {"time": torch.stack(g[:3]), "ct_y0": g[3], "ct_f0": g[4],
            "leaves": torch.cat([x.flatten() for x in g[6:]])}


def _walks(tag, rec, ns, ct_y1, ct_tel, t0, t1, leaves, tol, ctrl, dynamics, saveat=None,
           ct_ys=None, trace=False):
    """K4 (k), its plain version (p), the plain walk over the kernel's
    trial-step pullback (pK) and a float64 plain walk (f64) over ``rec``."""
    import torch

    from chip_smoke import _rel
    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import fused_mlp as fm
    from regneuralde_tpu_torch.ops import whole_solve as ws

    d = lambda x: x.double()
    plain_steps, post_bwd = ws.plain_steps, ws.post_bwd
    kernel_bwd = {"altmlp": fg.altmlp_normed_sweep_bwd, "mlp": fm.normed_sweep_bwd}[dynamics]
    bkw = dict(dynamics=dynamics, saveat=saveat, ct_ys=ct_ys)
    logs = {}

    def walk(name, body=None):
        log = logs.setdefault(name, [])

        def steps(dyn, rtol, atol):
            sweep, plain_bwd = plain_steps(dyn, rtol, atol)

            def bwd(t, dt, y, k1, lv, cts):
                out = (plain_bwd(t, dt, y, k1, lv, cts) if body is None
                       else body(t, dt, y, k1, lv, cts, rtol, atol))
                log[-1].update(c_err=float(cts[2]), body_ct_dt=float(out[1]))
                return out
            return sweep, bwd

        def spy_post_bwd(*args):
            c_tnew, c_dtn = args[-1][:2]
            log.append(dict(ct_t_in=float(c_tnew), ct_dt_in=float(c_dtn)))
            return post_bwd(*args)

        ws.plain_steps, ws.post_bwd = steps, spy_post_bwd
        try:
            return ws.plain_whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol,
                                            ctrl, **bkw)
        finally:
            ws.plain_steps, ws.post_bwd = plain_steps, post_bwd

    g = {"k": ws.whole_solve_bwd(rec, ns, ct_y1, ct_tel, t0, t1, leaves, tol, tol, ctrl,
                                 **bkw),
         "p": walk("p"), "pK": walk("pK", kernel_bwd),
         "f64": ws.plain_whole_solve_bwd(
             ws.SolveRecord(*map(d, rec)), ns, d(ct_y1), d(ct_tel), d(t0), d(t1),
             [d(x) for x in leaves], tol, tol, ctrl, dynamics=dynamics,
             saveat=None if saveat is None else d(saveat),
             ct_ys=None if ct_ys is None else d(ct_ys))}
    G = {k: _groups(v) for k, v in g.items()}
    pairs = (("k", "p"), ("k", "f64"), ("p", "f64"), ("pK", "p"), ("pK", "f64"))
    out = {n: {f"{a}~{b}": _rel(G[a][n], G[b][n]) for a, b in pairs} for n in G["k"]}
    print(f"[{tag}] rel err between the walks " + json.dumps(out))
    if trace:
        for j, (p, pk) in enumerate(zip(logs["p"], logs["pK"])):
            print(f"[{tag}] step {ns - 1 - j}: plain {json.dumps(p)}; with K8 {json.dumps(pk)}")


def altmlp_walks(device, tol):
    import torch

    import chip_smoke as cs
    from regneuralde_tpu_torch.ops import fused_generic as fg
    from regneuralde_tpu_torch.ops import ode
    from regneuralde_tpu_torch.ops import whole_solve as ws
    from regneuralde_tpu_torch.ops.controller import PIController

    gen = torch.Generator().manual_seed(cs.SEED + 4)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to(device)
    B, D, H, depth = 256, 20, 50, 4
    leaves = []
    for _ in range(depth):
        leaves += [rnd(H, D, scale=D ** -0.5), rnd(H, scale=0.1), rnd(D, H, scale=H ** -0.5),
                   rnd(D, scale=0.1)]
    y0 = rnd(B, D, scale=0.8)
    _, saveat = cs.latent_batches(1, device)
    ctrl = PIController.for_order(5)
    func = fg.alternating_mlp_apply(depth)
    t0, t1, f0, dt0 = ode.solve_prologue(func, y0, 0.0, 1.0, tuple(leaves), tol, tol)
    sa, ys_init = ode.saveat_rows(saveat, t0, t1, y0)
    rec = ws.whole_solve_fwd(t0, t1, dt0, y0, f0, leaves, tol, tol, ctrl, cs.LATENT_MAX_STEPS,
                             dynamics="altmlp", saveat=sa, ys_init=ys_init)
    ns = int(rec.final[3:5].sum().item())
    cgen = torch.Generator().manual_seed(cs.SEED + 5)
    ct_y1 = torch.randn(B, D, generator=cgen).to(device)
    tel = torch.zeros(4, cs.LATENT_MAX_STEPS, device=device)
    _walks(f"altmlp 256x20x50x4 tol {tol:g}, cotangent of y1", rec, ns, ct_y1, tel, t0, t1,
           leaves, tol, ctrl, "altmlp", sa, torch.zeros_like(rec.ys), trace=True)


def mlp_walks(device):
    import importlib.util

    from regneuralde_tpu_torch.ops import whole_solve as ws

    spec = importlib.util.spec_from_file_location(
        "kernel_tests", ROOT / "tests" / "test_torch_kernels_cuda.py")
    kt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kt)
    for scale in (1.0, 3.0):
        args = kt._solve_args(1040, 64, 32, device, scale=scale)
        rec = ws.whole_solve_fwd(*args)
        ns = int(rec.final[3:5].sum().item())
        eest = ", ".join(f"{e:.1e}" for e in rec.streams[ws.TEL_EEST, :ns].tolist())
        print(f"[mlp 1040x64x32 weights x{scale:g}] eest per step: {eest}")
        ct_y1, ct_tel = kt._bwd_seeds(1040, 64, device)
        for seeds, tel in (("y1", ct_tel * 0), ("y1+telemetry", ct_tel)):
            _walks(f"mlp 1040x64x32 weights x{scale:g}, cotangent of {seeds}", rec, ns, ct_y1,
                   tel, args[0], args[1], args[5], 1e-4, args[8], "mlp")


def main():
    import argparse
    import subprocess

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--tol", type=float, default=1e-5, help="the AlternatingMLP solve's rtol=atol")
    ap.add_argument("--no-mlp", action="store_true", help="leave out the MLPDynamics part")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("torch_k4_trace: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    device = torch.device("cuda", 0)
    altmlp_walks(device, args.tol)
    if not args.no_mlp:
        mlp_walks(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
