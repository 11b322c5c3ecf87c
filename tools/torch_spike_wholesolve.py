#!/usr/bin/env python3
"""K15 on the card: the port of ``tools/spike_wholesolve.py``.

    python3 tools/torch_spike_wholesolve.py

Runs the whole-solve feature probe (``regneuralde_tpu_torch.ops.
spike_wholesolve``: an in-kernel while loop, dynamic scalar stores, a bulk
copy of each history row, a hand-written tanh vjp) from ``t0 = 0`` on a
seeded ``(32, 20)`` float32 state, prints what the JAX spike prints, and
holds the kernel against its plain version: ``y1`` and ``tel`` within
``TOL``, the history rows ``< n`` bitwise (they are copies). Exits non-zero
without a CUDA device or on any failed check.

``y0`` is the port's own draw (``torch.randn`` from a seeded
``torch.Generator``), not the JAX spike's ``PRNGKey(0)`` draw, so the values
on the ``y1`` line differ from the JAX spike's; the line says so.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TOL = 1e-6


def run(device, t0=0.0, seed=0):
    """Runs K15 (or, for ``device="cpu"``, its plain version) and checks it
    against the plain version; returns ``(ok, lines)``."""
    import torch

    from regneuralde_tpu_torch.ops import spike_wholesolve as sp

    gen = torch.Generator().manual_seed(seed)
    y0 = torch.randn((sp.B, sp.D), generator=gen).to(device)
    y1, tel, hy, n = sp.spike_wholesolve(t0, y0)
    py1, ptel, phy, pn = sp.plain_spike_wholesolve(t0, y0)
    y1, tel, hy = (x.cpu().numpy() for x in (y1, tel, hy))
    lines = [f"y1 {y1[0, :3]} tel {tel.ravel()[:6]} "
             f"(y0: the port's torch.Generator seed {seed} draw, not JAX's PRNGKey(0))",
             f"hy row0 == y0: {bool((hy[0] == y0.cpu().numpy()).all())}",
             f"hy row1 finite: {bool(torch.isfinite(torch.from_numpy(hy[1])).all())}"]
    err_y = float(abs(y1 - py1.cpu().numpy()).max())
    err_t = float(abs(tel - ptel.cpu().numpy()).max())
    rows = bool((hy[:n] == phy[:pn].cpu().numpy()).all()) if n == pn else False
    lines.append(f"n kernel={n} plain={pn}; max abs err y1 {err_y!r} tel {err_t!r}; "
                 f"history rows < n bitwise: {rows}")
    ok = n == pn and err_y <= TOL and err_t <= TOL and rows
    return ok, lines


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_spike_wholesolve: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    ok, lines = run("cuda")
    for line in lines:
        print(line)
    if not ok:
        print("SPIKE FAILED: the kernel disagrees with its plain version", file=sys.stderr)
        return 1
    print(f"SPIKE OK on cuda ({torch.cuda.get_device_name(0)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
