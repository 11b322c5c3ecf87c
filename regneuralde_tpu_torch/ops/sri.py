"""Stochastic Runge-Kutta (SRI) methods for diagonal-noise Itô SDEs.

Counterpart of ``regneuralde_tpu/ops/sri.py``: the generic tableau-driven
SRI trial step (Rößler 2010's class) with the natural-embedding error
estimate, the static stage analysis that elides unused and duplicate
stages (so the NFE accounting is exact), the deterministic stability
interval, and the three tableaus SRIW1, SOSRI-TPU and SOSRI2-TPU, copied
constant for constant. One trial step, for stages i = 1..s:

    H0_i = y + sum_j A0_ij dt f_j + sum_j B0_ij (I10/dt) g_j
    H1_i = y + sum_j A1_ij dt f_j + sum_j B1_ij sqrt(dt) g_j
    f_i  = f(t + c0_i dt, H0_i);  g_i = g(t + c1_i dt, H1_i)
    y1   = y + sum_i alpha_i dt f_i
             + sum_i (beta1_i I1 + beta2_i I11/sqrt(dt) + beta3_i I10/dt
                      + beta4_i I111/dt) g_i
    E    = delta dt sum_i e_drift_i f_i + (I10/dt) sum_i e_noise_i g_i

with the iterated Itô integrals realized from the two increments (dW, dZ)
of the step: I11 = (dW^2 - dt)/2, I10 = dt/2 (dW + dZ/sqrt(3)), I111 =
(dW^3 - 3 dt dW)/6. The state is one tensor (the JAX function takes any
pytree; the port's models have a single state).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

_SQRT3 = math.sqrt(3.0)


class SRITableau(NamedTuple):
    """Coefficients of a diagonal-noise SRI method and its embedded error
    rows (Python floats)."""

    name: str
    c0: Tuple[float, ...]
    c1: Tuple[float, ...]
    A0: Tuple[Tuple[float, ...], ...]
    A1: Tuple[Tuple[float, ...], ...]
    B0: Tuple[Tuple[float, ...], ...]
    B1: Tuple[Tuple[float, ...], ...]
    alpha: Tuple[float, ...]
    beta1: Tuple[float, ...]
    beta2: Tuple[float, ...]
    beta3: Tuple[float, ...]
    beta4: Tuple[float, ...]
    # E = delta*dt*sum(e_drift_i f_i) + (I10/dt)*sum(e_noise_i g_i)
    delta: float
    e_drift: Tuple[float, ...]
    e_noise: Tuple[float, ...]
    order: float = 1.5

    @property
    def stages(self) -> int:
        return len(self.c0)


class StageAnalysis(NamedTuple):
    f_used: Tuple[bool, ...]
    g_used: Tuple[bool, ...]
    f_alias: Tuple[object, ...]  # index of an identical earlier stage, or None
    g_alias: Tuple[object, ...]
    n_drift_evals: int
    n_diffusion_evals: int


def _analyze(tab: SRITableau) -> StageAnalysis:
    """Which drift/diffusion stages are evaluated, and which alias an
    earlier identical stage (the JAX function's rules)."""
    s = tab.stages
    f_used = [False] * s
    g_used = [False] * s
    for i in range(s):
        if tab.alpha[i] != 0.0 or tab.e_drift[i] != 0.0:
            f_used[i] = True
        if (tab.beta1[i] != 0.0 or tab.beta2[i] != 0.0 or tab.beta3[i] != 0.0
                or tab.beta4[i] != 0.0 or tab.e_noise[i] != 0.0):
            g_used[i] = True
    changed = True
    while changed:
        changed = False
        for i in range(s):
            for j in range(i):
                for used_i, coef, used_j in ((f_used, tab.A0, f_used), (f_used, tab.B0, g_used),
                                             (g_used, tab.A1, f_used), (g_used, tab.B1, g_used)):
                    if used_i[i] and coef[i][j] != 0.0 and not used_j[j]:
                        used_j[j] = True
                        changed = True

    def alias_of(i, c, A, B, used):
        for j in range(i):
            if used[j] and c[i] == c[j] and all(
                    A[i][k] == A[j][k] and B[i][k] == B[j][k] for k in range(i)):
                return j
        return None

    f_alias = tuple(alias_of(i, tab.c0, tab.A0, tab.B0, f_used) if f_used[i] else None
                    for i in range(s))
    g_alias = tuple(alias_of(i, tab.c1, tab.A1, tab.B1, g_used) if g_used[i] else None
                    for i in range(s))
    n_f = sum(1 for i in range(s) if f_used[i] and f_alias[i] is None)
    n_g = sum(1 for i in range(s) if g_used[i] and g_alias[i] is None)
    return StageAnalysis(tuple(f_used), tuple(g_used), f_alias, g_alias, n_f, n_g)


_ANALYSIS_CACHE: dict = {}


def analyze(tab: SRITableau) -> StageAnalysis:
    if tab.name not in _ANALYSIS_CACHE:
        _ANALYSIS_CACHE[tab.name] = _analyze(tab)
    return _ANALYSIS_CACHE[tab.name]


def drift_evals_per_step(tab: SRITableau) -> int:
    return analyze(tab).n_drift_evals


def diffusion_evals_per_step(tab: SRITableau) -> int:
    return analyze(tab).n_diffusion_evals


def eigen_stages(tab: SRITableau) -> Tuple[int, int]:
    """The last two distinct drift stages ``(a, b)``, whose
    ``||f_b - f_a|| / ||H0_b - H0_a||`` is the stiffness proxy; ``(0, 0)``
    with fewer than two."""
    an = analyze(tab)
    distinct = [i for i in range(tab.stages) if an.f_used[i] and an.f_alias[i] is None]
    return (distinct[-2], distinct[-1]) if len(distinct) >= 2 else (0, 0)


def ito_coefficients(dt, dw, dz):
    """``(sqrt(dt), I11/sqrt(dt), I10/dt, I111/dt)`` from the increments."""
    sqdt = torch.sqrt(dt)
    i11 = 0.5 * (dw * dw - dt) / sqdt
    i10 = 0.5 * (dw + dz / _SQRT3)
    i111 = (dw * dw * dw - 3.0 * dt * dw) / (6.0 * dt)
    return sqdt, i11, i10, i111


def sri_step(tab: SRITableau, drift: Callable, diffusion: Callable, args, t, y, dt, dw, dz):
    """One SRI trial step: ``(y_new, err, stage_info)``. ``err`` is the
    natural-embedding residual and ``stage_info = (f_a, f_b, H0_a, H0_b)``
    the last two distinct drift stages and their states (the eigen_est
    proxy). ``drift(t, y, args)`` and ``diffusion(t, y, args)``."""
    an = analyze(tab)
    s = tab.stages
    sqdt, i11, i10, i111 = ito_coefficients(dt, dw, dz)
    fs, gs, h0s = [None] * s, [None] * s, [None] * s
    for i in range(s):
        if an.f_used[i]:
            if an.f_alias[i] is not None:
                fs[i], h0s[i] = fs[an.f_alias[i]], h0s[an.f_alias[i]]
            else:
                h0 = y
                for j in range(i):
                    if tab.A0[i][j] != 0.0:
                        h0 = h0 + (tab.A0[i][j] * dt) * fs[j]
                    if tab.B0[i][j] != 0.0:
                        h0 = h0 + (tab.B0[i][j] * i10) * gs[j]
                fs[i] = drift(t + tab.c0[i] * dt, h0, args)
                h0s[i] = h0
        if an.g_used[i]:
            if an.g_alias[i] is not None:
                gs[i] = gs[an.g_alias[i]]
            else:
                h1 = y
                for j in range(i):
                    if tab.A1[i][j] != 0.0:
                        h1 = h1 + (tab.A1[i][j] * dt) * fs[j]
                    if tab.B1[i][j] != 0.0:
                        h1 = h1 + (tab.B1[i][j] * sqdt) * gs[j]
                gs[i] = diffusion(t + tab.c1[i] * dt, h1, args)

    y1 = y
    for i in range(s):
        if tab.alpha[i] != 0.0:
            y1 = y1 + (tab.alpha[i] * dt) * fs[i]
    for i in range(s):
        b = (tab.beta1[i], tab.beta2[i], tab.beta3[i], tab.beta4[i])
        if not an.g_used[i] or b == (0.0, 0.0, 0.0, 0.0):
            continue
        coef = b[0] * dw + b[1] * i11 + b[2] * i10 + b[3] * i111
        y1 = y1 + coef * gs[i]

    err = torch.zeros_like(y)
    for i in range(s):
        if tab.e_drift[i] != 0.0:
            err = err + ((tab.delta * tab.e_drift[i]) * dt) * fs[i]
    for i in range(s):
        if tab.e_noise[i] != 0.0:
            err = err + (tab.e_noise[i] * i10) * gs[i]

    ia, ib = eigen_stages(tab)
    return y1, err, (fs[ia], fs[ib], h0s[ia], h0s[ib])


# ---------------------------------------------------------------------------
# Stability
# ---------------------------------------------------------------------------


def stability_function_coeffs(tab: SRITableau) -> np.ndarray:
    """R(z) = 1 + sum_k r_k z^k with r_k = alpha^T A0^(k-1) e."""
    A0 = np.asarray(tab.A0, dtype=np.float64)
    al = np.asarray(tab.alpha, dtype=np.float64)
    v = np.ones(tab.stages)
    coeffs = [1.0]
    for _ in range(tab.stages):
        coeffs.append(float(al @ v))
        v = A0 @ v
    return np.asarray(coeffs)


_STABILITY_CACHE: dict = {}


def stability_size(tab: SRITableau) -> float:
    """Largest L with |R(-x)| <= 1 on [0, L]: the deterministic real-axis
    stability interval, which normalizes the stiff_est regularizer. A scan
    of 65537 points in Python (about 0.3 s), kept per tableau."""
    if tab not in _STABILITY_CACHE:
        _STABILITY_CACHE[tab] = _stability_size(tab)
    return _STABILITY_CACHE[tab]


def _stability_size(tab: SRITableau) -> float:
    coeffs = stability_function_coeffs(tab)

    def R(x):
        return sum(c * (-x) ** k for k, c in enumerate(coeffs))

    xs = np.linspace(0.0, 64.0, 65537)
    vals = np.abs([R(x) for x in xs])
    bad = np.nonzero(vals > 1.0 + 1e-12)[0]
    if len(bad) == 0:
        return float(xs[-1])
    first = bad[0]
    if first == 0:
        return 0.0
    lo, hi = xs[first - 1], xs[first]
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if abs(R(mid)) <= 1.0:
            lo = mid
        else:
            hi = mid
    return float(lo)


# ---------------------------------------------------------------------------
# Tableaus
# ---------------------------------------------------------------------------


def _rows(*rows):
    return tuple(tuple(float(x) for x in r) for r in rows)


#: Rößler (2010) SRIW1, natural embedding with the Euler-embedded drift pair.
SRIW1 = SRITableau(
    name="sriw1",
    c0=(0.0, 0.75, 0.0, 0.0),
    c1=(0.0, 0.25, 1.0, 0.25),
    A0=_rows((0, 0, 0, 0), (0.75, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)),
    A1=_rows((0, 0, 0, 0), (0.25, 0, 0, 0), (1, 0, 0, 0), (0, 0, 0.25, 0)),
    B0=_rows((0, 0, 0, 0), (1.5, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0)),
    B1=_rows((0, 0, 0, 0), (0.5, 0, 0, 0), (-1, 0, 0, 0), (-5, 3, 0.5, 0)),
    alpha=(1 / 3, 2 / 3, 0.0, 0.0),
    beta1=(-1.0, 4 / 3, 2 / 3, 0.0),
    beta2=(-1.0, 4 / 3, -1 / 3, 0.0),
    beta3=(2.0, -4 / 3, -2 / 3, 0.0),
    beta4=(-2.0, 5 / 3, -2 / 3, 1.0),
    delta=1 / 6,
    e_drift=(1 / 3 - 1.0, 2 / 3, 0.0, 0.0),
    e_noise=(1.0, 0.0, 0.0, -1.0),
)

#: The stability-optimized tableau of the JAX package (interval 12.00).
SOSRI_TPU = SRITableau(
    name='sosri-tpu',
    c0=(0.0, 0.13448144584742838, 0.5485519200457587, 0.7932189876313653),
    c1=(0.0, 0.25, 1.0, 0.25),
    A0=((0.0, 0.0, 0.0, 0.0), (0.13448144584742838, 0.0, 0.0, 0.0),
        (0.2285111760605295, 0.32004074398522925, 0.0, 0.0),
        (0.19045545362790142, 0.36819463480493536, 0.23456889919852852, 0.0)),
    A1=((0.0, 0.0, 0.0, 0.0), (0.25, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0),
        (0.0, 0.0, 0.25, 0.0)),
    B0=((0.0, 0.0, 0.0, 0.0), (0.2144094116475181, 0.0, 0.0, 0.0),
        (0.8242137309564158, 0.0, 0.0, 0.0), (1.875, 0.0, 0.0, 0.0)),
    B1=((0.0, 0.0, 0.0, 0.0), (0.5, 0.0, 0.0, 0.0), (-1.0, 0.0, 0.0, 0.0),
        (-5.0, 3.0, 0.5, 0.0)),
    alpha=(0.06031467547096834, 0.24982011470859605, 0.3302870074059817,
           0.3595782024144538),
    beta1=(-1.0, 1.3333333333333333, 0.6666666666666666, 0.0),
    beta2=(-1.0, 1.3333333333333333, -0.3333333333333333, 0.0),
    beta3=(2.0, -1.3333333333333333, -0.6666666666666666, 0.0),
    beta4=(-2.0, 1.6666666666666667, -0.6666666666666666, 1.0),
    delta=0.16666666666666666,
    e_drift=(-0.9396853245290316, 0.24982011470859605, 0.3302870074059817,
             0.3595782024144538),
    e_noise=(1.0, 0.0, 0.0, -1.0),
    order=1.5,
)

#: The robust variant (interval 11.31) whose stability size normalizes the
#: stiff_est regularizer of the MNIST Neural SDE.
SOSRI2_TPU = SRITableau(
    name='sosri2-tpu',
    c0=(0.0, 0.35919181274394774, 0.42169564004173643, 0.8539113682025239),
    c1=(0.0, 0.25, 1.0, 0.25),
    A0=((0.0, 0.0, 0.0, 0.0), (0.35919181274394774, 0.0, 0.0, 0.0),
        (0.18866361026211728, 0.23303202977961915, 0.0, 0.0),
        (0.33973407870957495, 0.3667173445674895, 0.14745994492545939, 0.0)),
    A1=((0.0, 0.0, 0.0, 0.0), (0.25, 0.0, 0.0, 0.0), (1.0, 0.0, 0.0, 0.0),
        (0.0, 0.0, 0.25, 0.0)),
    B0=((0.0, 0.0, 0.0, 0.0), (1.8501220448923374, 0.0, 0.0, 0.0),
        (0.18561987913611205, 0.0, 0.0, 0.0), (0.9500000000000002, 0.0, 0.0, 0.0)),
    B1=((0.0, 0.0, 0.0, 0.0), (0.5, 0.0, 0.0, 0.0), (-1.0, 0.0, 0.0, 0.0),
        (-5.0, 3.0, 0.5, 0.0)),
    alpha=(0.10046358454103316, 0.3490749819099003, 0.22079287074181553,
           0.329668562807251),
    beta1=(-1.0, 1.3333333333333333, 0.6666666666666666, 0.0),
    beta2=(-1.0, 1.3333333333333333, -0.3333333333333333, 0.0),
    beta3=(2.0, -1.3333333333333333, -0.6666666666666666, 0.0),
    beta4=(-2.0, 1.6666666666666667, -0.6666666666666666, 1.0),
    delta=0.16666666666666666,
    e_drift=(-0.8995364154589669, 0.3490749819099003, 0.22079287074181553,
             0.329668562807251),
    e_noise=(1.0, 0.0, 0.0, -1.0),
    order=1.5,
)

TABLEAUS = {
    "sriw1": SRIW1,
    "sosri": SOSRI_TPU,
    "sosri2": SOSRI2_TPU,
}


def get_tableau(name: str) -> SRITableau:
    try:
        return TABLEAUS[name]
    except KeyError:
        raise ValueError(
            f"unknown SRI tableau {name!r}; available: {sorted(TABLEAUS)}") from None
