"""Runge-Kutta tableaus (counterpart of ``regneuralde_tpu/ops/tableaus.py``).

Tsit5, Bogacki-Shampine 3(2) and Dormand-Prince 5(4), the explicit FSAL
tableaus of the JAX package. The coefficients are copied verbatim from it,
so that both solvers make the same rounding choices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ExplicitRKTableau:
    """An explicit Runge-Kutta tableau with an embedded error estimate."""

    name: str
    order: int
    c: Tuple[float, ...]  # stage times (fractions of dt); c[0] == 0
    a: Tuple[Tuple[float, ...], ...]  # a[i]: coefficients for stage i+2
    b: Tuple[float, ...]  # advancing-solution weights (== last a row, FSAL)
    btilde: Tuple[float, ...]  # b - bhat; error = dt * sum(btilde_i k_i)
    fsal: bool
    stability_size: float  # OrdinaryDiffEq's alg_stability_size

    @property
    def num_stages(self) -> int:
        return len(self.b)


TSIT5 = ExplicitRKTableau(
    name="tsit5",
    order=5,
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    a=(
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.071584973281401, -0.028269050394068383),
        (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774),
    ),
    b=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
       -3.290069515436081, 2.324710524099774, 0.0),
    btilde=(
        -0.00178001105222577714,
        -0.0008164344596567469,
        0.007880878010261995,
        -0.1447110071732629,
        0.5823571654525552,
        -0.45808210592918697,
        0.015151515151515152,
    ),
    fsal=True,
    stability_size=3.5068,
)


# Bogacki–Shampine 3(2): a small, cheap adaptive method used for tests and
# as a low-order alternative (3 fresh evals per step, FSAL).
BOSH3 = ExplicitRKTableau(
    name="bosh3",
    order=3,
    c=(0.0, 0.5, 0.75, 1.0),
    a=(
        (0.5,),
        (0.0, 0.75),
        (2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0),
    ),
    b=(2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0, 0.0),
    btilde=(
        2.0 / 9.0 - 7.0 / 24.0,
        1.0 / 3.0 - 0.25,
        4.0 / 9.0 - 1.0 / 3.0,
        -0.125,
    ),
    fsal=True,
    stability_size=2.5128,
)


# Dormand-Prince 5(4) ("RK45"/dopri5): the other canonical adaptive
# 7-stage FSAL RK5(4); provided for solver-zoo breadth and cross-checks
# against scipy's RK45.
DOPRI5 = ExplicitRKTableau(
    name="dopri5",
    order=5,
    c=(0.0, 1.0 / 5.0, 3.0 / 10.0, 4.0 / 5.0, 8.0 / 9.0, 1.0, 1.0),
    a=(
        (1.0 / 5.0,),
        (3.0 / 40.0, 9.0 / 40.0),
        (44.0 / 45.0, -56.0 / 15.0, 32.0 / 9.0),
        (19372.0 / 6561.0, -25360.0 / 2187.0, 64448.0 / 6561.0, -212.0 / 729.0),
        (
            9017.0 / 3168.0,
            -355.0 / 33.0,
            46732.0 / 5247.0,
            49.0 / 176.0,
            -5103.0 / 18656.0,
        ),
        (
            35.0 / 384.0,
            0.0,
            500.0 / 1113.0,
            125.0 / 192.0,
            -2187.0 / 6784.0,
            11.0 / 84.0,
        ),
    ),
    b=(
        35.0 / 384.0,
        0.0,
        500.0 / 1113.0,
        125.0 / 192.0,
        -2187.0 / 6784.0,
        11.0 / 84.0,
        0.0,
    ),
    btilde=(
        35.0 / 384.0 - 5179.0 / 57600.0,
        0.0,
        500.0 / 1113.0 - 7571.0 / 16695.0,
        125.0 / 192.0 - 393.0 / 640.0,
        -2187.0 / 6784.0 + 92097.0 / 339200.0,
        11.0 / 84.0 - 187.0 / 2100.0,
        -1.0 / 40.0,
    ),
    fsal=True,
    # OrdinaryDiffEq: alg_stability_size(DP5()) == 3.3066.
    stability_size=3.3066,
)


TABLEAUS = {"tsit5": TSIT5, "bosh3": BOSH3, "dopri5": DOPRI5}


def get_tableau(name: str) -> ExplicitRKTableau:
    try:
        return TABLEAUS[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {sorted(TABLEAUS)}") from None
