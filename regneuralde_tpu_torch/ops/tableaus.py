"""Runge-Kutta tableaus (counterpart of ``regneuralde_tpu/ops/tableaus.py``).

Only Tsit5 is ported: it is the one solver on the MNIST Neural-ODE path.
The coefficients are the published Tsitouras 5(4) values, copied verbatim
from the JAX package so that both solvers make the same rounding choices.
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
