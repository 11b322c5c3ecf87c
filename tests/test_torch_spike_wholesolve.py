"""K15, the whole-solve feature probe: the port's plain version
(``regneuralde_tpu_torch.ops.spike_wholesolve``; on the CPU the wrapper
takes it) against the JAX spike's ``run`` (``tools/spike_wholesolve.py``,
loaded with importlib; on the CPU its Pallas kernel runs in interpret mode
and the module prints its own check once at import), on seeded numpy
states at JAX's size (32, 20), 16 rows.

Cases: ``t0`` in {0, 0.1, 0.9} (four, four and one iteration) and -5 (the
loop stops at the 16-row cap with ``t < 1``), two seeds each. ``y1`` and
``tel`` agree within 1e-6 (absolute; XLA's and ATen's tanh differ by a few
ulps, and four to sixteen iterations carry them); the history rows ``< n``
and lanes ``< D`` within 1e-6 as well (JAX's padded lanes and unwritten rows
are NaN in interpret mode, the port drops the padding and leaves those rows
unspecified).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from regneuralde_tpu_torch.ops import spike_wholesolve as sp

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-6
CASES = {0.0: 4, 0.1: 4, 0.9: 1, -5.0: 16}  # t0: iterations


@pytest.fixture(scope="module")
def jax_spike():
    spec = importlib.util.spec_from_file_location("spike_wholesolve",
                                                  ROOT / "tools" / "spike_wholesolve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _y0(seed):
    return np.random.default_rng(seed).standard_normal((sp.B, sp.D)).astype(np.float32)


def test_sizes_are_the_spikes(jax_spike):
    assert (sp.B, sp.D, sp.MAXS) == (jax_spike.B, jax_spike.D, jax_spike.MAXS)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("t0", list(CASES))
def test_plain_version_matches_jax(jax_spike, t0, seed):
    y0 = _y0(seed)
    jy1, jtel, jhy = (np.asarray(a) for a in jax_spike.run(t0, y0))
    y1, tel, hy, n = sp.spike_wholesolve(t0, torch.from_numpy(y0))
    assert n == CASES[t0]
    assert tel.shape == (sp.MAXS, 1) and hy.shape == (sp.MAXS, sp.B, sp.D)
    assert np.abs(y1.numpy() - jy1).max() <= TOL
    assert np.abs(tel.numpy() - jtel).max() <= TOL
    assert np.abs(hy[:n].numpy() - jhy[:n, :, :sp.D]).max() <= TOL
    np.testing.assert_array_equal(hy[0].numpy(), y0)
    if t0 == -5.0:
        assert float(tel[-1, 0]) < 1.0, "the cap, not the time, ended the loop"


def test_sizes_are_arguments_and_refusals():
    """Other sizes and caps run (the entry point's arguments); the wrapper
    refuses a device it has no version for, and its update is the plain
    loop's."""
    y0 = torch.from_numpy(np.random.default_rng(2).standard_normal((6, 10)).astype(np.float32))
    y1, tel, hy, n = sp.spike_wholesolve(-1.0, y0, maxs=5)
    assert n == 5 and hy.shape == (5, 6, 10) and tel.shape == (5, 1)
    assert torch.equal(tel[:, 0], torch.tensor([-1.0, -0.75, -0.5, -0.25, 0.0]))
    y, t = y0, torch.tensor(-1.0)
    for i in range(5):
        assert torch.equal(hy[i], y)
        y, t = sp.spike_update(y, t), t + 0.25
    assert torch.equal(y1, y)
    sp.reset_launches()
    assert sp.LAUNCHES == {"spike_wholesolve": 0}
    with pytest.raises(RuntimeError, match="device"):
        sp.spike_wholesolve(0.0, y0.to("meta"))


def test_tool_runs_the_plain_version_on_the_cpu():
    """``tools/torch_spike_wholesolve.py`` prints the spike's lines and
    checks them; its ``main`` refuses to run without a card."""
    spec = importlib.util.spec_from_file_location("torch_spike_wholesolve",
                                                  ROOT / "tools" / "torch_spike_wholesolve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ok, lines = mod.run("cpu")
    assert ok and lines[1] == "hy row0 == y0: True" and lines[2] == "hy row1 finite: True"
    if not torch.cuda.is_available():
        assert mod.main() == 1
