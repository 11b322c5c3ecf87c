"""The port's SRI layer (``regneuralde_tpu_torch.ops.sri``) against the JAX
package's ``regneuralde_tpu.ops.sri``: the three tableaus constant for
constant, the static stage analysis, the stability interval (1e-12), and one
trial step ``sri_step`` on the same (t, y, dt, dW, dZ) and MLP weights, at
1e-12 in float64 and at rtol 2e-5 / atol 5e-7 in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import sri as jsri
from regneuralde_tpu.ops.norms import error_ratio as jax_error_ratio
from regneuralde_tpu_torch.ops.norms import error_ratio
from regneuralde_tpu_torch.ops import sri as tsri

NAMES = ["sriw1", "sosri", "sosri2"]


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("name", NAMES)
def test_tableau_constants_equal_jax(name):
    j, t = jsri.get_tableau(name), tsri.get_tableau(name)
    assert tuple(j) == tuple(t)
    assert j._fields == t._fields


@pytest.mark.parametrize("name", NAMES)
def test_stage_analysis_equals_jax(name):
    j, t = jsri.get_tableau(name), tsri.get_tableau(name)
    norm = lambda an: [tuple(x) if isinstance(x, (list, tuple)) else x for x in an]
    assert norm(tsri.analyze(t)) == norm(jsri.analyze(j))
    assert tsri.drift_evals_per_step(t) == jsri.drift_evals_per_step(j)
    assert tsri.diffusion_evals_per_step(t) == jsri.diffusion_evals_per_step(j)


@pytest.mark.parametrize("name", NAMES)
def test_stability_size_equals_jax(name):
    j, t = jsri.get_tableau(name), tsri.get_tableau(name)
    np.testing.assert_allclose(tsri.stability_function_coeffs(t),
                               jsri.stability_function_coeffs(j), rtol=0, atol=1e-12)
    assert abs(tsri.stability_size(t) - jsri.stability_size(j)) <= 1e-12


def test_unknown_tableau_raises():
    with pytest.raises(ValueError, match="sosri2"):
        tsri.get_tableau("rk4")


def _inputs(seed=0, batch=6, dim=5, hidden=7):
    rng = np.random.default_rng(seed)
    w = [rng.normal(size=(dim, hidden)) / np.sqrt(dim), rng.normal(size=hidden) * 0.1,
         rng.normal(size=(hidden, dim)) / np.sqrt(hidden), rng.normal(size=dim) * 0.1,
         rng.normal(size=(dim, dim)) / np.sqrt(dim), rng.normal(size=dim) * 0.1]
    y = rng.normal(size=(batch, dim)) * 0.5
    dt = 0.13
    dw = rng.normal(size=(batch, dim)) * np.sqrt(dt)
    dz = rng.normal(size=(batch, dim)) * np.sqrt(dt)
    return w, y, dt, dw, dz


def _step(lib, xp, tanh, name, w, y, dt, dw, dz, t):
    drift = lambda tt, yy, p: tanh(yy @ p[0] + p[1]) @ p[2] + p[3] + 0.3 * tt
    diffusion = lambda tt, yy, p: yy @ p[4] + p[5] - 0.2 * tt
    return lib.sri_step(lib.get_tableau(name), drift, diffusion, w, t, y, dt, dw, dz)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_sri_step_matches_jax(x64, dtype, name):
    """Time-dependent dynamics so that the stage times c0, c1 count."""
    w, y, dt, dw, dz = _inputs()
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ja = lambda a: jnp.asarray(a, jd)
    ta = lambda a: torch.tensor(np.asarray(a), dtype=td)
    jout = _step(jsri, jnp, jnp.tanh, name, [ja(x) for x in w], ja(y), ja(dt), ja(dw),
                 ja(dz), ja(0.21))
    tout = _step(tsri, torch, torch.tanh, name, [ta(x) for x in w], ta(y), ta(dt), ta(dw),
                 ta(dz), ta(0.21))
    jflat = [jout[0], jout[1], *jout[2]]
    tflat = [tout[0], tout[1], *tout[2]]
    rtol, atol = (1e-12, 1e-12) if dtype == "float64" else (2e-5, 5e-7)
    for a, b in zip(tflat, jflat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol)


def test_error_ratio_matches_jax(x64):
    """``hairer_norm(err / (atol + max(|y0|, |y1|) rtol))`` in float64, a
    tie of |y0| and |y1| included, value and gradient at 1e-12."""
    rng = np.random.default_rng(2)
    err, y0, y1 = (rng.normal(size=(4, 3)) for _ in range(3))
    y1[0, 0] = -y0[0, 0]
    jv, jg = jax.value_and_grad(lambda e, a, b: jax_error_ratio(e, a, b, 1e-2, 1e-3),
                                argnums=(0, 1, 2))(*map(jnp.asarray, (err, y0, y1)))
    ts = [torch.tensor(x, requires_grad=True) for x in (err, y0, y1)]
    tv = error_ratio(*ts, 1e-2, 1e-3)
    tg = torch.autograd.grad(tv, ts)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-12)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
