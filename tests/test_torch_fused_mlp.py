"""The port's normed Tsit5 step (regneuralde_tpu_torch.ops.fused_mlp)
against the JAX package's (regneuralde_tpu.ops.pallas_mlp).

The JAX side runs as its own tests run it on the CPU: the Pallas kernels
K1/K2 in interpret mode, and ``_reference_normed_sweep`` as the plain
reference. Both packages get the same numpy arrays from a seeded
generator. The CUDA kernels themselves run only on the card: see
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm

torch.set_num_threads(1)

RTOL = ATOL = 1e-4


def _case(batch, dim, hidden, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(hidden, dim + 1)) / np.sqrt(dim + 1)),
        b1=f32(rng.normal(size=hidden) * 0.1),
        W2=f32(rng.normal(size=(dim, hidden + 1)) / np.sqrt(hidden + 1)),
        b2=f32(rng.normal(size=dim) * 0.1),
        y=f32(rng.normal(size=(batch, dim)) * 0.5),
        k1=f32(rng.normal(size=(batch, dim)) * 0.3),
        ct_y_new=f32(rng.normal(size=(batch, dim))),
        ct_k7=f32(rng.normal(size=(batch, dim))),
    )


def _flax_params(c):
    """The same weights as a flax MLPDynamics tree: kernels (in, out)."""
    return {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}


def _leaves(c, dtype=torch.float32):
    return tuple(torch.tensor(c[k], dtype=dtype) for k in ("W1", "b1", "W2", "b2"))


SHAPES = [(8, 16, 12), (6, 8, 5), (16, 16, 5)]
T, DT = 0.07, 0.11
SCALAR_CTS = (0.7, 1.3, -0.4)


def _jax_forward(c):
    p = _flax_params(c)
    t, dt = jnp.float32(T), jnp.float32(DT)
    y, k1 = jnp.asarray(c["y"]), jnp.asarray(c["k1"])
    kern = jmlp.mlp_dynamics_normed_sweep(t, dt, y, k1, p, RTOL, ATOL)
    ref = jmlp._reference_normed_sweep(t, dt, y, k1, jmlp._split_params(p),
                                       RTOL, ATOL)
    return tuple(kern), ref


def _torch_forward(c, dtype=torch.float32):
    return fm.normed_sweep_fwd(torch.tensor(T, dtype=dtype),
                               torch.tensor(DT, dtype=dtype),
                               torch.tensor(c["y"], dtype=dtype),
                               torch.tensor(c["k1"], dtype=dtype),
                               _leaves(c, dtype), RTOL, ATOL)


FWD_NAMES = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_matches_jax_kernel_and_reference(shape):
    """rtol=2e-5 as the JAX package holds its kernel to its reference
    (tests/test_pallas_fused.py:147-148). There both sides run XLA's exp;
    here ATen's and XLA's exp differ by an ulp in about one argument in
    ten, so entries near zero differ by a few ulps of the O(1) stage
    values: atol is four ulps at 1.0 (5e-7) instead of 1e-7. err_ssq sums
    the squared embedded error, which cancels O(1) stage values down to
    O(dt^5) and so carries those ulps relative to a small number: the three
    sums are held to rtol=1e-4. (Against a float64 evaluation the two
    float32 results are equally far off.)"""
    c = _case(*shape)
    got = _torch_forward(c)
    for want in _jax_forward(c):
        for a, b, name in zip(got, want, FWD_NAMES):
            rtol = 2e-5 if name in ("y_new", "k7") else 1e-4
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                       atol=5e-7, err_msg=name)


def _jax_cts(c):
    return (jnp.asarray(c["ct_y_new"]), jnp.asarray(c["ct_k7"]),
            *(jnp.float32(s) for s in SCALAR_CTS))


def _torch_cts(c, dtype=torch.float32):
    return (torch.tensor(c["ct_y_new"], dtype=dtype),
            torch.tensor(c["ct_k7"], dtype=dtype),
            *(torch.tensor(s, dtype=dtype) for s in SCALAR_CTS))


def _flat_jax_grads(g):
    """(ct_t, ct_dt, ct_y, ct_k1, split parts) -> the port's layout."""
    ct_t, ct_dt, cy, ck1, (cw1x, cw1t, cb1, cw2h, cw2t, cb2) = g
    cw1 = np.concatenate([np.asarray(cw1x), np.asarray(cw1t)], 0).T
    cw2 = np.concatenate([np.asarray(cw2h), np.asarray(cw2t)], 0).T
    return [np.asarray(ct_t), np.asarray(ct_dt), np.asarray(cy), np.asarray(ck1),
            cw1, np.asarray(cb1).reshape(-1), cw2, np.asarray(cb2).reshape(-1)]


def _flat_torch_grads(g):
    ct_t, ct_dt, cy, ck1, leaves = g
    return [x.detach().numpy() for x in (ct_t, ct_dt, cy, ck1, *leaves)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_kernel_and_vjp(shape):
    c = _case(*shape)
    parts = jmlp._split_params(_flax_params(c))
    t, dt = jnp.float32(T), jnp.float32(DT)
    y, k1 = jnp.asarray(c["y"]), jnp.asarray(c["k1"])
    kern = jmlp._normed_pallas_bwd(t, dt, y, k1, parts, _jax_cts(c), RTOL, ATOL)
    _, vjp = jax.vjp(lambda *a: jmlp._reference_normed_sweep(*a, RTOL, ATOL),
                     t, dt, y, k1, parts)
    ref = vjp(_jax_cts(c))
    got = _flat_torch_grads(fm.normed_sweep_bwd(
        torch.tensor(T), torch.tensor(DT), torch.tensor(c["y"]),
        torch.tensor(c["k1"]), _leaves(c), _torch_cts(c), RTOL, ATOL))
    names = ["t", "dt", "y", "k1", "W1", "b1", "W2", "b2"]
    # The seeds multiply by 1/denom ~ 1/atol, so small cotangent entries
    # carry amplified f32 rounding: the JAX package's own tolerance for
    # this comparison (tests/test_pallas_fused.py:180-188).
    for want in (kern, ref):
        for a, b, name in zip(got, _flat_jax_grads(want), names):
            np.testing.assert_allclose(a, b, rtol=2e-2, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_hand_backward_matches_autograd_away_from_ties(shape):
    """In float64 the hand chain equals autograd of the plain forward to
    rounding; random inputs have no |y| == |y_new| ties, where autograd
    would split the max subgradient and the hand chain gives y all of it."""
    c = _case(*shape)
    f64 = torch.float64
    t = torch.tensor(T, dtype=f64, requires_grad=True)
    dt = torch.tensor(DT, dtype=f64, requires_grad=True)
    y = torch.tensor(c["y"], dtype=f64, requires_grad=True)
    k1 = torch.tensor(c["k1"], dtype=f64, requires_grad=True)
    leaves = [x.requires_grad_(True) for x in _leaves(c, f64)]
    out = fm._reference_normed_sweep(t, dt, y, k1, fm._split_params(*leaves),
                                     RTOL, ATOL)
    assert not torch.any(torch.abs(y) == torch.abs(out[0]))
    cts = _torch_cts(c, f64)
    want = torch.autograd.grad(out, (t, dt, y, k1, *leaves), grad_outputs=cts)
    got = fm.normed_sweep_bwd(t.detach(), dt.detach(), y.detach(), k1.detach(),
                              [x.detach() for x in leaves], cts, RTOL, ATOL)
    for a, b in zip(_flat_torch_grads(got), want):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-9, atol=1e-9)


def test_cpu_wrappers_take_plain_version_and_launch_nothing():
    c = _case(6, 8, 5)
    fm.reset_launches()
    t, dt = torch.tensor(T), torch.tensor(DT)
    y, k1 = torch.tensor(c["y"]), torch.tensor(c["k1"])
    leaves = [x.requires_grad_(True) for x in _leaves(c)]
    out = fm.mlp_dynamics_normed_sweep(t, dt, y, k1, leaves, RTOL, ATOL)
    plain = fm._reference_normed_sweep(t, dt, y, k1, fm._split_params(*leaves),
                                       RTOL, ATOL)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    (out.y_new.sum() + out.err_ssq).backward()  # NormedSweepFn.backward
    g = fm.mlp_dynamics_normed_sweep_bwd(t, dt, y, k1, leaves, _torch_cts(c),
                                         RTOL, ATOL)
    assert all(torch.isfinite(x).all() for x in g[4])
    assert all(torch.isfinite(x.grad).all() for x in leaves)
    assert fm.LAUNCHES == {"normed_tsit5_fwd": 0, "normed_tsit5_bwd": 0}


def test_wrappers_refuse_other_devices():
    c = _case(6, 8, 5)
    meta = lambda a: torch.empty(a.shape, device="meta")
    with pytest.raises(RuntimeError, match="device meta"):
        fm.normed_sweep_fwd(torch.tensor(T), torch.tensor(DT), meta(c["y"]),
                            meta(c["k1"]), _leaves(c), RTOL, ATOL)
