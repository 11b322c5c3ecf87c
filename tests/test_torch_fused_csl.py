"""The port's CSL dynamics and CSL trial step (regneuralde_tpu_torch.models
CSLDynamics, regneuralde_tpu_torch.ops.fused_csl) against the JAX package's
(regneuralde_tpu.models.CSLDynamics, regneuralde_tpu.ops.pallas_generic).

The JAX side runs the flax module, ``csl_aug_apply`` and, for the trial
step, ``make_csl_ffjord_sweep``: the Pallas kernels K7/K8 in interpret mode
on the CPU, as ``tests/test_pallas_generic.py`` runs them. Both packages get
the same numpy parameters (carried across with ``convert.ffjord_state_dict``)
and the same Hutchinson probe. The CUDA kernels run only on the card: see
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.models import CSLDynamics as JCSL
from regneuralde_tpu.ops import pallas_generic as jpg
from regneuralde_tpu_torch import convert
from regneuralde_tpu_torch.models import CSLDynamics
from regneuralde_tpu_torch.ops import fused_csl as fc

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
T, DT = 0.07, 0.11
SCALAR_CTS = (0.7, 1.3, -0.4)
# (batch, dim, hidden): the small shape and a ragged one
SHAPES = [(8, 3, 8), (5, 4, 6)]


def csl_params(dim, hidden, seed=0, scale=1.0):
    """flax ``CSLDynamics`` parameters from numpy: Dense kernels ``(in,
    out)`` at ``scale`` times LeCun's, the time layers' ``(1, out)``
    kernels at 1, biases at 0.1."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    p = {}
    for name, (n_in, n_out) in zip(("csl1", "csl2", "csl3"),
                                   ((dim, hidden), (hidden, hidden), (hidden, dim))):
        p[name] = {
            "layer": {"kernel": f32(rng.normal(size=(n_in, n_out)) / np.sqrt(n_in) * scale),
                      "bias": f32(rng.normal(size=n_out) * 0.1)},
            "gate": {"kernel": f32(rng.normal(size=(1, n_out)))},
            "bias": {"kernel": f32(rng.normal(size=(1, n_out))),
                     "bias": f32(rng.normal(size=n_out) * 0.1)},
        }
    return {"params": p}


def torch_csl(params, dim, hidden, dtype=torch.float32):
    """The port's ``CSLDynamics`` on the CPU with ``params``."""
    m = CSLDynamics(dim, hidden, device="cpu").to(dtype)
    sd = {k[len("dynamics."):]: v for k, v in convert.ffjord_state_dict(params).items()}
    m.load_state_dict(sd)
    return m.to(dtype)


def _case(batch, dim, hidden, kinetic, seed=0):
    rng = np.random.default_rng(seed + 1)
    f32 = lambda a: np.asarray(a, np.float32)
    width = dim + (3 if kinetic else 1)
    return dict(params=csl_params(dim, hidden, seed), e=f32(rng.normal(size=(batch, dim))),
                y=f32(rng.normal(size=(batch, width)) * 0.5),
                k1=f32(rng.normal(size=(batch, width)) * 0.3),
                ct_y_new=f32(rng.normal(size=(batch, width))),
                ct_k7=f32(rng.normal(size=(batch, width))))


def _torch_leaves(c, dim, hidden, dtype=torch.float32):
    m = torch_csl(c["params"], dim, hidden, dtype)
    return [p.detach() for p in m.parameters()] + [torch.tensor(c["e"], dtype=dtype)]


def _torch_cts(c, dtype=torch.float32):
    return (torch.tensor(c["ct_y_new"], dtype=dtype), torch.tensor(c["ct_k7"], dtype=dtype),
            *(torch.tensor(s, dtype=dtype) for s in SCALAR_CTS))


def _jax_grads_in_torch_layout(g):
    """flax parameter cotangents in ``parameters()`` order and layout."""
    out = []
    for name in ("csl1", "csl2", "csl3"):
        p = g["params"][name]
        out += [np.asarray(p["layer"]["kernel"]).T, np.asarray(p["layer"]["bias"]),
                np.asarray(p["gate"]["kernel"]).T, np.asarray(p["bias"]["kernel"]).T,
                np.asarray(p["bias"]["bias"])]
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_module_forward_and_forw_n_back_match_flax(shape):
    """``CSLDynamics.forward`` and ``forw_n_back`` against flax's at t=0.3,
    float32, rtol=atol=1e-6; ``eJ`` also against ``torch.autograd``'s VJP
    of the module's forward (the same function, so 1e-6)."""
    batch, dim, hidden = shape
    c = _case(batch, dim, hidden, False)
    x = np.asarray(np.random.default_rng(5).normal(size=(batch, dim)), np.float32)
    jm = JCSL(dim=dim, hidden=hidden)
    want_f = np.asarray(jm.apply(c["params"], jnp.asarray(x), 0.3))
    want_mz, want_ej = (np.asarray(a) for a in jm.apply(
        c["params"], jnp.asarray(x), 0.3, jnp.asarray(c["e"]), method=JCSL.forw_n_back))
    m = torch_csl(c["params"], dim, hidden)
    xt = torch.tensor(x, requires_grad=True)
    f = m(xt, 0.3)
    mz, ej = m.forw_n_back(xt, 0.3, torch.tensor(c["e"]))
    np.testing.assert_allclose(f.detach().numpy(), want_f, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mz.detach().numpy(), want_mz, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ej.detach().numpy(), want_ej, rtol=1e-6, atol=1e-6)
    (vjp,) = torch.autograd.grad(f, xt, grad_outputs=torch.tensor(c["e"]))
    np.testing.assert_allclose(ej.detach().numpy(), vjp.numpy(), rtol=1e-6, atol=1e-6)
    assert [n for n, _ in m.named_parameters()] == fc.LEAF_NAMES


@pytest.mark.parametrize("kinetic", [False, True])
def test_aug_apply_matches_jax(kinetic):
    """``csl_aug_apply`` over the leaves and the probe against JAX's, float32,
    rtol=atol=1e-6, with and without the kinetic terms."""
    batch, dim, hidden = SHAPES[0]
    c = _case(batch, dim, hidden, kinetic)
    jleaves = jpg.csl_aug_leaves(jax.tree_util.tree_map(jnp.asarray, c["params"]),
                                 jnp.asarray(c["e"]))
    want = np.asarray(jpg.csl_aug_apply(dim, kinetic)(jnp.float32(T), jnp.asarray(c["y"]),
                                                      jleaves))
    got = fc.csl_aug_apply(dim, kinetic)(torch.tensor(T), torch.tensor(c["y"]),
                                         _torch_leaves(c, dim, hidden))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _jax_sweep(c, dim, kinetic):
    """The forward quintuple and the backward (parameters in the port's
    layout) of JAX's ``make_csl_ffjord_sweep`` (interpret-mode K7/K8)."""
    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    fwd, bwd = jpg.make_csl_ffjord_sweep(params, jnp.asarray(c["e"]), dim, kinetic,
                                         RTOL, ATOL)
    t, dt = jnp.float32(T), jnp.float32(DT)
    y, k1 = jnp.asarray(c["y"]), jnp.asarray(c["k1"])
    out_f = [np.asarray(x) for x in fwd(t, dt, y, k1, params)]
    cts = (jnp.asarray(c["ct_y_new"]), jnp.asarray(c["ct_k7"]),
           *(jnp.float32(s) for s in SCALAR_CTS))
    ct_t, ct_dt, cy, ck1, cp = bwd(t, dt, y, k1, params, cts)
    out_b = [np.asarray(ct_t), np.asarray(ct_dt), np.asarray(cy), np.asarray(ck1),
             *_jax_grads_in_torch_layout(cp)]
    return out_f, out_b


FWD_NAMES = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kinetic", [False, True])
def test_plain_k7_k8_match_jax_kernels_float32(shape, kinetic):
    """K7-CSL's and K8-CSL's plain versions against JAX's interpret-mode
    K7/K8 over the CSL dynamics, float32. Forward: y_new and k7 at rtol=2e-5,
    atol=5e-7 (ATen's and XLA's exp and log1p differ by ulps in some
    arguments, and the port sums each product in float64), the three norm
    sums at rtol=1e-4 (the embedded error cancels O(1) stage values).
    Backward: rtol=2e-2, atol=5e-4, the JAX package's own tolerance for a
    normed backward (its seeds multiply by 1/atol and amplify float32
    rounding, tests/test_pallas_fused.py:180-188)."""
    batch, dim, hidden = shape
    c = _case(batch, dim, hidden, kinetic)
    want_f, want_b = _jax_sweep(c, dim, kinetic)
    leaves = _torch_leaves(c, dim, hidden)
    t, dt = torch.tensor(T), torch.tensor(DT)
    y, k1 = torch.tensor(c["y"]), torch.tensor(c["k1"])
    got_f = fc.plain_csl_normed_sweep(t, dt, y, k1, leaves, RTOL, ATOL)
    for a, b, name in zip(got_f, want_f, FWD_NAMES):
        rtol = 2e-5 if name in ("y_new", "k7") else 1e-4
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=5e-7, err_msg=name)
    ct_t, ct_dt, cy, ck1, cl = fc._csl_bwd_math(t, dt, y, k1, leaves, _torch_cts(c),
                                                RTOL, ATOL)
    got_b = [x.numpy() for x in (ct_t, ct_dt, cy, ck1, *cl[:fc.N_PARAMS])]
    assert not cl[fc.N_PARAMS].any()  # the probe's cotangent is dropped
    for j, (a, b) in enumerate(zip(got_b, want_b)):
        np.testing.assert_allclose(a, b.reshape(a.shape), rtol=2e-2, atol=5e-4,
                                   err_msg=f"output {j}")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kinetic", [False, True])
def test_hand_backward_matches_autograd_float64(shape, kinetic):
    """K8-CSL's plain version (the hand pullback, second order: sigmoid' in
    the hops, the weights' use inside W * g, the gates' and time-biases'
    t-dependence) against autograd of K7-CSL's plain version, float64, at
    rtol=atol=1e-10; every parameter, t and dt, with biases off zero."""
    batch, dim, hidden = shape
    c = _case(batch, dim, hidden, kinetic)
    f64 = torch.float64
    leaves = _torch_leaves(c, dim, hidden, f64)
    t, dt = torch.tensor(T, dtype=f64), torch.tensor(DT, dtype=f64)
    y, k1 = torch.tensor(c["y"], dtype=f64), torch.tensor(c["k1"], dtype=f64)
    inputs = [x.clone().requires_grad_(True) for x in (t, dt, y, k1, *leaves)]
    out = fc.plain_csl_normed_sweep(*inputs[:4], inputs[4:], RTOL, ATOL)
    cts = _torch_cts(c, f64)
    want = torch.autograd.grad(tuple(out), inputs, grad_outputs=cts, allow_unused=True)
    ct_t, ct_dt, cy, ck1, cl = fc._csl_bwd_math(t, dt, y, k1, leaves, cts, RTOL, ATOL)
    got = [ct_t, ct_dt, cy, ck1, *cl[:fc.N_PARAMS]]
    assert ct_t.abs().item() > 0  # the dynamics depend on t
    for j, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10,
                                   err_msg=f"output {j}")


def test_cpu_wrappers_take_plain_version_and_launch_nothing():
    """On CPU tensors the wrappers and the sweep pair are the plain versions
    (bitwise), the autograd Function's gradient is the hand backward, and
    no kernel is counted."""
    batch, dim, hidden = SHAPES[1]
    c = _case(batch, dim, hidden, True)
    leaves = [x.requires_grad_(True) for x in _torch_leaves(c, dim, hidden)]
    t, dt = torch.tensor(T), torch.tensor(DT)
    y, k1 = torch.tensor(c["y"]), torch.tensor(c["k1"])
    fc.reset_launches()
    sweep, sweep_bwd = fc.make_csl_ffjord_sweep(RTOL, ATOL)
    out = sweep(t, dt, y, k1, leaves)
    plain = fc.plain_csl_normed_sweep(t, dt, y, k1, leaves, RTOL, ATOL)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    cts = _torch_cts(c)
    grads = torch.autograd.grad(tuple(out), leaves, grad_outputs=cts)
    direct = sweep_bwd(t, dt, y, k1, leaves, cts)
    hand = fc._csl_bwd_math(t, dt, y, k1, leaves, cts, RTOL, ATOL)
    for a, b, h in zip(grads, direct[4], hand[4]):
        assert torch.equal(a, b) and torch.equal(b, h)
    assert fc.LAUNCHES == {"csl_tsit5_fwd": 0, "csl_tsit5_bwd": 0}
    names = fc.csl_unflatten_cts(direct[4])
    assert list(names) == fc.LEAF_NAMES and len(names) == fc.N_PARAMS


def test_wrappers_refuse_other_devices_and_bad_widths():
    batch, dim, hidden = SHAPES[0]
    c = _case(batch, dim, hidden, False)
    leaves = _torch_leaves(c, dim, hidden)
    t, dt = torch.tensor(T), torch.tensor(DT)
    meta = lambda a: torch.empty(a.shape, device="meta")
    with pytest.raises(RuntimeError, match="device meta"):
        fc.csl_normed_sweep(t, dt, meta(c["y"]), meta(c["k1"]), leaves, RTOL, ATOL)
    with pytest.raises(RuntimeError, match="device meta"):
        fc.csl_normed_sweep_bwd(t, dt, meta(c["y"]), meta(c["k1"]), leaves, _torch_cts(c),
                                RTOL, ATOL)
    y = torch.zeros(batch, dim + 2)
    with pytest.raises(ValueError, match="dim \\+ 1 or dim \\+ 3"):
        fc.csl_normed_sweep(t, dt, y, y, leaves, RTOL, ATOL)
    with pytest.raises(ValueError, match="15 parameters and the probe"):
        fc.csl_normed_sweep(t, dt, torch.tensor(c["y"]), torch.tensor(c["k1"]), leaves[:-1],
                            RTOL, ATOL)
