"""The port's AlternatingMLP trial step (regneuralde_tpu_torch.ops.fused_generic)
against the JAX package's generic normed sweep (regneuralde_tpu.ops.pallas_generic).

The JAX side runs ``_stage_algebra(alternating_mlp_apply(depth))`` and its
``jax.vjp`` (the generic XLA sweep, the same math as its kernels K7/K8),
and at the small shape also the Pallas kernels K7/K8 themselves in
interpret mode, as ``tests/test_pallas_generic.py`` runs them. Both
packages get the same numpy arrays from a seeded generator. The CUDA
kernels run only on the card: see ``test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_generic as jpg
from regneuralde_tpu_torch.models import AlternatingMLP
from regneuralde_tpu_torch.ops import fused_generic as fg

torch.set_num_threads(1)

RTOL = ATOL = 1e-4
T, DT = 0.07, 0.11
SCALAR_CTS = (0.7, 1.3, -0.4)
# (batch, dim, hidden, depth): the small shape, a ragged one, the latent widths
SHAPES = [(8, 6, 10, 2), (5, 6, 10, 2), (16, 20, 50, 4)]


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _case(batch, dim, hidden, depth, seed=0):
    """Leaves in the port's nn.Linear layout, ``y``, a random ``k1`` (not
    f(y): it keeps the embedded error far above its rounding floor) and
    row cotangents."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    leaves = []
    for _ in range(depth):
        leaves += [f32(rng.normal(size=(hidden, dim)) / np.sqrt(dim)),
                   f32(rng.normal(size=hidden) * 0.1),
                   f32(rng.normal(size=(dim, hidden)) / np.sqrt(hidden)),
                   f32(rng.normal(size=dim) * 0.1)]
    return dict(leaves=leaves, y=f32(rng.normal(size=(batch, dim)) * 0.5),
                k1=f32(rng.normal(size=(batch, dim)) * 0.3),
                ct_y_new=f32(rng.normal(size=(batch, dim))),
                ct_k7=f32(rng.normal(size=(batch, dim))))


def _jax_leaves(c, dtype):
    """The JAX layout: kernels (in, out), biases (1, out)."""
    out = []
    for j, a in enumerate(c["leaves"]):
        out.append(jnp.asarray(a.T if j % 2 == 0 else a[None, :], dtype))
    return out


def _jax_cts(c, dtype):
    return (jnp.asarray(c["ct_y_new"], dtype), jnp.asarray(c["ct_k7"], dtype),
            *(jnp.asarray(s, dtype) for s in SCALAR_CTS))


def _torch_args(c, dtype=torch.float32):
    tt = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    return (tt(T), tt(DT), tt(c["y"]), tt(c["k1"]), [tt(a) for a in c["leaves"]])


def _torch_cts(c, dtype=torch.float32):
    return (torch.tensor(c["ct_y_new"], dtype=dtype), torch.tensor(c["ct_k7"], dtype=dtype),
            *(torch.tensor(s, dtype=dtype) for s in SCALAR_CTS))


def _apply_f64(depth):
    """``alternating_mlp_apply`` with its products at the inputs' precision
    (the JAX package's computes them into float32)."""

    def apply_fn(t, y, leaves):
        h = jnp.tanh(y)
        for j in range(2 * depth):
            h = jnp.tanh(h @ leaves[2 * j] + leaves[2 * j + 1])
        return h

    return apply_fn


def _jax_side(c, dtype, kernels):
    """(forward quintuple, backward in the port's layout) from the generic
    XLA sweep, or from the interpret-mode K7/K8 with ``kernels``."""
    depth = len(c["leaves"]) // 4
    leaves = _jax_leaves(c, dtype)
    t, dt = jnp.asarray(T, dtype), jnp.asarray(DT, dtype)
    y, k1 = jnp.asarray(c["y"], dtype), jnp.asarray(c["k1"], dtype)
    if kernels:
        sweep, sweep_bwd, _ = jpg.make_normed_tsit5_sweep(
            jpg.alternating_mlp_apply(depth), [False] * len(leaves), RTOL, ATOL)
        fwd = tuple(sweep(t, dt, y, k1, leaves))
        bwd = sweep_bwd(t, dt, y, k1, leaves, _jax_cts(c, dtype))
    else:
        apply = jpg.alternating_mlp_apply(depth) if dtype == jnp.float32 else _apply_f64(depth)
        alg = jpg._stage_algebra(apply, RTOL, ATOL)
        fwd, vjp = jax.vjp(alg, t, dt, y, k1, leaves)
        bwd = vjp(_jax_cts(c, dtype))
    ct_t, ct_dt, cy, ck1, cl = bwd
    flat = [np.asarray(ct_t), np.asarray(ct_dt), np.asarray(cy), np.asarray(ck1)]
    for j, g in enumerate(cl):
        flat.append(np.asarray(g).T if j % 2 == 0 else np.asarray(g)[0])
    return [np.asarray(x) for x in fwd], flat


def _flat(g):
    ct_t, ct_dt, cy, ck1, leaves = g
    return [x.detach().numpy() for x in (ct_t, ct_dt, cy, ck1, *leaves)]


FWD_NAMES = ["y_new", "k7", "err_ssq", "num_ssq", "den_ssq"]


@pytest.mark.parametrize("shape, kernels", [(s, False) for s in SHAPES]
                         + [(s, True) for s in SHAPES[:2]])
def test_plain_k7_k8_match_jax_float32(shape, kernels):
    """float32. ``kernels``: JAX's interpret-mode K7/K8 (small shapes only),
    else its generic XLA sweep and ``jax.vjp``. Forward: y_new and k7 at
    rtol=2e-5, atol=5e-7 (ATen's and XLA's tanh differ by an ulp in some
    arguments; four ulps at 1.0), the three norm sums at rtol=1e-4 (the
    embedded error cancels O(1) stage values, so it carries those ulps
    relatively larger). Backward: rtol=2e-2, atol=5e-4, the JAX package's
    own tolerance for the normed backward (its seeds multiply by 1/atol
    and amplify float32 rounding, tests/test_pallas_fused.py:180-188);
    ``ct_t`` is exactly zero on both sides."""
    c = _case(*shape)
    want_f, want_b = _jax_side(c, jnp.float32, kernels)
    t, dt, y, k1, leaves = _torch_args(c)
    got_f = fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves, RTOL, ATOL)
    for a, b, name in zip(got_f, want_f, FWD_NAMES):
        rtol = 2e-5 if name in ("y_new", "k7") else 1e-4
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=5e-7, err_msg=name)
    got_b = _flat(fg._altmlp_bwd_math(t, dt, y, k1, leaves, _torch_cts(c), RTOL, ATOL))
    assert got_b[0] == 0.0 and want_b[0] == 0.0
    for j, (a, b) in enumerate(zip(got_b, want_b)):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=5e-4, err_msg=f"output {j}")


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k7_k8_match_jax_float64(x64, shape):
    """float64, free of float32 noise (the JAX algebra with its products in
    float64): the forward at rtol=1e-12, the hand backward against
    ``jax.vjp`` at rtol=1e-9, atol=1e-9 (the norm-sum seeds scale by
    1/atol = 1e4)."""
    c = _case(*shape)
    want_f, want_b = _jax_side(c, jnp.float64, kernels=False)
    t, dt, y, k1, leaves = _torch_args(c, torch.float64)
    got_f = fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves, RTOL, ATOL)
    for a, b, name in zip(got_f, want_f, FWD_NAMES):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-14, err_msg=name)
    got_b = _flat(fg._altmlp_bwd_math(t, dt, y, k1, leaves, _torch_cts(c, torch.float64),
                                      RTOL, ATOL))
    for j, (a, b) in enumerate(zip(got_b, want_b)):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=f"output {j}")


@pytest.mark.parametrize("shape", SHAPES)
def test_hand_backward_matches_autograd_float64(shape):
    """K8's plain version against autograd of K7's plain version, float64,
    at rtol=atol=1e-10."""
    c = _case(*shape)
    f64 = torch.float64
    t, dt, y, k1, leaves = _torch_args(c, f64)
    inputs = [x.clone().requires_grad_(True) for x in (t, dt, y, k1, *leaves)]
    out = fg.plain_altmlp_normed_sweep(*inputs[:4], inputs[4:], RTOL, ATOL)
    cts = _torch_cts(c, f64)
    want = torch.autograd.grad(tuple(out), inputs, grad_outputs=cts, allow_unused=True)
    want = [torch.zeros_like(x) if g is None else g for g, x in zip(want, inputs)]
    got = _flat(fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, RTOL, ATOL))
    for j, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-10, atol=1e-10,
                                   err_msg=f"output {j}")


def test_max_subgradient_splits_ties_like_autograd_and_jax():
    """The hand chain's ``max(|y|, |y_new|)`` pullback (``_max_grad``, the
    same rule as K8): all of the cotangent to the larger argument, half to
    each on a tie, as autograd of ``torch.maximum`` and ``jax.vjp`` of
    ``jnp.maximum`` give (exact)."""
    a = torch.tensor([1.0, -2.0, 3.0, 0.5, -0.5, 0.0])
    b = torch.tensor([0.5, -2.0, 4.0, 0.5, 0.5, 0.0])
    g = torch.tensor([2.0, 4.0, 8.0, -6.0, 10.0, 12.0])
    ad = [x.clone().requires_grad_(True) for x in (a, b)]
    want = torch.autograd.grad(torch.maximum(*ad), ad, grad_outputs=g)
    _, vjp = jax.vjp(jnp.maximum, jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    jwant = vjp(jnp.asarray(g.numpy()))
    for got, w, jw in ((fg._max_grad(a, b, g), want[0], jwant[0]),
                       (fg._max_grad(b, a, g), want[1], jwant[1])):
        assert torch.equal(got, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jw))


def test_module_apply_and_leaves_match_flax():
    """``AlternatingMLP`` and ``alternating_mlp_apply`` over its leaves
    against flax's ``AlternatingMLP`` and each other on the same weights
    (rtol=2e-6, atol=1e-7); the leaves come in ``parameters()`` order."""
    from regneuralde_tpu.models import AlternatingMLP as JAltMLP

    c = _case(5, 6, 10, 2)
    m = AlternatingMLP(6, 10, 2, device="cpu")
    with torch.no_grad():
        for x, a in zip(m.parameters(), c["leaves"]):
            x.copy_(torch.from_numpy(a))
    assert [n for n, _ in m.named_parameters()] == [
        "up_0.weight", "up_0.bias", "down_0.weight", "down_0.bias",
        "up_1.weight", "up_1.bias", "down_1.weight", "down_1.bias"]
    assert all(a is b for a, b in zip(fg.alternating_mlp_leaves(m), m.parameters()))
    jl = _jax_leaves(c, jnp.float32)
    params = {"params": {f"{n}_{i}": {"kernel": jl[4 * i + 2 * (n == "down")],
                                      "bias": jl[4 * i + 2 * (n == "down") + 1][0]}
                         for i in range(2) for n in ("up", "down")}}
    want = np.asarray(JAltMLP(dim=6, hidden=10, depth=2).apply(params, jnp.asarray(c["y"])))
    y = torch.from_numpy(c["y"])
    got = m(y).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
    # the apply sums each affine map in float64 and rounds once, the
    # module's nn.Linear in float32: ulps apart
    apply = fg.alternating_mlp_apply(2)(None, y, tuple(m.parameters())).detach().numpy()
    np.testing.assert_allclose(apply, got, rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(apply, want, rtol=2e-6, atol=1e-7)
    cts = fg.alternating_mlp_unflatten_cts(m, [torch.zeros_like(x) for x in m.parameters()])
    assert list(cts) == [n for n, _ in m.named_parameters()]


def test_cpu_wrappers_take_plain_version_and_launch_nothing():
    """On CPU tensors the wrappers and the sweep pair are the plain
    versions (bitwise), the autograd Function's gradient is the hand
    backward, and no kernel is counted."""
    c = _case(5, 6, 10, 2)
    t, dt, y, k1, leaves = _torch_args(c)
    fg.reset_launches()
    sweep, sweep_bwd = fg.make_alternating_mlp_sweep(RTOL, ATOL)
    leaves = [x.requires_grad_(True) for x in leaves]
    out = sweep(t, dt, y, k1, leaves)
    plain = fg.plain_altmlp_normed_sweep(t, dt, y, k1, leaves, RTOL, ATOL)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    cts = _torch_cts(c)
    grads = torch.autograd.grad(tuple(out), leaves, grad_outputs=cts)
    direct = sweep_bwd(t, dt, y, k1, leaves, cts)
    hand = fg._altmlp_bwd_math(t, dt, y, k1, leaves, cts, RTOL, ATOL)
    for a, b, h in zip(grads, direct[4], hand[4]):
        assert torch.equal(a, b) and torch.equal(b, h)
    assert fg.LAUNCHES == {"altmlp_tsit5_fwd": 0, "altmlp_tsit5_bwd": 0}


def test_wrappers_refuse_other_devices():
    c = _case(5, 6, 10, 2)
    meta = lambda a: torch.empty(a.shape, device="meta")
    t, dt, _, _, leaves = _torch_args(c)
    with pytest.raises(RuntimeError, match="device meta"):
        fg.altmlp_normed_sweep(t, dt, meta(c["y"]), meta(c["k1"]), leaves, RTOL, ATOL)
    with pytest.raises(RuntimeError, match="device meta"):
        fg.altmlp_normed_sweep_bwd(t, dt, meta(c["y"]), meta(c["k1"]), leaves,
                                   _torch_cts(c), RTOL, ATOL)
