"""K7's order of sums on the CPU (``fused_generic.plain_altmlp_fwd_tiles``)
and the forward tile body's plan (``fused_generic.altmlp_fwd_plan``).

K7 and K3 for AlternatingMLP run one forward tile body
(``csrc/altmlp_tsit5.cuh`` ``altmlp_forward_tile``): 2-row tiles, each
affine map an f64 sum split over lanes of a warp (lane s the terms s, s +
S, ..., a butterfly adding the lanes' partials) rounded once to f32, then
the norm sums one slot a 2-row sub-tile, summed as the body before it
summed them. The schedule computes the rows in that order of sums; here it
is held to the plain version (``plain_altmlp_normed_sweep``, bitwise in
float32, to 1e-12 in float64), its sums to float32 rounding of their
float64 sum, and to JAX's interpret-mode K7 (``make_normed_tsit5_sweep``,
as ``tests/test_torch_fused_generic.py`` runs it). The kernels themselves
run only on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_generic as jpg
from regneuralde_tpu_torch.ops import fused_generic as fg
from regneuralde_tpu_torch.ops.ode import normed_terms
from test_torch_fused_generic import (ATOL, DT, FWD_NAMES, RTOL, SHAPES, T, _case, _jax_leaves,
                                      _torch_args)

torch.set_num_threads(1)


def _args(batch, dim, hidden, depth, dtype=torch.float32, seed=0):
    c = _case(batch, dim, hidden, depth, seed)
    return c, _torch_args(c, dtype)


def _assert_rows_plain(args, tol=RTOL):
    """The schedule's y_new and k7 are the plain version's bitwise; returns
    both quintuples."""
    sched = fg.plain_altmlp_fwd_tiles(*args, tol, tol)
    plain = fg.plain_altmlp_normed_sweep(*args, tol, tol)
    assert torch.equal(sched.y_new, plain.y_new) and torch.equal(sched.k_last, plain.k_last)
    return sched, plain


@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_rows_are_plain(shape, seed, tol):
    """In float32 the schedule's rows (each affine map summed in the
    kernel's split float64 order, rounded once) are the plain version's
    (its float64 addmm) bitwise, and its three sums the plain version's up
    to their order of summation (1e-6 relative)."""
    _, args = _args(*shape, seed=seed)
    sched, plain = _assert_rows_plain(args, tol)
    for a, b in zip(sched[2:], plain[2:]):
        assert a.dtype == torch.float32 and abs(a.item() - b.item()) <= 1e-6 * abs(b.item())


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("width", [(6, 10), (20, 50)])
@pytest.mark.parametrize("batch", [13, 7])
def test_ragged_batches_at_every_depth(batch, width, depth):
    """Ragged batches (a last 2-row slot of one row) at depths 1, 2 and 4:
    the rows bitwise the plain version's, one sum a quantity."""
    _, args = _args(batch, *width, depth, seed=batch + depth)
    sched, _ = _assert_rows_plain(args)
    assert sched.y_new.shape == (batch, width[0])
    assert all(x.shape == () for x in sched[2:])


def _chain(batch, dim):
    """The most float32 additions a term of the kernel's sums goes through:
    its thread's (one a lap of 256 over the slot's 2 x dim elements), the
    warp's shuffle tree (5), the warps (8), a lane's slots and the last
    shuffle tree (5)."""
    slots = -(-batch // fg.ALT_SLOT_ROWS)
    return -(-fg.ALT_SLOT_ROWS * dim // 256) + 5 + 8 + -(-slots // 32) + 5


@pytest.mark.parametrize("shape", [*SHAPES, (256, 20, 50, 4), (13, 5, 7, 1)])
def test_sums_within_float32_rounding(shape):
    """Each of the schedule's three sums (float32) lies within float32
    rounding of the float64 sum of the same float32 terms: each term, a
    square, passes through at most ``_chain`` additions, so the error is
    below that many units of roundoff of the sum."""
    _, args = _args(*shape, seed=4)
    sched = fg.plain_altmlp_fwd_tiles(*args, RTOL, ATOL)
    _, _, *terms = normed_terms(fg._split_apply(shape[3]), *args, RTOL, ATOL)
    for got, x in zip(sched[2:], terms):
        exact = x.double().sum().item()
        assert got.dtype == torch.float32
        assert abs(got.item() - exact) <= _chain(shape[0], shape[1]) * 2.0 ** -24 * exact


@pytest.mark.parametrize("shape", [*SHAPES, (13, 5, 7, 1), (7, 6, 10, 3)])
def test_schedule_matches_plain_float64(shape):
    """In float64 the schedule is the plain version summed in another
    order: every output within 1e-12 (relative to its largest element)."""
    _, args = _args(*shape, dtype=torch.float64, seed=5)
    sched = fg.plain_altmlp_fwd_tiles(*args, RTOL, ATOL)
    plain = fg.plain_altmlp_normed_sweep(*args, RTOL, ATOL)
    for a, b, name in zip(sched, plain, FWD_NAMES):
        assert a.dtype == torch.float64
        assert (a - b).abs().max().item() <= 1e-12 * b.abs().max().item(), name


def _jax_fwd(c):
    """The forward quintuple of JAX's interpret-mode K7 over AlternatingMLP."""
    depth = len(c["leaves"]) // 4
    sweep, _, _ = jpg.make_normed_tsit5_sweep(jpg.alternating_mlp_apply(depth),
                                              [False] * 4 * depth, RTOL, ATOL)
    out = sweep(jnp.float32(T), jnp.float32(DT), jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
                _jax_leaves(c, jnp.float32))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape", SHAPES[:2])
def test_schedule_matches_jax_k7_float32(shape, seed):
    """The schedule against JAX's interpret-mode K7, float32, at the
    tolerances ``test_torch_fused_generic.py`` holds the plain version to:
    y_new and k7 at rtol=2e-5, the three sums at rtol=1e-4 (atol=5e-7)."""
    c, args = _args(*shape, seed=seed)
    want = _jax_fwd(c)
    got = fg.plain_altmlp_fwd_tiles(*args, RTOL, ATOL)
    for a, b, name in zip(got, want, FWD_NAMES):
        rtol = 2e-5 if name in ("y_new", "k7") else 1e-4
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=5e-7, err_msg=name)


@pytest.mark.parametrize("n, lanes", [(5, 1), (7, 1), (10, 2), (20, 4), (50, 8), (300, 32)])
def test_forward_split(n, lanes):
    """A forward sum of n terms is shared by the fewest lanes (a power of
    two, at most a warp) that leave each at most ALT_FWD_CHAIN = 7 terms: at
    the latent widths 4 lanes for the up layers' 20-term sums, 8 for the
    down layers' 50-term ones."""
    assert fg._split(n, fg.ALT_FWD_CHAIN) == lanes


def test_plan_at_latent_width():
    """The latent cell (batch 256, AlternatingMLP(20, 50, 4)): 2-row tiles,
    128 of them (one wave on the H100's 132 SMs, K3's grid one tile a
    block), 128 norm-sum slots of 2 rows, and the leaves (33,152 bytes,
    rows unpadded, each leaf from a 16-byte boundary) and the tile in 36,528
    bytes of shared memory a block."""
    plan = fg.altmlp_fwd_plan(256, 20, 50, 4)
    assert (plan.rows, plan.slot_rows, plan.tiles, plan.slots) == (2, 2, 128, 128)
    assert plan.smem_bytes == 36_528 <= fg.SMEM_LIMIT


@pytest.mark.parametrize("depth", range(1, 9))
def test_plan_takes_every_depth(depth):
    """Every depth the kernels take (1 to 8: ``regnde_altmlp_max_depth``)
    fits at the latent width: 8,288 bytes of leaves a depth level beside a
    tile of 3,376 bytes."""
    plan = fg.altmlp_fwd_plan(256, 20, 50, depth)
    assert plan.tiles == 128 and plan.smem_bytes == 8_288 * depth + 3_376 <= fg.SMEM_LIMIT


@pytest.mark.parametrize("width, depth", [((20, 50), 2), ((6, 10), 2), ((5, 7), 4),
                                          ((20, 300), 4), ((200, 8), 1)])
def test_plan_fits_every_kernel_width(width, depth):
    """Every AlternatingMLP width the repo runs on a kernel route
    (``chip_smoke.py``, ``test_torch_kernels_cuda.py``) fits the body; a
    ragged batch of 37 rows takes 19 tiles and 19 slots."""
    plan = fg.altmlp_fwd_plan(37, *width, depth)
    assert (plan.tiles, plan.slots) == (19, 19) and plan.smem_bytes <= fg.SMEM_LIMIT


@pytest.mark.parametrize("width, depth, smem", [((20, 1000), 4, 690_032),
                                                ((400, 400), 1, 1_328_112)])
def test_plan_refuses_wider_layers(width, depth, smem):
    """Widths whose weights and tile need more shared memory than a block
    has are refused with a ValueError, not run elsewhere."""
    with pytest.raises(ValueError, match=f"forward tile body holds at most .* need {smem}"):
        fg.altmlp_fwd_plan(256, *width, depth)
