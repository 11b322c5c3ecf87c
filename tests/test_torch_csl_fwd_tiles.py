"""K7-CSL's order of sums on the CPU (``fused_csl.plain_csl_fwd_tiles``,
``fused_csl.csl_slot_order_sums``) and the forward tile body's plan
(``fused_csl.csl_fwd_plan``).

K7-CSL and K3-CSL run one forward tile body (``csrc/csl_tsit5.cuh``
``csl_forward_tile``): 8-row tiles, each writing its three norm sums as one
slot a 2-row sub-tile, each slot reduced as a block of its own reduces two
rows, then the slots summed lane-strided over one warp. The rows are the
plain version's bitwise; the sums are the plain version's terms in that
order. Here the schedule is held to the plain version, to float64 and to
JAX's interpret-mode K7 (``make_csl_ffjord_sweep``, as
``tests/test_torch_fused_csl.py`` runs it). The kernels themselves run only
on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_generic as jpg
from regneuralde_tpu_torch.ops import fused_csl as fc
from test_torch_fused_csl import ATOL, DT, FWD_NAMES, RTOL, SHAPES, T, _case, _torch_leaves

torch.set_num_threads(1)


def _inputs(batch, dim, hidden, kinetic, dtype, seed=0):
    c = _case(batch, dim, hidden, kinetic, seed)
    tt = lambda a: torch.tensor(a, dtype=dtype)
    return c, (tt(T), tt(DT), tt(c["y"]), tt(c["k1"]), _torch_leaves(c, dim, hidden, dtype))


def _chain(batch, width):
    """The most float32 additions a term of the kernel's sums goes through:
    its thread's (one a lap of 256 over the slot's 2 x width elements), the
    warp's shuffle tree (5), the warps (8), a lane's slots and the last
    shuffle tree (5)."""
    slots = -(-batch // fc.CSL_SLOT_ROWS)
    return -(-fc.CSL_SLOT_ROWS * width // 256) + 5 + 8 + -(-slots // 32) + 5


@pytest.mark.parametrize("kinetic, smem", [(False, 119_548), (True, 120_188)])
def test_plan_at_ffjord_width(kinetic, smem):
    """FFJORD's tabular step (batch 1024, dim 43, hidden 100; the state 44
    or 46 wide): 8-row tiles, 128 of them (one wave on the H100's 132 SMs,
    and K3-CSL's grid one tile a block), 512 norm-sum slots of 2 rows, and
    the parameters (79,260 bytes) and the tile in one block's shared
    memory, well inside the 232,448 bytes it may take."""
    plan = fc.csl_fwd_plan(1024, 43, 100, kinetic)
    assert (plan.rows, plan.slot_rows, plan.tiles, plan.slots) == (8, 2, 128, 512)
    assert plan.smem_bytes == smem <= fc.SMEM_LIMIT == 232_448
    assert plan.rows == fc.CSL_BWD_ROWS  # the reverse's tile


@pytest.mark.parametrize("width", [(43, 100), (5, 16), (5, 8), (3, 6)])
@pytest.mark.parametrize("kinetic", [False, True])
def test_plan_fits_every_kernel_width(width, kinetic):
    """Every CSL width the repo runs on a kernel route (``chip_smoke.py``,
    ``test_torch_kernels_cuda.py``) fits the body; a ragged batch of 37
    rows takes 5 tiles and 19 slots."""
    plan = fc.csl_fwd_plan(37, *width, kinetic)
    assert (plan.tiles, plan.slots) == (5, 19) and plan.smem_bytes <= fc.SMEM_LIMIT


@pytest.mark.parametrize("width, smem", [((43, 170), 236_412), ((43, 200), 297_948)])
def test_plan_refuses_wider_layers(width, smem):
    """Layers whose parameters and tile do not fit one block's shared
    memory are refused with a ValueError, not run elsewhere (43 x 160 still
    fits: 216,988 bytes)."""
    with pytest.raises(ValueError, match=f"tile body holds at most .* need {smem}"):
        fc.csl_fwd_plan(1024, *width, False)
    assert fc.csl_fwd_plan(1024, 43, 160, False).smem_bytes == 216_988


# (batch, width): FFJORD's, ragged batches (a last slot of one row), one
# row, and slots of more than 256 elements (a thread takes several)
ORDER_SHAPES = [(1024, 44), (1024, 46), (1023, 46), (13, 44), (7, 4), (1, 6), (5, 300),
                (9, 129)]


@pytest.mark.parametrize("batch, width", ORDER_SHAPES)
def test_slot_order_sums_take_every_element_once(batch, width):
    """The kernel's order of summation over every slot, thread, warp and
    lane takes each element of the batch exactly once: integer terms, exact
    in float64, sum to their total, and ones to B x width."""
    rng = np.random.default_rng(batch)
    ones = torch.ones(batch, width, dtype=torch.float64)
    ints = torch.tensor(rng.integers(0, 1000, size=(batch, width)), dtype=torch.float64)
    got_ones, got_ints = fc.csl_slot_order_sums([ones, ints])
    assert got_ones.item() == batch * width
    assert got_ints.item() == ints.sum().item()


@pytest.mark.parametrize("batch, width", ORDER_SHAPES)
def test_slot_order_sums_float32_within_rounding(batch, width):
    """In float32 the kernel's order lies within float32 rounding of the
    float64 sum, as ``torch.sum`` does: each term (non-negative, as the
    norms' squares) passes through at most ``_chain`` additions, so the
    error is below that many units of roundoff of the sum."""
    rng = np.random.default_rng(batch + 1)
    x = torch.tensor(rng.random((batch, width)) ** 4, dtype=torch.float32)
    (got,) = fc.csl_slot_order_sums([x])
    exact = x.double().sum().item()
    bound = _chain(batch, width) * 2.0 ** -24 * exact
    assert got.dtype == torch.float32
    assert abs(got.item() - exact) <= bound
    assert abs(torch.sum(x).item() - exact) <= bound


@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("shape", [*SHAPES, (13, 5, 8)])
def test_schedule_rows_are_plain(shape, kinetic):
    """The schedule's rows are ``plain_csl_normed_sweep``'s bitwise in
    float32, and its sums the plain version's up to the order of summation:
    within 1e-6 (relative) in float32 and 1e-12 in float64."""
    batch, dim, hidden = shape
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        _, args = _inputs(batch, dim, hidden, kinetic, dtype, seed=2)
        sched = fc.plain_csl_fwd_tiles(*args, RTOL, ATOL)
        plain = fc.plain_csl_normed_sweep(*args, RTOL, ATOL)
        assert torch.equal(sched.y_new, plain.y_new) and torch.equal(sched.k_last, plain.k_last)
        for a, b in zip(sched[2:], plain[2:]):
            assert a.dtype == dtype and abs(a.item() - b.item()) <= tol * abs(b.item())


def _jax_fwd(c, dim, kinetic):
    """The forward quintuple of JAX's ``make_csl_ffjord_sweep``
    (interpret-mode K7)."""
    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    fwd, _ = jpg.make_csl_ffjord_sweep(params, jnp.asarray(c["e"]), dim, kinetic, RTOL, ATOL)
    out = fwd(jnp.float32(T), jnp.float32(DT), jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
              params)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_matches_jax_k7_float32(shape, kinetic, seed):
    """The schedule against JAX's interpret-mode K7 over the CSL dynamics,
    float32, at the tolerances ``test_torch_fused_csl.py`` holds the plain
    version to: y_new and k7 at rtol=2e-5, the three sums at rtol=1e-4
    (atol=5e-7)."""
    batch, dim, hidden = shape
    c, args = _inputs(batch, dim, hidden, kinetic, torch.float32, seed)
    want = _jax_fwd(c, dim, kinetic)
    got = fc.plain_csl_fwd_tiles(*args, RTOL, ATOL)
    for a, b, name in zip(got, want, FWD_NAMES):
        rtol = 2e-5 if name in ("y_new", "k7") else 1e-4
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=5e-7, err_msg=name)
