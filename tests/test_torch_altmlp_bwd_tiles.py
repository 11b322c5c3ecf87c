"""K8's order of sums on the CPU (``fused_generic.plain_altmlp_bwd_tiles``)
and the reverse tile body's plan (``fused_generic.altmlp_bwd_plan``).

K8 and K4 for AlternatingMLP run one tile body (``csrc/altmlp_tsit5.cuh``
``altmlp_reverse_tile``): 2-row tiles, each weight and bias cotangent
summed over the tile's rows in order, stage after stage (6 to 1), each input
cotangent's sum split over lanes and added pairwise, the tile's ct_dt summed
in float64, then the tiles' sums in tile order. The schedule computes the
plain backward's algebra (``_altmlp_bwd_math``) in that order; here it is
held to ``_altmlp_bwd_math`` in float64, to float64 in float32, and to JAX's
interpret-mode K8 (``make_normed_tsit5_sweep``, as
``tests/test_torch_fused_generic.py`` runs it). The kernels themselves run
only on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu_torch.ops import fused_generic as fg
from test_torch_fused_generic import ATOL, DT, RTOL, T, _case, _jax_side, _torch_args, _torch_cts

torch.set_num_threads(1)


def _inputs(batch, dim, hidden, depth, dtype, seed=0):
    c = _case(batch, dim, hidden, depth, seed)
    t, dt, y, k1, leaves = _torch_args(c, dtype)
    return c, (t, dt, y, k1, leaves, _torch_cts(c, dtype))


def _groups(out, split=True):
    """(ct_t, ct_dt), ct_y, ct_k1 and every leaf's cotangent (all of them
    as one vector unless ``split``, as ``chip_smoke.py`` groups them)."""
    ct_t, ct_dt, cy, ck1, cl = out
    leaves = list(cl) if split else [torch.cat([x.flatten() for x in cl])]
    return [torch.stack([ct_t, ct_dt]), cy, ck1, *leaves]


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


@pytest.mark.parametrize("rows", [2, 4, 8])
@pytest.mark.parametrize("shape", [(8, 6, 10, 2), (16, 20, 50, 4), (16, 20, 50, 1)])
def test_schedule_matches_plain_float64(shape, rows):
    """The schedule is ``_altmlp_bwd_math`` summed in another order: in
    float64 (ct_t, ct_dt), ct_y, ct_k1 and the leaves' cotangents agree to
    1e-12 (relative, each group as one vector); ct_t is exactly zero."""
    _, args = _inputs(*shape, torch.float64)
    got = fg.plain_altmlp_bwd_tiles(*args, RTOL, ATOL, rows)
    want = fg._altmlp_bwd_math(*args, RTOL, ATOL)
    for j, (a, b) in enumerate(zip(_groups(got, False), _groups(want, False))):
        assert a.shape == b.shape and _rel(a, b) <= 1e-12, j
    assert got[0].item() == 0.0


@pytest.mark.parametrize("shape", [(16, 6, 10, 2), (24, 20, 50, 4)])
def test_schedule_float32_within_plain_distance(shape):
    """In float32 the schedule lies from the float64 chain within 3 times
    the plain version's distance, plus 1e-6: its order of sums costs no
    more rounding than the batch sums'."""
    _, a32 = _inputs(*shape, torch.float32, seed=3)
    _, a64 = _inputs(*shape, torch.float64, seed=3)
    ref = _groups(fg._altmlp_bwd_math(*a64, RTOL, ATOL))
    plain = _groups(fg._altmlp_bwd_math(*a32, RTOL, ATOL))
    sched = _groups(fg.plain_altmlp_bwd_tiles(*a32, RTOL, ATOL))
    for j, (s, p, r) in enumerate(zip(sched, plain, ref)):
        assert _rel(s, r) <= 3 * _rel(p, r) + 1e-6, (j, _rel(s, r), _rel(p, r))


@pytest.mark.parametrize("shape", [(8, 6, 10, 2), (5, 6, 10, 2), (9, 6, 10, 1)])
def test_schedule_matches_jax_k8_float32(shape):
    """The schedule at 2-row tiles against JAX's interpret-mode K8 over
    AlternatingMLP, float32, at the tolerance ``test_torch_fused_generic.py``
    holds the plain version to (rtol=2e-2, atol=5e-4: the normed seeds
    multiply by 1/atol)."""
    c, args = _inputs(*shape, torch.float32)
    _, want = _jax_side(c, jnp.float32, True)
    got = fg.plain_altmlp_bwd_tiles(*args, RTOL, ATOL)
    ct_t, ct_dt, cy, ck1, cl = got
    for j, (a, b) in enumerate(zip([ct_t, ct_dt, cy, ck1, *cl], want)):
        np.testing.assert_allclose(a.numpy(), b.reshape(a.shape), rtol=2e-2, atol=5e-4,
                                   err_msg=f"output {j}")


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("rows", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("batch", [13, 7])
def test_ragged_batch(batch, rows, depth):
    """Batches of 13 and 7 rows (at 8-row tiles a last tile of 5, and one
    tile of 7) at tile row counts 2 to 8 and depths 1, 2 and 4: float64
    against ``_altmlp_bwd_math`` to 1e-12 as above, the rows' cotangents of
    every row."""
    _, args = _inputs(batch, 5, 7, depth, torch.float64, seed=batch + rows)
    got = fg.plain_altmlp_bwd_tiles(*args, RTOL, ATOL, rows)
    want = fg._altmlp_bwd_math(*args, RTOL, ATOL)
    assert got[2].shape == args[2].shape and got[3].shape == args[2].shape
    for j, (a, b) in enumerate(zip(_groups(got, False), _groups(want, False))):
        assert _rel(a, b) <= 1e-12, j


@pytest.mark.parametrize("n, lanes", [(1, 1), (7, 1), (8, 2), (14, 2), (15, 4), (20, 4),
                                      (28, 4), (29, 8), (50, 8), (56, 8), (57, 16), (100, 16),
                                      (784, 32)])
def test_split_keeps_chains_short(n, lanes):
    """A sum of n terms is shared by the fewest lanes (a power of two, at
    most a warp) that leave each at most ALT_CHAIN = 7 terms: at the latent
    widths 4 lanes for the 20-term sums, 8 for the 50-term ones."""
    assert fg._split(n) == lanes


def test_split_matmul_is_a_matmul():
    """The split sum adds every term once (float64, to 1e-12)."""
    rng = np.random.default_rng(5)
    for n in (1, 20, 50, 111):
        v = torch.tensor(rng.normal(size=(3, n)))
        W = torch.tensor(rng.normal(size=(n, 7)))
        assert _rel(fg._split_matmul(v, W), v @ W) <= 1e-12


def test_plan_at_latent_width():
    """The latent cell (batch 256, AlternatingMLP(20, 50, 4)): 2-row tiles,
    128 of them (one wave on the H100's 132 SMs), every cotangent in
    registers, 48,240 bytes of shared memory a block, and the records of
    stages 1 to 4 (2 rows x 288 floats each) a block in device memory."""
    plan = fg.altmlp_bwd_plan(256, 20, 50, 4)
    assert (plan.rows, plan.tiles, plan.cw_in_smem) == (2, 128, False)
    assert plan.smem_bytes == 48_240 <= fg.SMEM_LIMIT
    assert plan.record_floats == 4 * 2 * 4 * (20 + 52)


@pytest.mark.parametrize("depth", range(1, 9))
def test_plan_takes_every_depth(depth):
    """Every depth the kernels take (1 to 8: ``regnde_altmlp_max_depth``)
    fits at the latent width; past depth 4 the cotangents of the deeper
    layers are held in shared memory."""
    plan = fg.altmlp_bwd_plan(256, 20, 50, depth)
    assert plan.smem_bytes <= fg.SMEM_LIMIT and plan.tiles == 128
    assert plan.cw_in_smem == (depth > 4)


@pytest.mark.parametrize("width, depth, in_smem", [((20, 50), 2, False), ((6, 10), 2, False),
                                                   ((5, 7), 4, False), ((20, 300), 1, True),
                                                   ((200, 8), 1, True)])
def test_plan_fits_every_kernel_width(width, depth, in_smem):
    """Every AlternatingMLP width the repo runs on a kernel route
    (``chip_smoke.py``, ``test_torch_kernels_cuda.py``) fits the body, and
    so do layers of more outputs or 2 x 2 weight tiles than a block has
    threads (their cotangents then in shared memory)."""
    plan = fg.altmlp_bwd_plan(37, *width, depth)
    assert plan.tiles == 19 and plan.smem_bytes <= fg.SMEM_LIMIT
    assert plan.cw_in_smem == in_smem


@pytest.mark.parametrize("width, depth", [((20, 1000), 4), ((400, 400), 1)])
def test_plan_refuses_wider_layers(width, depth):
    """Widths whose weights and tile need more shared memory than a block
    has are refused with a ValueError, not run elsewhere."""
    with pytest.raises(ValueError, match="reverse tile body holds at most"):
        fg.altmlp_bwd_plan(256, *width, depth)
