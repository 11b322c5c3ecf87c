"""K8-CSL's order of sums on the CPU (``fused_csl.plain_csl_bwd_tiles``) and
the reverse tile body's plan (``fused_csl.csl_bwd_plan``).

K8-CSL and K4-CSL run one tile body (``csrc/csl_tsit5.cuh``
``csl_reverse_tile``): 8-row tiles, each tile's parameter cotangents summed
stage by stage (6 to 1) over its rows in order, then the tiles' sums in
tile order. The schedule computes the plain backward's algebra
(``_csl_bwd_math``) in that order; here it is held to ``_csl_bwd_math`` in
float64, to float64 in float32, and to JAX's interpret-mode K8
(``make_csl_ffjord_sweep``, as ``tests/test_torch_fused_csl.py`` runs it).
The kernels themselves run only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from regneuralde_tpu_torch.ops import fused_csl as fc
from test_torch_fused_csl import ATOL, DT, RTOL, SHAPES, T, _case, _jax_sweep, _torch_cts, _torch_leaves

torch.set_num_threads(1)


def _inputs(batch, dim, hidden, kinetic, dtype, seed=0):
    c = _case(batch, dim, hidden, kinetic, seed)
    t, dt = torch.tensor(T, dtype=dtype), torch.tensor(DT, dtype=dtype)
    y = torch.tensor(c["y"], dtype=dtype)
    k1 = torch.tensor(c["k1"], dtype=dtype)
    return c, (t, dt, y, k1, _torch_leaves(c, dim, hidden, dtype), _torch_cts(c, dtype))


def _groups(out, split=True):
    """(ct_t, ct_dt), ct_y, ct_k1 and every parameter's cotangent (all of
    them as one vector unless ``split``, as ``chip_smoke.py`` groups them)."""
    ct_t, ct_dt, cy, ck1, cl = out
    params = list(cl[:fc.N_PARAMS])
    if not split:
        params = [torch.cat([x.flatten() for x in params])]
    return [torch.stack([ct_t, ct_dt]), cy, ck1, *params]


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


@pytest.mark.parametrize("rows", [1, 2, 8])
@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_matches_plain_float64(shape, kinetic, rows):
    """The schedule is ``_csl_bwd_math`` summed in another order: in float64
    (ct_t, ct_dt), ct_y, ct_k1 and the parameters' cotangents agree to
    1e-12 (relative, each group as one vector), the probe's cotangent
    zero."""
    _, args = _inputs(*shape, kinetic, torch.float64)
    got = fc.plain_csl_bwd_tiles(*args, RTOL, ATOL, rows)
    want = fc._csl_bwd_math(*args, RTOL, ATOL)
    for j, (a, b) in enumerate(zip(_groups(got, False), _groups(want, False))):
        assert a.shape == b.shape and _rel(a, b) <= 1e-12, j
    assert not got[4][fc.N_PARAMS].any()


@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("shape", [(16, 5, 8), (24, 4, 12)])
def test_schedule_float32_within_plain_distance(shape, kinetic):
    """In float32 the schedule lies from the float64 chain within 3 times
    the plain version's distance, plus 1e-6: its order of sums costs no
    more rounding than the batch sums'."""
    _, a32 = _inputs(*shape, kinetic, torch.float32, seed=3)
    _, a64 = _inputs(*shape, kinetic, torch.float64, seed=3)
    ref = _groups(fc._csl_bwd_math(*a64, RTOL, ATOL))
    plain = _groups(fc._csl_bwd_math(*a32, RTOL, ATOL))
    sched = _groups(fc.plain_csl_bwd_tiles(*a32, RTOL, ATOL))
    for j, (s, p, r) in enumerate(zip(sched, plain, ref)):
        assert _rel(s, r) <= 3 * _rel(p, r) + 1e-6, (j, _rel(s, r), _rel(p, r))


@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_matches_jax_k8_float32(shape, kinetic):
    """The schedule at 8-row tiles against JAX's interpret-mode K8 over the
    CSL dynamics, float32, at the tolerance ``test_torch_fused_csl.py``
    holds the plain version to (rtol=2e-2, atol=5e-4: the normed seeds
    multiply by 1/atol)."""
    batch, dim, hidden = shape
    c, args = _inputs(batch, dim, hidden, kinetic, torch.float32)
    _, want = _jax_sweep(c, dim, kinetic)
    got = fc.plain_csl_bwd_tiles(*args, RTOL, ATOL)
    ct_t, ct_dt, cy, ck1, cl = got
    for j, (a, b) in enumerate(zip([ct_t, ct_dt, cy, ck1, *cl[:fc.N_PARAMS]], want)):
        np.testing.assert_allclose(a.numpy(), b.reshape(a.shape), rtol=2e-2, atol=5e-4,
                                   err_msg=f"output {j}")


@pytest.mark.parametrize("rows", [2, 4, 8, 16])
@pytest.mark.parametrize("kinetic", [False, True])
@pytest.mark.parametrize("batch", [13, 7])
def test_ragged_batch(batch, kinetic, rows):
    """Batches of 13 and 7 rows (with 8-row tiles: a last tile of 5, and
    one tile of 7) at several tile row counts: float64 against
    ``_csl_bwd_math`` to 1e-12 as above, the rows' cotangents of every
    row."""
    _, args = _inputs(batch, 5, 8, kinetic, torch.float64, seed=batch)
    got = fc.plain_csl_bwd_tiles(*args, RTOL, ATOL, rows)
    want = fc._csl_bwd_math(*args, RTOL, ATOL)
    assert got[2].shape == args[2].shape and got[3].shape == args[2].shape
    for j, (a, b) in enumerate(zip(_groups(got, False), _groups(want, False))):
        assert _rel(a, b) <= 1e-12, j


@pytest.mark.parametrize("kinetic, smem", [(False, 198_188), (True, 199_404)])
def test_plan_at_ffjord_width(kinetic, smem):
    """FFJORD's tabular step (batch 1024, dim 43, hidden 100; the state 44
    or 46 wide): 8-row tiles, 128 of them (one wave on the H100's 132 SMs),
    1175 weight-cotangent tiles of 4 x 4 (at most 5 a thread), the shared
    memory a block inside the 232,448 bytes it may take, and the six stages'
    records (8 rows x 686 floats each) a block in device memory."""
    plan = fc.csl_bwd_plan(1024, 43, 100, kinetic)
    assert (plan.rows, plan.tiles, plan.cw_tiles) == (8, 128, 1175)
    assert plan.cw_tiles <= fc.CSL_BWD_MAX_TILES == 5 * 256
    assert plan.smem_bytes == smem <= fc.SMEM_LIMIT == 232_448
    assert plan.record_floats == 6 * 8 * (6 * 100 + 2 * 43)
    assert plan.tiles * plan.record_floats * 4 == 16_859_136  # bytes a launch


@pytest.mark.parametrize("width", [(43, 100), (5, 16), (5, 8), (3, 6)])
@pytest.mark.parametrize("kinetic", [False, True])
def test_plan_fits_every_kernel_width(width, kinetic):
    """Every CSL width the repo runs on a kernel route (``chip_smoke.py``,
    ``test_torch_kernels_cuda.py``) fits the body."""
    plan = fc.csl_bwd_plan(37, *width, kinetic)
    assert plan.tiles == 5 and plan.smem_bytes <= fc.SMEM_LIMIT


@pytest.mark.parametrize("width", [(43, 160), (43, 110)])
def test_plan_refuses_wider_layers(width):
    """Layers the body cannot hold are refused with a ValueError, not run
    elsewhere: at 43 x 160 the shared memory (328,268 bytes), at 43 x 110
    the weight tiles (1400 of 4 x 4, more than 5 a thread; 218,892 bytes
    would fit)."""
    with pytest.raises(ValueError, match="tile body holds at most"):
        fc.csl_bwd_plan(1024, *width, False)
