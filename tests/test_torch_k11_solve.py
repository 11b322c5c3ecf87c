"""K11, the lane-wise Tsit5 step (``csrc/mlp_step_solve.cuh`` with ``LaneEnd``),
on the CPU: one launch in the kernel's own schedule
(``whole_solve.plain_lanes_solve_step``: K3's six stages on K12's tile plan
at every row's own ``(t, dt)``, rounded by the ``F64`` policy, phase A's
float64 partials of ``y_i W1x^T`` summed over column blocks in block order,
each affine map rounded once to float32, then each tile's rows ``(y_new,
k7, err, k6, g6)``) against the plain step
``fused_mlp_lanes._reference_sweep_lanes`` and against the JAX package's
K11, ``pallas_mlp._pallas_sweep_lanes`` (run in interpret mode, as the JAX
package's own tests run it on the CPU).

Both packages get the same numpy arrays from a seeded generator: per-row t
over [0, 1.2] and dt over [1e-3, 0.3], every fifth lane finished (dt = 0).
The plans: the card's (``walk_plan`` on 132 multiprocessors with K12's
state), three column blocks over a ragged D (the last block narrower), a
card of 8 multiprocessors (row chunks) and the flagship's 32 x 100 tiles at
512x784x100 (float64 and float32 only). The kernel itself runs only on the
card: ``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phases 22-24.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import fused_mlp_lanes as fl
from regneuralde_tpu_torch.ops import whole_solve as ws

torch.set_num_threads(1)

NAMES = ["y_new", "k7", "err", "k6", "g6"]


def _case(B, D, H, seed=0, scale=1.0):
    """Leaves at ``scale`` times LeCun's, y, a random k1 and per-row (t,
    dt) with every fifth lane finished."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    dt = f32(rng.uniform(1e-3, 0.3, B))
    dt[::5] = 0.0
    return dict(
        W1=f32(rng.normal(size=(H, D + 1)) * scale / np.sqrt(D + 1)),
        b1=f32(rng.normal(size=H) * 0.1),
        W2=f32(rng.normal(size=(D, H + 1)) * scale / np.sqrt(H + 1)),
        b2=f32(rng.normal(size=D) * 0.1),
        y=f32(rng.normal(size=(B, D)) * 0.5),
        k1=f32(rng.normal(size=(B, D)) * 0.3),
        t=f32(rng.uniform(0.0, 1.2, B)),
        dt=dt,
    )


def _plan(B, D, H, kind):
    """The tile plan of ``kind`` with K12's state: the card's, three column
    blocks of ``ceil(D / 3)`` rounded to the column alignment (the last
    narrower), or a card of 8 multiprocessors."""
    if kind == "card":
        return ws.walk_plan(B, D, H, 132, state=ws.LANE_STATE)
    if kind == "sms8":
        return ws.walk_plan(B, D, H, 8, state=ws.LANE_STATE)
    C = -(-(-(-D // 3)) // ws.WALK_COL_ALIGN) * ws.WALK_COL_ALIGN
    return ws.WalkPlan(16, C, -(-B // 16), -(-D // C), 1, 0)


def _run(c, dtype, plan):
    """The plain step and K11's schedule on the same inputs, each as
    ``(y_new, k7, err, k6, g6)``; third, the inputs."""
    tt = lambda a: torch.tensor(a, dtype=dtype)
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    y, k1, t, dt = tt(c["y"]), tt(c["k1"]), tt(c["t"]), tt(c["dt"])
    plain = fl._reference_sweep_lanes(t[:, None], dt[:, None], y, k1, fm._split_params(*leaves))
    return plain, ws.plain_lanes_solve_step(t, dt, y, k1, leaves, plan), (y, dt)


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b).clamp_min(1e-300)).item()


# (shape, plan): small shapes on every plan, a row-chunked one, the flagship
CASES = [((8, 16, 12), "card"), ((8, 16, 12), "cols3"), ((13, 40, 24), "card"),
         ((13, 40, 24), "cols3"), ((300, 40, 24), "sms8"), ((96, 200, 48), "card"),
         ((512, 784, 100), "card")]


def test_plans_are_those_named():
    """The plans the cases name: several column blocks with a narrower last
    one, row chunks, and the flagship's 128 tiles of 32 x 100, K12's plan,
    on which K11 takes 181,984 bytes of shared memory: K13's 141,920 with
    the stage input, the hidden rows and the slab ring in doubles and the
    tile's 32 rows of five floats."""
    p = _plan(13, 40, 24, "cols3")
    assert p.col_blocks == 3 and 40 - (p.col_blocks - 1) * p.cols < p.cols
    assert _plan(300, 40, 24, "sms8").chunks == 2
    assert _plan(96, 200, 48, "card").col_blocks == 7
    flagship = _plan(512, 784, 100, "card")
    assert flagship == ws.walk_plan(512, 784, 100, 132, state=ws.LANE_STATE)
    assert (flagship.rows, flagship.cols, flagship.tiles) == (32, 100, 128)
    assert ws.solve_smem_bytes(32, 100, 100) == 141_920
    assert ws.solve_smem_bytes(32, 100, 100, lanes=True) == (
        141_920 + 4 * (32 * (104 + 104) + 4 * 8 * 100) + 4 * 5 * 32) == 181_984


@pytest.mark.parametrize("shape, kind", CASES)
def test_plan_fits_k11_and_its_tiles_cover_the_batch_once(shape, kind):
    """K11's shared memory on the plan fits a block's (``SMEM_LIMIT``), and
    the kernel's tiles (``walk_tile``: block ``b`` of chunk ``k`` at row
    block ``b // ndb``, column block ``b % ndb``, clipped to the batch) over
    every row chunk cover each element of the batch exactly once."""
    B, D, H = shape
    p = _plan(*shape, kind)
    assert ws.solve_smem_bytes(p.rows, p.cols, H, lanes=True) <= ws.SMEM_LIMIT
    seen = np.zeros((B, D), np.int64)
    for chunk in range(p.chunks):
        for block in range(p.tiles):
            rb, db = divmod(block, p.col_blocks)
            row0 = (chunk * p.row_blocks + rb) * p.rows
            d0 = db * p.cols
            seen[row0:min(B, row0 + p.rows), d0:min(D, d0 + p.cols)] += 1
    assert (seen == 1).all()


def test_lane_plans_leave_out_tiles_k11_cannot_hold():
    """``walk_plan`` with K12's state takes only tiles K11's shared memory
    fits too: at 512x512x320 the walk alone would take 32 x 64 tiles (128
    of them, one chunk, 206,080 bytes), where K11's doubles need 246,496,
    so the plan is 16 x 128 (128 tiles), which both fit."""
    H = 320
    assert (ws.walk_smem_bytes(32, 64, H, ws.LANE_STATE) <= ws.SMEM_LIMIT
            < ws.solve_smem_bytes(32, 64, H, lanes=True))
    p = ws.walk_plan(512, 512, H, 132, state=ws.LANE_STATE)
    assert (p.rows, p.cols, p.tiles, p.chunks) == (16, 128, 128, 1)
    assert ws.solve_smem_bytes(p.rows, p.cols, H, lanes=True) <= ws.SMEM_LIMIT


@pytest.mark.parametrize("shape, kind", CASES)
def test_k11_schedule_is_the_plain_step_in_float64(shape, kind):
    """The same function summed in another order: every row within 1e-12
    (relative Frobenius) in float64."""
    plain, solve, _ = _run(_case(*shape), torch.float64, _plan(*shape, kind))
    for name, a, b in zip(NAMES, solve, plain):
        assert _rel(a, b) <= 1e-12, (name, _rel(a, b))


@pytest.mark.parametrize("shape, kind", CASES)
def test_k11_schedule_is_bitwise_the_plain_step_in_float32(shape, kind):
    """In float32 every row equals the plain step's bit for bit: each
    affine map is summed in float64 (in another order) and rounded once, and
    every other operation is the plain version's, so the engine's per-lane
    accept flags do not depend on the route."""
    plain, solve, _ = _run(_case(*shape), torch.float32, _plan(*shape, kind))
    for name, a, b in zip(NAMES, solve, plain):
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.parametrize("shape, kind", CASES[:5])
def test_finished_lanes_keep_y_and_have_zero_error(shape, kind):
    """A finished lane (dt = 0): y_new and g6 are y exactly, err is exactly
    zero, and every row is finite."""
    _, solve, (y, dt) = _run(_case(*shape), torch.float32, _plan(*shape, kind))
    done = dt == 0
    assert done.any()
    assert torch.equal(solve[0][done], y[done]) and torch.equal(solve[4][done], y[done])
    assert not solve[2][done].any()
    assert all(torch.isfinite(x).all() for x in solve)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape, kind", [((6, 10, 7), "card"), ((13, 40, 24), "cols3"),
                                         ((13, 40, 24), "card"), ((16, 24, 12), "cols3")])
def test_k11_schedule_matches_jax_k11(shape, kind, seed):
    """Against the JAX package's K11, ``pallas_mlp._pallas_sweep_lanes`` in
    interpret mode, at 3x LeCun's scale and the tolerance of
    ``test_torch_per_sample.py::test_lane_step_plain_versions_match_jax_interpret_kernels``
    (rtol 1e-4, atol 2e-6: ATen's and XLA's exp differ by an ulp, the port
    sums the affine maps in float64, and six stages carry a stage's ulp into
    a few)."""
    c = _case(*shape, seed, scale=3.0)
    params = {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}
    want = jmlp._pallas_sweep_lanes(jnp.asarray(c["t"])[:, None], jnp.asarray(c["dt"])[:, None],
                                    jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
                                    jmlp._split_params(params))
    _, solve, _ = _run(c, torch.float32, _plan(*shape, kind))
    for name, a, b in zip(NAMES, solve, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=2e-6,
                                   err_msg=name)
