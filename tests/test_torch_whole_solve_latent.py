"""The port's whole solve with ``AlternatingMLP`` and ``saveat``
(``NeuralODE(fused=True)`` -> ``ops.whole_solve``; on the CPU the wrappers
take the plain versions of K3/K4) against the JAX package's
``whole_solve_odeint`` (K3/K4 in interpret mode, as
``tests/test_whole_solve.py`` runs it), at that file's size: batch 8, dim
6, hidden 10, depth 2, saves ``SA``, rtol=atol=1e-4, max_steps=48. Both
packages get the same numpy weights and inputs.

In float32 the embedded error estimate of these smooth dynamics sits at its
rounding floor (eest 3e-5 to 7e-4): ATen's and XLA's tanh, and the port's
float64-summed affine maps, differ by ulps, which moves eest by about 25%
between the packages while JAX's two engines (whole solve and scan) agree
bitwise. So in float32 the decisions, the saves and the gradients are held
to JAX's, and eest in float64 (``test_matches_jax_fast_adjoint_float64``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.models import AlternatingMLP as JAltMLP
from regneuralde_tpu.models import MLPDynamics as JMLP
from regneuralde_tpu.models import NeuralODE as JNODE
from regneuralde_tpu.ops.pallas_generic import alternating_mlp_apply, alternating_mlp_leaves
from regneuralde_tpu.ops.pallas_solve import whole_solve_odeint
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.models import MLP, AlternatingMLP, LatentGRU, MLPDynamics, NeuralODE
from regneuralde_tpu_torch.ops import whole_solve as ws

torch.set_num_threads(1)

BATCH, DIM, HIDDEN, DEPTH = 8, 6, 10, 2
SA = [0.0, 0.2, 0.5, 0.8, 1.0]
REG = 10.0
# (t0, t1, saveat, rtol = atol, max_steps)
CASES = {
    "final": (0.0, 1.0, None, 1e-4, 48),
    "saveat": (0.0, 1.0, SA, 1e-4, 48),
    "reverse": (1.0, 0.0, SA[::-1], 1e-4, 48),
    "starved": (0.0, 1.0, SA, 1e-4, 2),
}


def _weights(seed=0, dim=DIM, hidden=HIDDEN, depth=DEPTH, scale=1.0):
    """AlternatingMLP weights as flax params (kernels ``(in, out)``, at
    ``scale`` times LeCun's) and y0, from numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    p = {}
    for i in range(depth):
        p[f"up_{i}"] = {"kernel": f32(rng.normal(size=(dim, hidden)) / np.sqrt(dim) * scale),
                        "bias": f32(rng.normal(size=hidden) * 0.1)}
        p[f"down_{i}"] = {"kernel": f32(rng.normal(size=(hidden, dim)) / np.sqrt(hidden)
                                        * scale),
                          "bias": f32(rng.normal(size=dim) * 0.1)}
    return {"params": p}, f32(rng.normal(size=(BATCH, dim)) * 0.5)


def _state_dict(params):
    """flax Dense params -> the dynamics' ``state_dict`` (weights ``(out, in)``)."""
    return {f"{name}.{k}": torch.from_numpy(np.ascontiguousarray(
        v["kernel"].T if k == "weight" else v["bias"]))
        for name, v in params["params"].items() for k in ("weight", "bias")}


def _jax_grads_in_torch_layout(g):
    return [np.asarray(g["params"][f"{n}_{i}"][k]).T if k == "kernel"
            else np.asarray(g["params"][f"{n}_{i}"][k])
            for i in range(DEPTH) for n in ("up", "down") for k in ("kernel", "bias")]


@pytest.fixture(scope="module")
def jax_runs():
    """Per case: JAX's whole solve of AlternatingMLP and the value and
    gradients (params, y0, t1) of sum(value^2) + 10 * error_estimate."""
    m = JAltMLP(dim=DIM, hidden=HIDDEN, depth=DEPTH)
    f = lambda t, y, p: m.apply(p, y)
    apply_fn = alternating_mlp_apply(DEPTH)
    flatten = lambda p: alternating_mlp_leaves(p, DEPTH)
    params, y0 = _weights()
    runs = {}
    for case, (t0, t1, sa, tol, max_steps) in CASES.items():
        sa_j = None if sa is None else jnp.asarray(sa, jnp.float32)

        def loss(p, y, t1_, t0=t0, sa_j=sa_j, tol=tol, max_steps=max_steps):
            s = whole_solve_odeint(f, apply_fn, flatten, y, t0, t1_, p, saveat=sa_j,
                                   rtol=tol, atol=tol, max_steps=max_steps)
            v = s.y1 if sa_j is None else s.ys
            task = jnp.sum(v ** 2)
            return task + REG * jreg.error_estimate(s.telemetry, agg="mean"), (s, task)

        fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
        (_, (s, task)), (gp, gy, gt) = fn(params, jnp.asarray(y0), jnp.float32(t1))
        tel = s.telemetry
        runs[case] = dict(
            task=float(task), nfe=int(s.stats.nfe), success=bool(s.stats.success),
            y1=np.asarray(s.y1), ys=None if sa is None else np.asarray(s.ys),
            accepted=np.asarray(tel.accepted), live=np.asarray(tel.live),
            eest=np.asarray(tel.eest), grads=_jax_grads_in_torch_layout(gp),
            gy=np.asarray(gy), gt=float(gt))
    return params, y0, runs


def _torch_run(params, y0, case, dtype=torch.float32, fused=True):
    t0, t1, sa, tol, max_steps = CASES[case]
    node = NeuralODE(AlternatingMLP(DIM, HIDDEN, DEPTH, device="cpu"), time_dep=False,
                     rtol=tol, atol=tol, max_steps=max_steps, fused=fused).to(dtype)
    node.dynamics.load_state_dict(_state_dict(params))
    node.to(dtype)
    y = torch.tensor(y0, dtype=dtype, requires_grad=True)
    t1_ = torch.tensor(t1, dtype=dtype, requires_grad=True)
    out = node(y, tspan=(t0, t1_), saveat=None if sa is None else torch.tensor(sa, dtype=dtype))
    task = out.value.square().sum()
    grads = torch.autograd.grad(task + REG * treg.error_estimate(out.telemetry, "mean"),
                                [*node.parameters(), y, t1_])
    return task, out, [g.detach().numpy() for g in grads]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(jax_runs, case):
    """The same NFE, success, accept sequence and live mask; y1 and the
    saves (the port's ``(batch, time, feat)`` against JAX's ``(time, batch,
    feat)``) within 1e-5 relative (Frobenius), the row at t0 equal to y0.
    In reverse time the cursor walks the saves backwards. Starved, the rows
    the solve did not reach keep their seeds (zero), and y1 lies where the
    solve stopped, which the error estimate at its rounding floor moves
    (1.4% here): there the saves it reached are compared."""
    params, y0, runs = jax_runs
    run = runs[case]
    task, out, _ = _torch_run(params, y0, case)
    sol = out.solution
    assert out.nfe == run["nfe"] and sol.stats.success == run["success"]
    assert sol.stats.success == (case != "starved")
    np.testing.assert_array_equal(out.telemetry.accepted.numpy(), run["accepted"])
    np.testing.assert_array_equal(out.telemetry.live.numpy(), run["live"])
    if case != "starved":
        assert _rel(sol.y1.detach(), run["y1"]) <= 1e-5
        np.testing.assert_allclose(task.item(), run["task"], rtol=1e-5)
    if run["ys"] is not None:
        ys = out.value.detach().numpy().transpose(1, 0, 2)
        assert _rel(ys, run["ys"]) <= 1e-5
        np.testing.assert_array_equal(ys[0], y0)
        reached = np.any(run["ys"] != 0.0, axis=(1, 2))
        np.testing.assert_array_equal(np.any(ys != 0.0, axis=(1, 2)), reached)
        assert reached.all() == (case != "starved")


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_jax(jax_runs, case):
    """Each weight gradient of sum(value^2) + 10 * error_estimate within
    2e-3 (relative, Frobenius) of JAX's: JAX's own bound against its scan
    oracle (tests/test_whole_solve.py)."""
    params, y0, runs = jax_runs
    _, _, grads = _torch_run(params, y0, case)
    for j, (a, b) in enumerate(zip(grads, runs[case]["grads"])):
        assert _rel(a, b) <= 2e-3, (j, _rel(a, b))


@pytest.mark.parametrize("case", ["saveat", "reverse"])
def test_x0_grads_through_save_buffer(jax_runs, case):
    """The y0 gradient, which reaches y0 through the row at t0 (seeded from
    y0, untouched by the solve) and through the integration: rtol 2e-3,
    atol 1e-5 of JAX's."""
    params, y0, runs = jax_runs
    _, _, grads = _torch_run(params, y0, case)
    assert _rel(grads[-2], runs[case]["gy"]) <= 2e-3


@pytest.mark.parametrize("case", ["final", "saveat", "reverse"])
def test_t1_grads(jax_runs, case):
    """The t1 gradient, a sum of terms of the loss's size: within 2e-3 of
    the y0 gradient's norm of JAX's."""
    params, y0, runs = jax_runs
    _, _, grads = _torch_run(params, y0, case)
    run = runs[case]
    assert abs(float(grads[-1]) - run["gt"]) <= 2e-3 * np.linalg.norm(run["gy"])


def test_starved_solve_with_saveat(jax_runs):
    """max_steps=2: the solve fails and the cursor reaches only part of the
    grid; the rows it did not reach keep their seed, and their cotangent
    passes on to ``ys_init`` (zero here, so nothing reaches y0 through
    them): every gradient is finite, and a loss on those rows alone has a
    zero gradient everywhere but through ``ys_init``."""
    params, y0, runs = jax_runs
    _, out, grads = _torch_run(params, y0, "starved")
    ys = out.value.detach().numpy().transpose(1, 0, 2)
    reached = np.any(ys != 0.0, axis=(1, 2))
    assert reached[0] and not reached[-1]
    assert all(np.isfinite(g).all() for g in grads)
    t0, t1, sa, tol, max_steps = CASES["starved"]
    node = NeuralODE(AlternatingMLP(DIM, HIDDEN, DEPTH, device="cpu"), time_dep=False,
                     rtol=tol, atol=tol, max_steps=max_steps, fused=True)
    node.dynamics.load_state_dict(_state_dict(params))
    y = torch.tensor(y0, requires_grad=True)
    value = node(y, saveat=torch.tensor(sa)).value
    g = torch.autograd.grad(value[:, ~torch.from_numpy(reached)].sum(),
                            [y, *node.parameters()], allow_unused=True)
    assert all(x is None or not x.any() for x in g)


def _mlp_params(seed=1, dim=16, hidden=12):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return {"params": {
        "dense_1": {"kernel": f32(rng.normal(size=(dim + 1, hidden)) / np.sqrt(dim + 1)),
                    "bias": f32(rng.normal(size=hidden) * 0.1)},
        "dense_2": {"kernel": f32(rng.normal(size=(hidden + 1, dim)) / np.sqrt(hidden + 1)),
                    "bias": f32(rng.normal(size=dim) * 0.1)}}}, f32(rng.uniform(size=(8, dim)))


def test_mlp_whole_solve_with_saveat_matches_jax():
    """The MLPDynamics whole solve with ``saveat`` (the save cursor on the
    other dynamics) against JAX's ``NeuralODE(fused=True)``: the same NFE
    and accept sequence, the saves within 1e-5 and the gradients of
    sum(saves^2) within rtol 2e-3, atol 1e-5."""
    params, x = _mlp_params()
    sa = jnp.asarray(SA, jnp.float32)
    jnode = JNODE(JMLP(dim=16, hidden=12), rtol=1e-4, atol=1e-4, max_steps=48, fused=True,
                  saveat=sa)

    def loss(p):
        out = jnode(p, jnp.asarray(x))
        return jnp.sum(out.value ** 2), out

    (val, jout), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    node = NeuralODE(MLPDynamics(16, 12, device="cpu"), rtol=1e-4, atol=1e-4, max_steps=48,
                     fused=True, saveat=torch.tensor(SA))
    node.dynamics.load_state_dict(_state_dict(params))
    out = node(torch.from_numpy(x))
    grads = torch.autograd.grad(out.value.square().sum(), list(node.parameters()))
    assert out.nfe == int(jout.nfe) and out.solution.stats.success
    np.testing.assert_array_equal(out.telemetry.accepted.numpy(),
                                  np.asarray(jout.telemetry.accepted))
    assert _rel(out.value.detach(), jout.value) <= 1e-5
    jg = [np.asarray(g["params"][n][k]).T if k == "kernel" else np.asarray(g["params"][n][k])
          for n in ("dense_1", "dense_2") for k in ("kernel", "bias")]
    for a, b in zip(grads, jg):
        assert _rel(a, b) <= 2e-3


def _float64_run(fused, dynamics, tspan, sa):
    gen = torch.Generator().manual_seed(3)
    dyn = (AlternatingMLP(DIM, HIDDEN, DEPTH, device="cpu", generator=gen)
           if dynamics == "altmlp" else MLPDynamics(DIM, HIDDEN, device="cpu", generator=gen))
    node = NeuralODE(dyn, time_dep=dynamics == "mlp", rtol=1e-6, atol=1e-6, max_steps=64,
                     fused=fused).to(torch.float64)
    with torch.no_grad():  # biases off zero, so every leaf matters
        for p in node.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, dtype=torch.float64))
    x = (torch.randn(BATCH, DIM, generator=gen, dtype=torch.float64) * 0.5).requires_grad_()
    t1 = torch.tensor(tspan[1], dtype=torch.float64, requires_grad=True)
    out = node(x, tspan=(tspan[0], t1), saveat=torch.tensor(sa, dtype=torch.float64))
    tel = out.telemetry
    w = torch.arange(1.0, len(sa) + 1.0, dtype=torch.float64)[None, :, None]
    loss = ((w * out.value.square()).sum() + 100.0 * (tel.eest * tel.dt * tel.accepted).sum()
            + (tel.eigen_est * tel.accepted).sum() + tel.t.sum())
    return out, torch.autograd.grad(loss, [*node.parameters(), x, t1])


def _frob(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("dynamics, tspan, sa", [
    ("altmlp", (0.0, 1.0), SA), ("altmlp", (1.0, 0.0), SA[::-1]),
    ("mlp", (0.0, 1.0), [0.1, 0.5, 0.9])], ids=["altmlp", "altmlp-reverse", "mlp"])
def test_plain_whole_solve_matches_fast_adjoint_float64(dynamics, tspan, sa):
    """float64, with ``saveat``: the plain whole solve (the cursor's rows,
    ``post_bwd`` and the Hermite pullback from the history) against the
    port's own fast adjoint (``fused=False``; the window mask and autograd
    of the scalar chain): the same steps, the saves and telemetry at rtol
    1e-9, and the gradients of a loss that seeds the saves, eest, dt,
    eigen_est and t (weights, y0, t1) within 1e-9 (relative, Frobenius: the
    regularizer's gradient carries the 1/atol scale, so an element near
    zero holds float64 rounding of the large ones)."""
    a, ga = _float64_run(True, dynamics, tspan, sa)
    b, gb = _float64_run(False, dynamics, tspan, sa)
    assert a.solution.stats == b.solution.stats and a.solution.stats.naccept >= 5
    assert torch.equal(a.telemetry.accepted, b.telemetry.accepted)
    for x, y in zip([a.value, *a.telemetry[:4]], [b.value, *b.telemetry[:4]]):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=0)
    for x, y in zip(ga, gb):
        assert _frob(x, y) <= 1e-9


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("case", ["saveat", "reverse"])
def test_matches_jax_fast_adjoint_float64(x64, case):
    """float64, where eest is far above its rounding floor: the port's whole
    solve against JAX's scan oracle (``odeint(mode="scan")``) with weights at
    three times LeCun's scale and rtol=atol=1e-6 (twenty-odd trial steps):
    the same NFE and accept sequence, the saves and eest at rtol 1e-7, and
    the gradients of sum(saves^2) + 10 * error_estimate (weights, y0, t1)
    within 1e-6 (relative, Frobenius)."""
    from regneuralde_tpu.ops import odeint as jodeint

    t0, t1, sa, _, _ = CASES[case]
    tol, max_steps = 1e-6, 64
    params, y0 = _weights(scale=3.0)
    p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

    def apply(t, y, p):
        h = jnp.tanh(y)
        for i in range(DEPTH):
            for n in ("up", "down"):
                h = jnp.tanh(h @ p["params"][f"{n}_{i}"]["kernel"] + p["params"][f"{n}_{i}"]["bias"])
        return h

    def loss(p, y, t1_):
        s = jodeint(apply, y, t0, t1_, p, rtol=tol, atol=tol, max_steps=max_steps, mode="scan",
                    saveat=jnp.asarray(sa, jnp.float64))
        return jnp.sum(s.ys ** 2) + REG * jreg.error_estimate(s.telemetry, agg="mean"), s

    (jval, js), (gp, gy, gt) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                                          has_aux=True))(
        p64, jnp.asarray(y0, jnp.float64), jnp.float64(t1))
    node = NeuralODE(AlternatingMLP(DIM, HIDDEN, DEPTH, device="cpu"), time_dep=False,
                     rtol=tol, atol=tol, max_steps=max_steps, fused=True).to(torch.float64)
    node.dynamics.load_state_dict(_state_dict(params))
    y = torch.tensor(y0, dtype=torch.float64, requires_grad=True)
    t1_ = torch.tensor(t1, dtype=torch.float64, requires_grad=True)
    out = node(y, tspan=(t0, t1_), saveat=torch.tensor(sa, dtype=torch.float64))
    val = out.value.square().sum() + REG * treg.error_estimate(out.telemetry, "mean")
    grads = torch.autograd.grad(val, [*node.parameters(), y, t1_])
    assert out.solution.stats.naccept >= 8 and out.nfe == int(js.stats.nfe)
    np.testing.assert_array_equal(out.telemetry.accepted.numpy(), np.asarray(js.telemetry.accepted))
    np.testing.assert_allclose(out.value.detach().numpy().transpose(1, 0, 2), np.asarray(js.ys),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(out.telemetry.eest.detach().numpy(), np.asarray(js.telemetry.eest),
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(val.item(), float(jval), rtol=1e-9)
    want = _jax_grads_in_torch_layout(gp) + [np.asarray(gy), np.asarray(gt)]
    for j, (a, b) in enumerate(zip(grads, want)):
        assert _rel(a.numpy(), b) <= 1e-6, (j, _rel(a.numpy(), b))


def test_whole_solve_refuses_unsorted_saveat():
    """The save cursor needs the stamps in the direction of integration:
    the whole solve raises ``ValueError`` where the step route would write
    them by window."""
    node = NeuralODE(AlternatingMLP(DIM, HIDDEN, DEPTH, device="cpu"), time_dep=False,
                     fused=True)
    with pytest.raises(ValueError, match="monotone"):
        node(torch.zeros(2, DIM), saveat=torch.tensor([0.0, 0.8, 0.5]))
    ws.reset_launches()
    assert ws.LAUNCHES == {k: 0 for k in ws.LAUNCHES}


@pytest.mark.parametrize("make", [
    lambda **kw: MLPDynamics(4, 3, **kw), lambda **kw: MLP(4, (3, 2), **kw),
    lambda **kw: AlternatingMLP(4, 3, 1, **kw), lambda **kw: LatentGRU(2, 3, 4, **kw)],
    ids=["MLPDynamics", "MLP", "AlternatingMLP", "LatentGRU"])
def test_models_default_to_the_card(make):
    """A constructor given no device puts its parameters on the card; on a
    machine without one it raises, and only ``device="cpu"`` builds the
    module on the CPU."""
    assert all(p.device.type == "cpu" for p in make(device="cpu").parameters())
    if torch.cuda.is_available():
        assert all(p.device.type == "cuda" for p in make().parameters())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
