"""The toy 2-D SDE fit (``experiments/sde_toy.py``) in the port against the
JAX package: ``CubicDrift`` and the cubic tile body of the SDE whole solve
(on the CPU the plain versions of K9/K10 with ``body="cubic"``),
``NeuralSDE``'s routing of the pair, three training steps at the published
configuration, ``AdaBelief``, ``make_sde_demo``, the BSON.jl codec and
``physionet_bundle_from_bson``.

The JAX side: a flax copy of the experiment's ``CubicDrift``, JAX's
``NeuralSDE`` on ``fused="solve"`` (``whole_solve_sdeint``, its Pallas
kernels in interpret mode on the CPU, batch 13 padded to 16 with masked
rows) and on ``fused=False`` (``sdeint``), on JAX's own draws
(``presample_noise`` of the key its solve consumed, handed to the port as
``noise=``); parameters through ``convert.sde_toy_state_dict``.

Tolerances: float32 against JAX the same NFE, accepts and success, the
saves within 1e-5 relative (Frobenius), gradients within 2e-3 relative; in
float64 the plain cubic whole solve against JAX's ``sdeint`` within 1e-9 for
the saves and 1e-6 for the gradients; the hand pullback of one cubic trial
step against autograd in float64 at 1e-10; the training steps' losses and
parameters within 2e-3 relative of JAX's; AdaBelief against optax at 1e-6;
the data bitwise.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.data import bson as jbson
from regneuralde_tpu.data import datasets as jdata
from regneuralde_tpu.models import NeuralSDE as JNeuralSDE
from regneuralde_tpu.ops.pallas_sde import presample_noise as jax_presample_noise
from regneuralde_tpu.ops.sde import sdeint as jax_sdeint
from regneuralde_tpu.training import sde_toy_optimizer as jax_sde_toy_optimizer
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.convert import sde_toy_state_dict
from regneuralde_tpu_torch.data import bson as tbson
from regneuralde_tpu_torch.data import datasets as tdata
from regneuralde_tpu_torch.data import make_sde_demo, physionet_bundle_from_bson
from regneuralde_tpu_torch.models import MLP, CubicDrift, NeuralSDE
from regneuralde_tpu_torch.ops import sde_whole_solve as sw
from regneuralde_tpu_torch.ops.controller import PIController
from regneuralde_tpu_torch.ops.sri import get_tableau
from regneuralde_tpu_torch.training import (
    AdaBelief,
    create_train_state,
    make_train_step,
    sde_toy_optimizer,
)
from regneuralde_tpu_torch.training import sde_toy as st

torch.set_num_threads(1)

DIM, HIDDEN = 2, 8
TOL, MAX_STEPS = 1e-2, 64
SA4 = [0.0, 0.3, 0.6, 1.0]
SA30 = np.linspace(0.0, 1.0, 30).astype(np.float32).tolist()
REG = 10.0


class JCubicDrift(fnn.Module):
    """``experiments/sde_toy.py``'s ``CubicDrift`` with its widths as fields:
    Chain(x -> x.^3, Dense(dim, hidden, tanh), Dense(hidden, dim))."""

    hidden: int = 50
    dim: int = 2

    @fnn.compact
    def __call__(self, x):
        h = jnp.tanh(fnn.Dense(self.hidden)(x**3))
        return fnn.Dense(self.dim)(h)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _y0(batch, seed=1):
    """States around the toy's ``u0 = [2, 0]``, spread so the cube matters."""
    rng = np.random.default_rng(seed)
    return (np.array([[1.0, 0.0]]) + 0.5 * rng.normal(size=(batch, DIM))).astype(np.float32)


def _jax_params(seed=0, hidden=HIDDEN):
    x = jnp.zeros((1, DIM), jnp.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"drift": JCubicDrift(hidden, DIM).init(k1, x),
            "diffusion": jax.tree_util.tree_map(lambda a: 0.3 * a, fnn.Dense(DIM).init(k2, x))}


def _torch_sde(params, fused, hidden=HIDDEN, **kw):
    m = NeuralSDE(CubicDrift(DIM, hidden, device="cpu"), MLP(DIM, (DIM,), device="cpu"),
                  fused=fused, **kw)
    m.load_state_dict(sde_toy_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return m


def _draws(key, rows, max_steps, dtype=jnp.float32):
    xi = jax_presample_noise(key, (rows, DIM), dtype, max_steps)
    return tuple(torch.from_numpy(np.array(a)) for a in xi)


def _grads_by_name(params, g):
    """JAX gradients as the port's ``state_dict`` names."""
    return {k: v.numpy() for k, v in sde_toy_state_dict(
        jax.tree_util.tree_map(np.asarray, g)).items()}


@pytest.mark.parametrize("batch,sa,tol,max_steps", [
    (16, SA4, TOL, MAX_STEPS), (16, SA30, TOL, MAX_STEPS), (13, SA30, TOL, MAX_STEPS),
    (13, SA30, 2e-3, 128)], ids=["saves4", "saves30", "batch13", "rejections"])
def test_cubic_whole_solve_matches_jax(batch, sa, tol, max_steps):
    """The plain cubic whole solve (``NeuralSDE(fused="solve")``) against
    JAX's ``whole_solve_sdeint`` in interpret mode: the same steps, the
    saves within 1e-5 and the gradients of ``sum(v^2) + 10 *
    error_estimate`` within 2e-3."""
    params = _jax_params()
    y0 = _y0(batch)
    key = jax.random.PRNGKey(7)
    kw = dict(tspan=(0.0, 1.0), solver="sosri", rtol=tol, atol=tol, max_steps=max_steps)
    jm = JNeuralSDE(JCubicDrift(HIDDEN, DIM), fnn.Dense(DIM), saveat=jnp.asarray(sa),
                    fused="solve", **kw)

    def loss(p, x):
        out = jm(p, x, key)
        return jnp.sum(out.value ** 2) + REG * jreg.error_estimate(out.telemetry, agg="mean"), out

    (_, jo), (jg, jgy) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(y0))
    tm = _torch_sde(params, "solve", saveat=torch.tensor(sa), **kw)
    y = torch.tensor(y0, requires_grad=True)
    sw.reset_launches()
    out = tm(y, noise=_draws(key, batch, max_steps))
    assert not any(sw.LAUNCHES.values())
    s, js = out.solution.stats, jo.solution.stats
    assert (s.naccept, s.nreject) == (int(js.naccept), int(js.nreject))
    if tol < TOL:
        assert s.nreject > 0, "the case needs rejections"
    assert (out.nfe1, out.nfe2) == (int(jo.nfe1), int(jo.nfe2))
    assert s.success and bool(js.success)
    np.testing.assert_array_equal(out.telemetry.accepted.numpy(),
                                  np.asarray(jo.telemetry.accepted))
    assert out.value.shape == (batch, len(sa), DIM)
    assert _rel(out.value.detach(), jo.value) <= 1e-5
    lv = out.value.square().sum() + REG * treg.error_estimate(out.telemetry, "mean")
    names = [n for n, _ in tm.named_parameters()]
    got = torch.autograd.grad(lv, [*tm.parameters(), y])
    want = _grads_by_name(params, jg)
    for n, g in zip(names, got):
        assert _rel(g, want[n]) <= 2e-3, n
    assert _rel(got[-1], jgy) <= 2e-3


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("tol", [1e-2, 2e-3], ids=["loose", "rejections"])
def test_cubic_whole_solve_matches_jax_sdeint_float64(x64, tol):
    """The plain cubic whole solve (``whole_solve_sdeint(body="cubic")``) in
    float64 against JAX's ``sdeint`` of the same pair in float64 on the same
    draws: the same steps, the saves within 1e-9, the gradients (leaves and
    y0) within 1e-6."""
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), _jax_params())
    y0 = _y0(16).astype(np.float64)
    key = jax.random.PRNGKey(3)
    drift, diffusion = JCubicDrift(HIDDEN, DIM), fnn.Dense(DIM)
    sa = jnp.asarray(SA4, jnp.float64)

    def loss(p, x):
        s = jax_sdeint(lambda t, y, q: drift.apply(q["drift"], y),
                       lambda t, y, q: diffusion.apply(q["diffusion"], y), x,
                       jnp.asarray(0.0, jnp.float64), jnp.asarray(1.0, jnp.float64), p, key=key,
                       solver="sosri", rtol=tol, atol=tol, max_steps=128, saveat=sa)
        return jnp.sum(s.ys ** 2) + REG * jreg.error_estimate(s.telemetry, agg="mean"), s

    (_, js), (jg, jgy) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(y0))
    sd = sde_toy_state_dict(params)
    leaves = [sd[k].double().requires_grad_(True) for k in (
        "drift.dense_0.weight", "drift.dense_0.bias", "drift.dense_1.weight",
        "drift.dense_1.bias", "diffusion.dense_0.weight", "diffusion.dense_0.bias")]
    y = torch.tensor(y0, requires_grad=True)
    s = sw.whole_solve_sdeint(y, 0.0, 1.0, leaves, n_drift=2, body="cubic",
                              noise=_draws(key, 16, 128, jnp.float64), solver="sosri", rtol=tol,
                              atol=tol, max_steps=128,
                              saveat=torch.tensor(SA4, dtype=torch.float64))
    assert (s.stats.naccept, s.stats.nreject) == (int(js.stats.naccept), int(js.stats.nreject))
    if tol == 2e-3:
        assert s.stats.nreject > 0, "the case needs rejections"
    assert _rel(s.ys.detach(), js.ys) <= 1e-9
    lv = s.ys.square().sum() + REG * treg.error_estimate(s.telemetry, "mean")
    got = torch.autograd.grad(lv, [*leaves, y])
    want = _grads_by_name(params, jg)
    names = ["drift.dense_0.weight", "drift.dense_0.bias", "drift.dense_1.weight",
             "drift.dense_1.bias", "diffusion.dense_0.weight", "diffusion.dense_0.bias"]
    for n, g in zip(names, got):
        assert _rel(g, want[n]) <= 1e-6, n
    assert _rel(got[-1], jgy) <= 1e-6


@pytest.mark.parametrize("case", ["accept", "reject", "inside_tail"])
def test_cubic_step_pullback_matches_autograd(case):
    """``_sde_step_bwd_math(body="cubic")`` against ``torch.autograd`` of
    ``plain_sde_trial_step(body="cubic")`` in float64, every output seeded,
    at 1e-10."""
    tol, h, tail_scale = {"accept": (1.0, 0.0, 0.0), "reject": (1e-6, 0.0, 0.0),
                          "inside_tail": (1.0, 0.3, 0.5)}[case]
    B, H = 5, 6
    f64 = torch.float64
    g = torch.Generator().manual_seed(1)
    r = lambda *s, sc=1.0: torch.randn(s, generator=g, dtype=f64) * sc
    leaves = [r(H, DIM, sc=DIM ** -0.5), r(H, sc=0.1), r(DIM, H, sc=H ** -0.5), r(DIM, sc=0.1),
              r(DIM, DIM, sc=0.3 * DIM ** -0.5), r(DIM, sc=0.05)]
    y, tw, tz = r(B, DIM, sc=0.8), r(B, DIM, sc=tail_scale), r(B, DIM, sc=tail_scale)
    sc = lambda v: torch.tensor(v, dtype=f64)
    prim = [sc(0.1), sc(0.1), sc(1e-4), sc(h), y, tw, tz, r(B, DIM), r(B, DIM), sc(1.0), sc(1.0)]
    req = [x.clone().requires_grad_(True) for x in prim]
    lreq = [x.clone().requires_grad_(True) for x in leaves]
    tab, ctrl = get_tableau("sosri"), PIController(beta1=0.5, beta2=0.0)
    out = sw.plain_sde_trial_step(tab, ctrl, tol, tol, *req, lreq, 2, body="cubic")
    assert bool(out.accept) == (case != "reject")
    outs = [out.t, out.dt, out.qold, out.y, *out.tail, out.tel_t, out.dt_eff, out.eest,
            out.eigen_est]
    cts = [r(*o.shape) for o in outs]
    inputs = [req[k] for k in (0, 1, 2, 3, 4, 5, 6, 9, 10)] + lreq
    want = torch.autograd.grad(outs, inputs, grad_outputs=cts, allow_unused=True)
    want = [torch.zeros_like(x) if w is None else w for w, x in zip(want, inputs)]
    got_s, got_l = sw._sde_step_bwd_math(tab, ctrl, tol, tol, prim, leaves, 2, bool(out.accept),
                                         out.sums, cts, body="cubic")
    for a, b in zip([*got_s, *got_l], want):
        assert _rel(a.detach().numpy(), b.numpy()) <= 1e-10


def test_cubic_drift_matches_flax():
    """``CubicDrift`` against the flax copy on the same weights, and its
    cube as two products."""
    params = _jax_params(hidden=50)
    x = _y0(7) * 2
    m = CubicDrift(DIM, 50, device="cpu")
    sd = sde_toy_state_dict(jax.tree_util.tree_map(np.asarray, params))
    m.load_state_dict({k[len("drift."):]: v for k, v in sd.items() if k.startswith("drift.")})
    want = JCubicDrift(50, DIM).apply(params["drift"], jnp.asarray(x))
    assert _rel(m(torch.from_numpy(x)).detach(), want) <= 2e-6
    xt = torch.from_numpy(x)
    assert torch.equal(sw._cube(xt), xt * xt * xt)


def test_routing_takes_the_cubic_body(monkeypatch):
    """``kernel_body`` names the cubic body for ``CubicDrift`` + an MLP
    diffusion; ``fused=True`` and ``"solve"`` take the whole solve with it
    and agree with ``fused=False``; a drift neither body covers still takes
    ``sdeint`` on ``True`` and raises on ``"solve"``; float64 and a
    time-dependent pair are not eligible."""
    calls = []
    orig = sw.whole_solve_sdeint

    def spy(*a, **k):
        calls.append(k["body"])
        return orig(*a, **k)

    monkeypatch.setattr(sw, "whole_solve_sdeint", spy)
    gen = torch.Generator().manual_seed(0)
    x = 1.5 * torch.randn(6, DIM, generator=gen)
    noise = tuple(torch.randn(32, 6, DIM, generator=gen) for _ in range(2))
    pair = lambda: (CubicDrift(DIM, HIDDEN, device="cpu",
                               generator=torch.Generator().manual_seed(1)),
                    MLP(DIM, (DIM,), device="cpu", generator=torch.Generator().manual_seed(2)))
    kw = dict(rtol=0.1, atol=0.1, max_steps=32)
    assert NeuralSDE(*pair(), **kw).kernel_body(x) == "cubic"
    assert NeuralSDE(*pair(), **kw).kernel_body(x.double()) is None
    assert NeuralSDE(*pair(), time_dep=True, **kw).kernel_body(x) is None
    assert NeuralSDE(CubicDrift(3, HIDDEN, device="cpu"), MLP(DIM, (DIM,), device="cpu"),
                     **kw).kernel_body(x) is None
    plain = NeuralSDE(*pair(), **kw)(x, noise=noise)
    assert not calls
    for fused in (True, "solve"):
        calls.clear()
        out = NeuralSDE(*pair(), fused=fused, **kw)(x, noise=noise)
        assert calls == ["cubic"]
        assert (out.nfe1, out.nfe2) == (plain.nfe1, plain.nfe2)
        assert _rel(out.value.detach(), plain.value.detach()) <= 1e-5
    calls.clear()
    other = (torch.nn.Sequential(torch.nn.Linear(DIM, DIM)), MLP(DIM, (DIM,), device="cpu"))
    out = NeuralSDE(*other, fused=True, **kw)(x, noise=noise)
    assert not calls and out.value.shape == x.shape
    with pytest.raises(ValueError, match="CubicDrift"):
        NeuralSDE(*other, fused="solve", **kw)(x, noise=noise)
    with pytest.raises(ValueError, match="body"):
        sw.whole_solve_sdeint(x, 0.0, 1.0, list(pair()[0].parameters()), n_drift=2,
                              body="quartic", noise=noise)


# ---------------------------------------------------------------------------
# Three training steps at the published configuration.
# ---------------------------------------------------------------------------

_JAX_RUN = {}


def _toy_data():
    means, vars_, tsteps, _ = jdata.make_sde_demo(seed=0)
    return means, vars_, tsteps


def _jax_train(steps=3):
    """``experiments/sde_toy.py``'s ``loss_fn`` and ``sde_toy_optimizer``
    (AdaBelief(0.01)), regularized, 100 trajectories, fused=False."""
    if _JAX_RUN:
        return _JAX_RUN["run"]
    means, vars_, tsteps = _toy_data()
    nsde = JNeuralSDE(JCubicDrift(), fnn.Dense(2), tspan=(0.0, st.T1), solver="sosri",
                      rtol=st.TOL, atol=st.TOL, max_steps=st.MAX_STEPS,
                      saveat=jnp.asarray(tsteps))
    u0 = jnp.tile(jnp.asarray([[2.0, 0.0]], jnp.float32), (st.TRAJECTORIES, 1))
    params = nsde.init(jax.random.PRNGKey(st.SEED), u0)
    opt = jax_sde_toy_optimizer()

    def loss_fn(p, key):
        out = nsde(p, u0, key)
        m = jnp.mean(out.value, axis=0)
        v = jnp.var(out.value, axis=0)
        r = st.REG_COEFF * jreg.error_estimate(out.telemetry, agg="sum")
        return (jnp.mean(jnp.square(means - m)) + jnp.mean(jnp.square(vars_ - v)) + r,
                (out.nfe1, out.solution.stats.naccept, out.solution.stats.nreject))

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    state = opt.init(params)
    key = jax.random.PRNGKey(st.SEED + 1)
    init, losses, keys, stats = params, [], [], []
    for _ in range(steps):
        key, sk = jax.random.split(key)
        (loss, aux), g = grad_fn(params, sk)
        losses.append(float(loss))
        keys.append(sk)
        stats.append(tuple(int(a) for a in aux))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    _JAX_RUN["run"] = (init, losses, keys, stats, params)
    return _JAX_RUN["run"]


@pytest.mark.parametrize("fused", [False, True])
def test_training_steps_match_jax(fused):
    """Three steps of the port's ``training.sde_toy`` on ``fused=False`` and
    on ``fused=True`` (the plain cubic K9/K10 here) against JAX's on JAX's
    draws: the same NFE and accepts, the loss and then the parameters
    within 2e-3 relative."""
    init, losses, keys, stats, after = _jax_train()
    means, vars_, tsteps = _toy_data()
    model = _torch_sde(init, fused, hidden=50, tspan=(0.0, st.T1), solver="sosri",
                       rtol=st.TOL, atol=st.TOL, max_steps=st.MAX_STEPS,
                       saveat=torch.from_numpy(tsteps))
    u0 = st.sde_toy_u0(device="cpu")
    opt = sde_toy_optimizer()
    state = create_train_state(model, opt)
    step = make_train_step(st.sde_toy_loss, opt)
    for i in range(len(losses)):
        noise = _draws(keys[i], st.TRAJECTORIES, st.MAX_STEPS)
        state, loss, out = step(state, u0, torch.from_numpy(means), torch.from_numpy(vars_),
                                noise)
        s = out.solution.stats
        assert (out.nfe1, s.naccept, s.nreject) == stats[i]
        assert s.success
        assert abs(loss.item() - losses[i]) <= 2e-3 * abs(losses[i])
    want = {k: v.numpy() for k, v in sde_toy_state_dict(
        jax.tree_util.tree_map(np.asarray, after)).items()}
    for n, p in model.named_parameters():
        assert _rel(p.detach(), want[n]) <= 2e-3, n


def test_build_sde_toy_is_the_published_config():
    model = st.build_sde_toy(np.linspace(0, 1, 30), True, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert (model.solver, model.rtol, model.atol, model.max_steps) == ("sosri", 0.3, 0.3, 256)
    assert model.tspan == (0.0, 1.0 + float(np.finfo(np.float32).eps))
    assert model.saveat.shape == (30,) and model.fused is True
    assert model.kernel_body(st.sde_toy_u0(device="cpu")) == "cubic"
    assert [tuple(p.shape) for p in model.parameters()] == [(50, 2), (50,), (2, 50), (2,),
                                                             (2, 2), (2,)]


# ---------------------------------------------------------------------------
# Data and optimizer.
# ---------------------------------------------------------------------------


@pytest.fixture
def no_data_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REGNDE_DATA_DIR", raising=False)
    return tmp_path


@pytest.mark.parametrize("seed,datasize", [(0, 30), (3, 30), (0, 12)])
def test_make_sde_demo_synthetic_equals_jax(no_data_files, seed, datasize):
    want = jdata.make_sde_demo(seed=seed, datasize=datasize)
    got = make_sde_demo(seed=seed, datasize=datasize)
    assert got[3] == want[3] == "synthetic"
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_make_sde_demo_bson_route_equals_jax(no_data_files, monkeypatch):
    """A ``sde_demo.bson`` written by the port's writer (the reference's
    ``(2, 30)`` column-major layout) is read by both packages alike."""
    rng = np.random.default_rng(5)
    blob = {"sde_data": rng.normal(size=(2, 30)).astype(np.float32),
            "sde_data_vars": rng.uniform(size=(2, 30)).astype(np.float32)}
    (no_data_files / "truth").mkdir()
    tbson.dump_bson(no_data_files / "truth" / "sde_demo.bson", blob)
    monkeypatch.setenv("REGNDE_DATA_DIR", str(no_data_files / "truth"))
    want = jdata.make_sde_demo()
    got = make_sde_demo()
    assert got[3] == want[3] and got[3].startswith("bson:")
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[0], blob["sde_data"].T)


def test_bson_codec_is_jaxs(tmp_path):
    """The port's copy reads what JAX's writes and the reverse, every dtype,
    nested documents, lists, backrefs and tags."""
    rng = np.random.default_rng(0)
    doc = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
           "f64": rng.standard_normal((2, 2, 4)), "i64": np.arange(7, dtype=np.int64),
           "u8": np.arange(12, dtype=np.uint8).reshape(3, 4), "n": 42, "x": 2.5,
           "flag": True, "name": "hello", "nested": {"inner": np.ones((2, 3), np.float32)},
           "list": [1, 2, 3], "s": {"tag": "symbol", "name": "observed_data"}}
    assert tbson.dumps(doc) == jbson.dumps(doc)
    for write, read in ((jbson.dump_bson, tbson.load_bson), (tbson.dump_bson, jbson.load_bson)):
        p = tmp_path / "t.bson"
        write(p, doc)
        back = read(p)
        for k in ("f32", "f64", "i64", "u8"):
            np.testing.assert_array_equal(back[k], doc[k])
            assert back[k].dtype == doc[k].dtype
        assert back["s"] == "observed_data" and back["list"] == [1, 2, 3]
    inner = {"tag": "array", "type": {"tag": "datatype", "params": [], "name": ["Core", "Float32"]},
             "size": [2], "data": np.array([7.0, 8.0], np.float32).tobytes()}
    blob = tbson.dumps({"_backrefs": [inner], "x": {"tag": "backref", "ref": 1}})
    np.testing.assert_array_equal(tbson.loads(blob)["x"], [7.0, 8.0])
    with pytest.raises(ValueError, match="unsupported"):
        tbson.loads(b"\x0c\x00\x00\x00\x7fk\x00\x00\x00\x00\x00\x00")


def _fabricated_physionet(n=10, steps=6, feats=3, seed=0):
    """A physionet-schema BSON.jl bundle: data (feats, steps, n), stamps
    (steps, n), column-major, under ``data``."""
    rng = np.random.default_rng(seed)
    raw = {k: rng.normal(size=(feats, steps, n)).astype(np.float32)
           for k in ("observed_data", "observed_mask", "data_to_predict", "mask_predicted_data")}
    raw.update({k: rng.uniform(size=(steps, n)).astype(np.float32)
                for k in ("observed_tp", "tp_to_predict")})
    return {"data": raw}


def test_physionet_bundle_from_bson_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("REGNDE_NATIVE_LOADER", "0")
    p = tmp_path / "physionet.bson"
    tbson.dump_bson(p, _fabricated_physionet(n=40))
    want = jdata.physionet_bundle_from_bson(p)
    got = physionet_bundle_from_bson(p)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["observed_data"].shape == (40, 6, 3) and got["observed_tp"].shape == (40, 6)
    jtr, _ = jdata.load_physionet(8, path=str(p))
    ttr, _ = tdata.load_physionet(8, path=str(p))
    assert ttr.source == str(p)
    for jb, tb in zip(jtr, ttr):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, np.asarray(b))
    bad = _fabricated_physionet()
    bad["data"]["observed_tp"] = np.zeros((2, 3, 4), np.float32)
    tbson.dump_bson(p, bad)
    with pytest.raises(ValueError, match="observed_tp"):
        physionet_bundle_from_bson(p)


def test_adabelief_matches_optax():
    """``AdaBelief(0.01)`` (``sde_toy_optimizer``) against optax's
    ``adabelief(0.01)`` over 5 updates from zero state, at 1e-6; a zero
    gradient entry exercises eps and eps_root."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (3,), (2, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes] for _ in range(5)]
    grads[1][0][0, 0] = 0.0
    opt = jax_sde_toy_optimizer()
    jp = [jnp.asarray(p) for p in params]
    js = opt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    topt = sde_toy_optimizer()
    assert isinstance(topt, AdaBelief)
    ts = topt.init(tp)
    for g in grads:
        ju, js = opt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update([torch.from_numpy(x) for x in g], ts, tp)
        for u, v in zip(tu, ju):
            np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-6, atol=1e-9)
        tp = [p + u for p, u in zip(tp, tu)]
    for p, q in zip(tp, jp):
        np.testing.assert_allclose(p.numpy(), np.asarray(q), rtol=1e-6, atol=1e-7)
