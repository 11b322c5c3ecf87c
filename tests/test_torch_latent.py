"""The latent ODE of the port against the JAX package's: ``saveat`` on the
fast adjoint, the encoder/decoder modules, the latent model, the physionet
surrogate, AdaMax, and the regularized training step of ``bench.py``.

Small widths: batch 8, 5 observed features over 5 stamps, ``LatentGRU(5,
hidden 7, latent 8)``, ``MLP((8, 12))`` to a latent of 6, dynamics
``AlternatingMLP(6, 10, depth 2)``, Tsit5 at rtol=atol=1e-4. The JAX
model runs ``fused=False`` (its generic XLA sweep, the same math as its
K7/K8); the port runs ``fused="step"`` (on the CPU the wrappers take the
plain versions of K7/K8), ``fused=False`` and, for the training step,
``fused=True`` (the plain versions of the whole solve K3/K4). Both packages get the same
numpy arrays; parameters cross with ``convert.latent_ode_state_dict``, and
the reparameterization noise is JAX's own draw fed to the port (``eps``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regneuralde_tpu import reg as jreg
from regneuralde_tpu.data import datasets as jdata
from regneuralde_tpu.models import MLP as JMLP
from regneuralde_tpu.models import AlternatingMLP as JAltMLP
from regneuralde_tpu.models import LatentGRU as JGRU
from regneuralde_tpu.models import LatentTimeSeriesModel as JLatent
from regneuralde_tpu.models import NeuralODE as JNODE
from regneuralde_tpu.ops import ode as jode
from regneuralde_tpu.ops import pallas_generic as jpg
from regneuralde_tpu.training import latent_ode_optimizer as j_optimizer
from regneuralde_tpu_torch import reg as treg
from regneuralde_tpu_torch.convert import latent_ode_state_dict
from regneuralde_tpu_torch.data import datasets as tdata
from regneuralde_tpu_torch.data import load_physionet
from regneuralde_tpu_torch.models import (
    MLP,
    AlternatingMLP,
    LatentGRU,
    LatentTimeSeriesModel,
    NeuralODE,
)
from regneuralde_tpu_torch.ops import fused_generic as fg
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import ode as tode
from regneuralde_tpu_torch.training import (
    create_train_state,
    latent_ode_optimizer,
    make_train_step,
)

torch.set_num_threads(1)

BATCH, FEATS, STEPS = 8, 5, 5
GRU_HIDDEN, GRU_LATENT, LATENT, HIDDEN, DEPTH = 7, 8, 6, 10, 2
TOL, MAX_STEPS, SIGMA = 1e-4, 64, 0.01


@pytest.fixture
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


# ---------------------------------------------------------------------------
# (c) saveat on the fast adjoint
# ---------------------------------------------------------------------------


def _dyn_case(seed, batch=BATCH, dim=LATENT, hidden=HIDDEN, depth=DEPTH, scale=1.0):
    """AlternatingMLP leaves (weights ``scale`` times LeCun's) and y0."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    leaves = []
    for _ in range(depth):
        leaves += [f32(rng.normal(size=(hidden, dim)) / np.sqrt(dim) * scale),
                   f32(rng.normal(size=hidden) * 0.1),
                   f32(rng.normal(size=(dim, hidden)) / np.sqrt(hidden) * scale),
                   f32(rng.normal(size=dim) * 0.1)]
    return leaves, f32(rng.normal(size=(batch, dim)) * 0.8)


def _jax_apply(depth, dtype):
    """AlternatingMLP over JAX-layout leaves; in float64 with its products
    in float64 (the package's own computes them into float32)."""
    if dtype == jnp.float32:
        return jpg.alternating_mlp_apply(depth)

    def apply_fn(t, y, leaves):
        h = jnp.tanh(y)
        for j in range(2 * depth):
            h = jnp.tanh(h @ leaves[2 * j] + leaves[2 * j + 1])
        return h

    return apply_fn


REG_W = 0.3


def _loss_parts(ys, tel, where, sum_, arange):
    w = arange(1.0, ys.shape[0] + 1.0)[:, None, None]
    reg = sum_(where(tel.accepted, tel.eest * tel.dt, 0.0 * tel.eest))
    return sum_(w * ys ** 2) + REG_W * reg


def _jax_saveat_solve(leaves, y0, t1, sa, dtype, tol=TOL):
    """JAX's fast adjoint with ``saveat`` (``_make_fast_adjoint_solve``),
    over the generic sweep ``_stage_algebra`` and its ``jax.vjp``: the
    value and gradients of sum(w * ys^2) + 0.3 * sum_accepted(eest * dt)."""
    depth = len(leaves) // 4
    apply = _jax_apply(depth, dtype)
    alg = jpg._stage_algebra(apply, tol, tol)
    sweep = lambda t, dt, y, k1, p: jode.NormedSweep(*alg(t, dt, y, k1, p))

    def sweep_bwd(t, dt, y, k1, p, cts):
        _, vjp = jax.vjp(alg, t, dt, y, k1, p)
        return vjp(tuple(cts))

    def loss(p, y0, t1):
        sol = jode.odeint(lambda t, y, a: apply(t, y, a), y0, 0.0, t1, p, rtol=tol,
                          atol=tol, max_steps=MAX_STEPS, mode="adjoint", saveat=sa,
                          stage_sweep=sweep, stage_sweep_bwd=sweep_bwd)
        return _loss_parts(sol.ys, sol.telemetry, jnp.where, jnp.sum, jnp.arange), sol

    p = [jnp.asarray(a.T if j % 2 == 0 else a[None, :], dtype) for j, a in enumerate(leaves)]
    fn = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
    (val, sol), grads = fn(p, jnp.asarray(y0, dtype), jnp.asarray(t1, dtype))
    flat = [np.asarray(g).T if j % 2 == 0 else np.asarray(g)[0]
            for j, g in enumerate(grads[0])]
    return float(val), sol, flat + [np.asarray(grads[1]), np.asarray(grads[2])]


def _torch_saveat_solve(leaves, y0, t1, sa, dtype, sweep="altmlp", tol=TOL):
    lv = [torch.tensor(a, dtype=dtype).requires_grad_(True) for a in leaves]
    y0_ = torch.tensor(y0, dtype=dtype).requires_grad_(True)
    t1_ = torch.tensor(t1, dtype=dtype, requires_grad=True)
    depth = len(leaves) // 4
    kw = {}
    if sweep == "altmlp":
        s, sb = fg.make_alternating_mlp_sweep(tol, tol)
        kw = dict(stage_sweep=s, stage_sweep_bwd=sb)
    sol = tode.odeint(fg.alternating_mlp_apply(depth), y0_, 0.0, t1_, tuple(lv), rtol=tol,
                      atol=tol, max_steps=MAX_STEPS, mode="adjoint",
                      saveat=torch.tensor(sa, dtype=dtype), **kw)
    val = _loss_parts(sol.ys, sol.telemetry, torch.where, torch.sum,
                      lambda a, b: torch.arange(a, b, dtype=dtype))
    grads = torch.autograd.grad(val, [*lv, y0_, t1_])
    return val.item(), sol, [g.numpy() for g in grads]


def _assert_same_decisions(tsol, jsol):
    assert tsol.stats.success and bool(jsol.stats.success)
    assert (tsol.stats.nfe, tsol.stats.naccept, tsol.stats.nreject) == (
        int(jsol.stats.nfe), int(jsol.stats.naccept), int(jsol.stats.nreject))
    np.testing.assert_array_equal(tsol.telemetry.accepted.numpy(),
                                  np.asarray(jsol.telemetry.accepted))
    np.testing.assert_array_equal(tsol.telemetry.live.numpy(),
                                  np.asarray(jsol.telemetry.live))


GRAD_NAMES = [f"{n}_{i}.{p}" for i in range(DEPTH) for n in ("up", "down")
              for p in ("weight", "bias")] + ["y0", "t1"]
SAVEAT = {1.0: [0.0, 0.2, 0.5, 0.8, 1.0], -0.7: [0.0, -0.1, -0.35, -0.6, -0.7]}


@pytest.mark.parametrize("sweep", ["altmlp", "generic"])
@pytest.mark.parametrize("t1", [1.0, -0.7])
def test_saveat_fast_adjoint_matches_jax_float64(x64, t1, sweep):
    """float64: the port's fast adjoint with ``saveat`` (``altmlp``: the
    plain K7/K8 pair; ``generic``: the plain normed sweep over the module
    with its autograd reverse) against JAX's. The stamps include t0, whose
    row holds y0 and sends its cotangent to y0. Same NFE and accept
    sequence; ys and telemetry at rtol=1e-7, atol=1e-10; the value at
    rtol=1e-9 and the gradients (leaves, y0, t1) at rtol=1e-6, atol=1e-9
    (the same math; XLA's and ATen's pow in the controller differ by ulps,
    which the step sizes carry). Weights at three times LeCun's scale and
    rtol=atol=1e-6 make it twenty-odd trial steps, most writing no stamp. t1 < 0 integrates
    backwards in time."""
    leaves, y0 = _dyn_case(0, scale=3.0)
    sa = SAVEAT[t1]
    jval, jsol, jgrads = _jax_saveat_solve(leaves, y0, t1, sa, jnp.float64, 1e-6)
    tval, tsol, tgrads = _torch_saveat_solve(leaves, y0, t1, sa, torch.float64, sweep, 1e-6)
    _assert_same_decisions(tsol, jsol)
    assert tsol.stats.naccept >= 8
    np.testing.assert_allclose(tsol.ys.detach().numpy(), np.asarray(jsol.ys), rtol=1e-7,
                               atol=1e-10)
    np.testing.assert_array_equal(tsol.ys[0].detach().numpy(), y0.astype(np.float64))
    for name in ("t", "dt", "eest", "eigen_est"):
        np.testing.assert_allclose(getattr(tsol.telemetry, name).detach().numpy(),
                                   np.asarray(getattr(jsol.telemetry, name)),
                                   rtol=1e-7, atol=1e-10, err_msg=name)
    np.testing.assert_allclose(tval, jval, rtol=1e-9)
    for name, a, b in zip(GRAD_NAMES, tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=name)


def test_saveat_fast_adjoint_matches_jax_float32():
    """float32, the plain K7/K8 pair against JAX's generic sweep: the same
    NFE and accept sequence; ys within the solve's tolerance (1e-4); the
    value at rtol=1e-5; each weight and y0 gradient within 2e-3 relative
    (Frobenius), the fast adjoint's float32 tolerance of
    ``test_torch_solver.py`` (the embedded error sits near its float32
    rounding floor, and ATen's and XLA's tanh differ by ulps). The t1
    gradient is a cancellation of terms of the loss's size down to ~1e-4:
    it is held to 2e-3 of the y0 gradient's norm instead."""
    leaves, y0 = _dyn_case(1)
    sa = SAVEAT[1.0]
    jval, jsol, jgrads = _jax_saveat_solve(leaves, y0, 1.0, sa, jnp.float32)
    tval, tsol, tgrads = _torch_saveat_solve(leaves, y0, 1.0, sa, torch.float32)
    _assert_same_decisions(tsol, jsol)
    np.testing.assert_allclose(tsol.ys.detach().numpy(), np.asarray(jsol.ys), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tval, jval, rtol=1e-5)
    for name, a, b in zip(GRAD_NAMES[:-1], tgrads, jgrads):
        assert np.linalg.norm(a - b) <= 2e-3 * np.linalg.norm(b), name
    assert abs(tgrads[-1] - jgrads[-1]) <= 2e-3 * np.linalg.norm(jgrads[-2])


def test_saveat_fast_adjoint_matches_autograd_through_the_loop():
    """The oracle without JAX: autograd straight through the trial-step
    loop and the Hermite writes (``_solve_forward`` with grad on, the
    differentiable K7 plain version each step), float64. The fast adjoint
    gives the same gradients (rtol 1e-9)."""
    leaves, y0 = _dyn_case(2)
    dtype = torch.float64
    sa = torch.tensor(SAVEAT[1.0], dtype=dtype)
    tval, tsol, tgrads = _torch_saveat_solve(leaves, y0, 1.0, SAVEAT[1.0], dtype)
    lv = [torch.tensor(a, dtype=dtype).requires_grad_(True) for a in leaves]
    y0_ = torch.tensor(y0, dtype=dtype).requires_grad_(True)
    t0 = torch.tensor(0.0, dtype=dtype)
    t1 = torch.tensor(1.0, dtype=dtype, requires_grad=True)
    func = fg.alternating_mlp_apply(DEPTH)
    f0 = func(t0, y0_, lv)
    from regneuralde_tpu_torch.ops.controller import PIController, initial_step_size

    dt0, _ = initial_step_size(func, t0, y0_, f0, lv, 5, TOL, TOL, t1)
    sweep, _ = fg.make_alternating_mlp_sweep(TOL, TOL)
    ys0 = torch.where((sa <= 0)[:, None, None], y0_[None], torch.zeros(5, *y0.shape,
                                                                        dtype=dtype))
    saver = tode._HermiteSaver(sa, torch.sign(t1 - t0), ys0, keep=False)
    y1, rows, accepted, done, _ = tode._solve_forward(
        sweep, PIController.for_order(5), MAX_STEPS, t0, t1, dt0, y0_, f0, tuple(lv),
        keep_history=False, on_accept=saver)
    tel = tode._telemetry(rows, accepted, MAX_STEPS, t0)
    val = _loss_parts(saver.ys, tel, torch.where, torch.sum,
                      lambda a, b: torch.arange(a, b, dtype=dtype))
    grads = torch.autograd.grad(val, [*lv, y0_, t1])
    assert done and accepted == tsol.telemetry.accepted[tsol.telemetry.live].tolist()
    np.testing.assert_allclose(val.item(), tval, rtol=1e-12)
    for name, a, b in zip(GRAD_NAMES, tgrads, grads):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-9, atol=1e-12, err_msg=name)


def test_saveat_while_mode_matches_adjoint_forward():
    """``mode="while"`` writes the same rows as the fast adjoint (bitwise)."""
    leaves, y0 = _dyn_case(0)
    lv = tuple(torch.tensor(a) for a in leaves)
    kw = dict(rtol=TOL, atol=TOL, max_steps=MAX_STEPS, saveat=SAVEAT[1.0])
    s, sb = fg.make_alternating_mlp_sweep(TOL, TOL)
    func = fg.alternating_mlp_apply(DEPTH)
    a = tode.odeint(func, torch.tensor(y0), 0.0, 1.0, lv, mode="adjoint", stage_sweep=s,
                    stage_sweep_bwd=sb, **kw)
    w = tode.odeint(func, torch.tensor(y0), 0.0, 1.0, lv, mode="while", stage_sweep=s,
                    stage_sweep_bwd=sb, **kw)
    assert a.stats == w.stats
    assert torch.equal(a.ys, w.ys) and torch.equal(a.y1, w.y1)
    assert torch.equal(a.ts, w.ts) and torch.equal(a.ys[-1], a.y1)


# ---------------------------------------------------------------------------
# (d) the modules and the latent model against flax
# ---------------------------------------------------------------------------


def _data(seed=0, n=64):
    """Physionet-schema surrogate at the small widths, and the model input
    ``[data, mask, delta_t]`` of ``bench.py``."""
    b = tdata._synthetic_physionet(n=n, feats=FEATS, steps=STEPS, seed=seed)
    d, m, tp = (b[k][:3 * BATCH] for k in ("observed_data", "observed_mask", "observed_tp"))
    return d, m, tp


def _inputs_np(d, m, tp):
    dt = np.concatenate([tp[:, 1:] - tp[:, :-1], np.zeros_like(tp[:, :1])], 1)
    return np.concatenate([d, m, dt[..., None]], axis=-1).astype(np.float32)


def _jax_model(saveat):
    node = JNODE(JAltMLP(dim=LATENT, hidden=HIDDEN, depth=DEPTH), time_dep=False,
                 rtol=TOL, atol=TOL, max_steps=MAX_STEPS, saveat=jnp.asarray(saveat))
    return JLatent(rnn=JGRU(in_dim=FEATS, hidden=GRU_HIDDEN, latent_dim=GRU_LATENT),
                   enc=JMLP(features=(GRU_LATENT, 2 * LATENT)), node=node,
                   dec=fnn.Dense(FEATS))


def _torch_model(jparams, saveat, fused):
    node = NeuralODE(AlternatingMLP(LATENT, HIDDEN, DEPTH, device="cpu"), time_dep=False, rtol=TOL,
                     atol=TOL, max_steps=MAX_STEPS, saveat=torch.tensor(saveat),
                     fused=fused)
    model = LatentTimeSeriesModel(
        rnn=LatentGRU(FEATS, GRU_HIDDEN, GRU_LATENT, device="cpu"),
        enc=MLP(2 * GRU_LATENT, (GRU_LATENT, 2 * LATENT), device="cpu"), node=node,
        dec=torch.nn.Linear(LATENT, FEATS))
    model.load_state_dict(latent_ode_state_dict(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return model


@pytest.fixture(scope="module")
def setup():
    d, m, tp = _data()
    saveat = np.sort(tp[0])
    model = _jax_model(saveat)
    x0 = jnp.asarray(_inputs_np(d[:BATCH], m[:BATCH], tp[:BATCH]))
    params = jax.jit(model.init)(jax.random.PRNGKey(3), x0)
    return dict(d=d, m=m, tp=tp, saveat=saveat, model=model, params=params)


def test_modules_match_flax(setup):
    """``LatentGRU``, ``MLP`` and ``AlternatingMLP`` on converted
    parameters against flax, rtol=2e-5, atol=1e-6 (ATen's and XLA's tanh
    and sigmoid differ by ulps; the GRU runs five steps)."""
    p = setup["params"]
    x = _inputs_np(setup["d"][:BATCH], setup["m"][:BATCH], setup["tp"][:BATCH])
    # an unobserved step freezes the GRU's state: make one
    x[:, 2, FEATS:2 * FEATS] = 0.0
    sd = latent_ode_state_dict(jax.tree_util.tree_map(np.asarray, p))
    sub = lambda prefix: {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    gru = LatentGRU(FEATS, GRU_HIDDEN, GRU_LATENT, device="cpu")
    gru.load_state_dict(sub("rnn."))
    h_j = JGRU(in_dim=FEATS, hidden=GRU_HIDDEN, latent_dim=GRU_LATENT).apply(
        p["rnn"], jnp.asarray(x))
    h_t = gru(torch.from_numpy(x))
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j), rtol=2e-5, atol=1e-6)
    enc = MLP(2 * GRU_LATENT, (GRU_LATENT, 2 * LATENT), device="cpu")
    enc.load_state_dict(sub("enc."))
    e_j = JMLP(features=(GRU_LATENT, 2 * LATENT)).apply(p["enc"], h_j)
    np.testing.assert_allclose(enc(torch.from_numpy(np.array(h_j))).detach().numpy(),
                               np.asarray(e_j), rtol=2e-5, atol=1e-6)
    dyn = AlternatingMLP(LATENT, HIDDEN, DEPTH, device="cpu")
    dyn.load_state_dict(sub("node.dynamics."))
    z = np.array(e_j)[:, :LATENT]
    f_j = JAltMLP(dim=LATENT, hidden=HIDDEN, depth=DEPTH).apply(p["de"], jnp.asarray(z))
    np.testing.assert_allclose(dyn(torch.from_numpy(z)).detach().numpy(), np.asarray(f_j),
                               rtol=2e-5, atol=1e-6)
    # the sigmoid gates' final activation and the mask freeze are both used
    assert np.any(x[:, :, FEATS:2 * FEATS].sum(-1) == 0)


@pytest.mark.parametrize("fused", ["step", False])
def test_latent_model_forward_matches_jax(setup, fused):
    """The whole model on JAX's noise draw: mu0 and logvar at rtol=2e-5,
    atol=1e-6; the same NFE and accept sequence; the decoded trajectory
    within the solve's tolerance (1e-4). ``init`` runs the node in
    ``"while"`` mode to size a lazy decoder and launches no kernel."""
    p, model = setup["params"], setup["model"]
    d, m, tp = setup["d"][:BATCH], setup["m"][:BATCH], setup["tp"][:BATCH]
    x = _inputs_np(d, m, tp)
    key = jax.random.PRNGKey(7)
    out_j = jax.jit(lambda p, x, k: model(p, x, k))(p, jnp.asarray(x), key)
    eps = np.asarray(jax.random.normal(key, (BATCH, LATENT), jnp.float32))
    tm = _torch_model(p, setup["saveat"], fused)
    out_t = tm(torch.from_numpy(x), eps=torch.from_numpy(eps))
    assert out_t.success and bool(out_j.success)
    assert out_t.nfe == int(out_j.nfe)
    np.testing.assert_array_equal(out_t.telemetry.accepted.numpy(),
                                  np.asarray(out_j.telemetry.accepted))
    for a, b in ((out_t.mu0, out_j.mu0), (out_t.logvar, out_j.logvar)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-5, atol=1e-6)
    assert out_t.result.shape == (BATCH, STEPS, FEATS)
    np.testing.assert_allclose(out_t.result.detach().numpy(), np.asarray(out_j.result),
                               rtol=TOL, atol=TOL)

    fg.reset_launches()
    lazy = LatentTimeSeriesModel(tm.rnn, tm.enc, tm.node, torch.nn.LazyLinear(FEATS))
    lazy.init(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert lazy.dec.weight.shape == (FEATS, LATENT)
    assert fg.LAUNCHES == {"altmlp_tsit5_fwd": 0, "altmlp_tsit5_bwd": 0}


# ---------------------------------------------------------------------------
# (e) physionet, (f) AdaMax
# ---------------------------------------------------------------------------


@pytest.fixture
def no_data_files(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REGNDE_DATA_DIR", raising=False)
    monkeypatch.setenv("REGNDE_NATIVE_LOADER", "0")
    return tmp_path


@pytest.mark.parametrize("seed", [0, 4])
def test_synthetic_physionet_equals_jax_bit_for_bit(no_data_files, seed):
    """The surrogate bundle, the split, both loaders' shuffles (two
    epochs) and the dropped partial batches, bitwise."""
    want = jdata._synthetic_physionet(n=300, seed=seed)
    got = tdata._synthetic_physionet(n=300, seed=seed)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jtr, jte = jdata.load_physionet(64, seed=seed)
    ttr, tte = load_physionet(64, seed=seed)
    assert ttr.source == "synthetic"
    assert (len(ttr), len(tte)) == (len(jtr), len(jte)) == (51, 12)
    for _epoch in range(2):
        for jl, tl in ((jtr, ttr), (jte, tte)):
            for jb, tb in zip(jl, tl):
                assert len(tb) == 6 and tb[0].shape == (64, 49, 37)
                for a, b in zip(tb, jb):
                    np.testing.assert_array_equal(a, np.asarray(b))


def test_physionet_npz_route_and_bson_refusal(no_data_files):
    """A ``physionet.npz`` is read like JAX reads it; the ``.bson`` route
    (the port's BSON.jl codec) refuses a bundle without the six keys with
    JAX's ``KeyError`` (the route itself: ``tests/test_torch_sde_toy.py``)."""
    bundle = jdata._synthetic_physionet(n=40, steps=6, feats=3, seed=1)
    np.savez(no_data_files / "physionet.npz", **bundle)
    jtr, _ = jdata.load_physionet(8, path=str(no_data_files / "physionet.npz"))
    ttr, _ = load_physionet(8, path=str(no_data_files / "physionet.npz"))
    assert ttr.source.endswith("physionet.npz")
    for jb, tb in zip(jtr, ttr):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, np.asarray(b))
    (no_data_files / "physionet.bson").write_bytes(b"\x05\x00\x00\x00\x00")
    with pytest.raises(KeyError, match="missing keys"):
        jdata.load_physionet(8, path=str(no_data_files / "physionet.bson"))
    with pytest.raises(KeyError, match="missing keys"):
        load_physionet(8, path=str(no_data_files / "physionet.bson"))


def test_adamax_chain_matches_optax():
    """InvDecay(1e-5) then AdaMax(0.01) against the JAX package's optax
    chain over 3 updates from zero state (rtol=1e-6, atol=1e-7); a zero
    gradient entry exercises AdaMax's eps."""
    rng = np.random.default_rng(0)
    shapes = [(12, 17), (12,), (16, 13), (16,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jopt, topt = j_optimizer(), latent_ode_optimizer()
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.tensor(p) for p in params]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(3):
        grads = [rng.normal(size=s).astype(np.float32) * 10 ** (i - 1) for s in shapes]
        grads[1][0] = 0.0
        ju, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update([torch.tensor(g) for g in grads], tstate)
        tp = [p + u for p, u in zip(tp, tu)]
        for a, b in zip(tu, ju):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (g) the regularized latent training step of bench.py
# ---------------------------------------------------------------------------


def _jax_loss(model, saveat):
    """``bench.py:186-194``: masked Gaussian log-likelihood (sigma 0.01) +
    KL + 1e3 * error_estimate(mean)."""

    def loss(params, d, m, tp, key):
        dt = jnp.concatenate([tp[:, 1:] - tp[:, :-1], jnp.zeros_like(tp[:, :1])], 1)
        x = jnp.concatenate([d, m, dt[..., None]], axis=-1)
        out = model(params, x, key, saveat=saveat)
        err = (out.result - d) * m
        ll = jnp.sum(-jnp.square(err) / (2 * SIGMA ** 2), axis=(1, 2))
        ll = ll / jnp.maximum(jnp.sum(m, axis=(1, 2)), 1.0)
        kl = jnp.mean(jnp.exp(out.logvar) + jnp.square(out.mu0) - 1 - out.logvar,
                      axis=-1) / 2
        r = jreg.error_estimate(out.telemetry, agg="mean")
        return -jnp.mean(ll - kl) + 1e3 * r, out

    return loss


def _torch_loss(model, d, m, tp, eps):
    x = torch.cat([d, m, torch.cat([tp[:, 1:] - tp[:, :-1], torch.zeros_like(tp[:, :1])],
                                   1)[..., None]], dim=-1)
    out = model(x, eps=eps)
    err = (out.result - d) * m
    ll = torch.sum(-torch.square(err) / (2 * SIGMA ** 2), dim=(1, 2))
    ll = ll / torch.clamp(torch.sum(m, dim=(1, 2)), min=1.0)
    kl = torch.mean(torch.exp(out.logvar) + torch.square(out.mu0) - 1 - out.logvar,
                    dim=-1) / 2
    r = treg.error_estimate(out.telemetry, "mean")
    return -torch.mean(ll - kl) + 1e3 * r, out


def _jax_flat(p):
    """The JAX tree's leaves in the port's ``parameters()`` order and layout."""
    sd = latent_ode_state_dict(jax.tree_util.tree_map(np.asarray, p))
    return {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def jax_train(setup):
    """The first step's loss, NFE, accepts and gradients, and the parameters
    after three InvDecay+AdaMax steps on three batches, with JAX's keys."""
    model, p = setup["model"], setup["params"]
    loss = _jax_loss(model, jnp.asarray(setup["saveat"]))
    grad_fn = jax.jit(jax.value_and_grad(loss, has_aux=True))
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    batches = [tuple(jnp.asarray(a[i * BATCH:(i + 1) * BATCH])
                     for a in (setup["d"], setup["m"], setup["tp"])) for i in range(3)]
    opt = j_optimizer()
    state = opt.init(p)
    run = dict(eps=[np.asarray(jax.random.normal(k, (BATCH, LATENT), jnp.float32))
                    for k in keys], steps=[])
    for b, k in zip(batches, keys):
        (val, out), g = grad_fn(p, *b, k)
        run["steps"].append(dict(loss=float(val), nfe=int(out.nfe),
                                 accepted=np.asarray(out.telemetry.accepted),
                                 grads=_jax_flat(g)))
        updates, state = opt.update(g, state, p)
        p = optax.apply_updates(p, updates)
    run["params_after"] = _jax_flat(p)
    return run


# The loss is dominated by the Gaussian log-likelihood (sigma 0.01); the
# regularizer 1e3 * error_estimate rides on the error estimate's float32
# rounding floor, where ATen's and XLA's tanh differ by ulps (the parity
# limit of ROADMAP queue 3). Measured here: the loss within 3e-7, the
# gradients within 1.2e-4 and the parameter moves within 1e-4 relative.
GRAD_BOUND = 2e-3


@pytest.mark.parametrize("fused", ["step", False, True])
def test_latent_training_steps_match_jax(setup, jax_train, fused):
    """One and three training steps (``bench.py``'s loss, InvDecay(1e-5)
    then AdaMax(0.01)): every step the same NFE and accept sequence and
    the loss at rtol=1e-5; the first step's gradients and each leaf's
    distance to JAX's parameters after three steps within GRAD_BOUND
    (relative, Frobenius) of its norm / of the distance it moved."""
    model = _torch_model(setup["params"], setup["saveat"], fused)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    optimizer = latent_ode_optimizer()
    state = create_train_state(model, optimizer)
    step = make_train_step(_torch_loss, optimizer)
    names = [n for n, _ in model.named_parameters()]
    for i, (want, eps) in enumerate(zip(jax_train["steps"], jax_train["eps"])):
        batch = [torch.from_numpy(np.asarray(a[i * BATCH:(i + 1) * BATCH]))
                 for a in (setup["d"], setup["m"], setup["tp"])]
        if i == 0:
            model.zero_grad()
            loss, _ = _torch_loss(model, *batch, torch.from_numpy(eps))
            loss.backward()
            for n, prm in model.named_parameters():
                b = want["grads"][n]
                assert np.linalg.norm(prm.grad.numpy() - b) <= GRAD_BOUND * np.linalg.norm(b), n
        state, loss, out = step(state, *batch, torch.from_numpy(eps))
        assert out.success and torch.isfinite(loss)
        assert out.nfe == want["nfe"]
        np.testing.assert_array_equal(out.telemetry.accepted.numpy(), want["accepted"])
        np.testing.assert_allclose(loss.item(), want["loss"], rtol=1e-5)
    assert state.step == 3
    for n in names:
        a = model.state_dict()[n].numpy()
        b, b0 = jax_train["params_after"][n], start[n].numpy()
        assert np.linalg.norm(a - b) <= GRAD_BOUND * np.linalg.norm(b - b0), n


# ---------------------------------------------------------------------------
# (h) routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, "solve", "tiled"])
def test_whole_solve_options_with_altmlp(fused, monkeypatch):
    """``mode="adjoint"`` runs the whole-solve wrappers for AlternatingMLP
    (``dynamics="altmlp"``), one forward and one backward call: with
    ``saveat`` on ``True``/``"solve"``, final-state on ``"tiled"``, whose
    ``saveat`` raises ``ValueError`` as in JAX; ``mode="while"`` takes the
    step route (K7 on the card), as in JAX."""
    from regneuralde_tpu_torch.ops import whole_solve as ws

    calls = []
    for name in ("whole_solve_fwd", "whole_solve_bwd"):
        real = getattr(ws, name)
        monkeypatch.setattr(ws, name, lambda *a, _n=name, _r=real, **k:
                            calls.append((_n, k["dynamics"], k["saveat"] is not None))
                            or _r(*a, **k))
    node = NeuralODE(AlternatingMLP(LATENT, HIDDEN, DEPTH, device="cpu"), time_dep=False,
                     rtol=TOL, atol=TOL, max_steps=MAX_STEPS, fused=fused)
    x = torch.from_numpy(_dyn_case(0)[1])
    sa = torch.tensor(SAVEAT[1.0])
    saves = fused != "tiled"
    if not saves:
        with pytest.raises(ValueError, match="final-state solves only"):
            node(x, saveat=sa)
    out = node(x, saveat=sa if saves else None)
    assert out.solution.stats.success
    assert out.value.shape == ((BATCH, 5, LATENT) if saves else (BATCH, LATENT))
    out.value.square().sum().backward()
    assert calls == [("whole_solve_fwd", "altmlp", saves), ("whole_solve_bwd", "altmlp", saves)]
    calls.clear()
    steps = []
    real = fg.altmlp_normed_sweep
    monkeypatch.setattr(fg, "altmlp_normed_sweep",
                        lambda *a: steps.append(1) or real(*a))
    out = node(x, mode="while", saveat=sa)
    assert out.solution.stats.success and out.value.shape == (BATCH, 5, LATENT)
    assert len(steps) == int(out.telemetry.live.sum()) and not calls


@pytest.mark.parametrize("fused", ["step", False])
def test_step_routes_take_the_altmlp_sweeps(fused, monkeypatch):
    """``fused="step"`` runs the K7/K8 wrappers, ``fused=False`` their plain
    versions and never the wrappers; the MLP step kernels stay unused."""
    calls = {"fwd": 0, "bwd": 0}
    real_f, real_b = fg.altmlp_normed_sweep, fg.altmlp_normed_sweep_bwd

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(fg, "altmlp_normed_sweep", count("fwd", real_f))
    monkeypatch.setattr(fg, "altmlp_normed_sweep_bwd", count("bwd", real_b))
    node = NeuralODE(AlternatingMLP(LATENT, HIDDEN, DEPTH, device="cpu"), time_dep=False, rtol=TOL,
                     atol=TOL, max_steps=MAX_STEPS, fused=fused,
                     saveat=torch.tensor(SAVEAT[1.0]))
    fm.reset_launches()
    out = node(torch.from_numpy(_dyn_case(0)[1]))
    out.value.square().sum().backward()
    n = int(out.telemetry.live.sum())
    assert calls == ({"fwd": n, "bwd": n} if fused else {"fwd": 0, "bwd": 0})
    assert fm.LAUNCHES == {k: 0 for k in fm.LAUNCHES} and len(fm.LAUNCHES) == 4
