"""The port's data, optimizer, conversion and model-option checks against
the JAX package (numpy route of ``load_mnist``, the optax InvDecay +
Momentum chain, ``convert.py``, ``NeuralODE`` argument validation)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regneuralde_tpu.data import load_mnist as j_load_mnist
from regneuralde_tpu.models import ClassifierNODE as JClassifier
from regneuralde_tpu.models import MLPDynamics as JMLP
from regneuralde_tpu.models import NeuralODE as JNODE
from regneuralde_tpu.training import mnist_node_optimizer as j_optimizer
from regneuralde_tpu_torch.convert import classifier_node_state_dict
from regneuralde_tpu_torch.data import DataLoader, load_mnist
from regneuralde_tpu_torch.models import ClassifierNODE, MLPDynamics, NeuralODE
from regneuralde_tpu_torch.training import mnist_node_optimizer

torch.set_num_threads(1)


@pytest.fixture
def no_data_files(tmp_path, monkeypatch):
    """Run where neither package finds MNIST files: the synthetic route."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("REGNDE_DATA_DIR", raising=False)
    monkeypatch.setenv("REGNDE_NATIVE_LOADER", "0")


@pytest.mark.parametrize("flatten", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_mnist_batches_equal_jax_bit_for_bit(no_data_files, seed, flatten):
    jtr, jte = j_load_mnist(64, flatten=flatten, seed=seed)
    ttr, tte = load_mnist(64, flatten=flatten, seed=seed)
    assert ttr.source == "synthetic"
    for _epoch in range(2):  # the shuffle advances per epoch on both sides
        for (jx, jy), (tx, ty) in zip(jtr, ttr):
            np.testing.assert_array_equal(tx, np.asarray(jx))
            np.testing.assert_array_equal(ty, np.asarray(jy))
    assert len(ttr) == len(jtr) and len(tte) == len(jte)
    jx, jy = next(iter(jte))
    tx, ty = next(iter(tte))
    np.testing.assert_array_equal(tx, np.asarray(jx))
    np.testing.assert_array_equal(ty, np.asarray(jy))


def test_mnist_npz_is_read_like_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "mnist.npz",
             x_train=rng.integers(0, 256, (20, 28, 28), dtype=np.uint8),
             y_train=rng.integers(0, 10, 20), x_test=rng.integers(0, 256, (6, 28, 28),
                                                                   dtype=np.uint8),
             y_test=rng.integers(0, 10, 6))
    monkeypatch.setenv("REGNDE_NATIVE_LOADER", "0")
    jtr, _ = j_load_mnist(8, data_dir=str(tmp_path), flatten=True)
    ttr, _ = load_mnist(8, data_dir=str(tmp_path), flatten=True)
    assert ttr.source.endswith("mnist.npz")
    for (jx, jy), (tx, ty) in zip(jtr, ttr):
        np.testing.assert_array_equal(tx, np.asarray(jx))
        np.testing.assert_array_equal(ty, np.asarray(jy))


def test_loader_partial_batches():
    x = np.arange(10)[:, None]
    loader = DataLoader((x,), 4, shuffle=False)
    assert [b.shape[0] for b in loader] == [4, 4, 2]
    assert len(DataLoader((x,), 4, drop_last=True)) == 2
    with pytest.raises(ValueError):
        DataLoader((x, np.arange(3)), 2)


def test_optimizer_matches_optax_chain():
    """InvDecay(1e-5) then Momentum(0.1, 0.9) over 5 steps on random
    gradients, from zero state on both sides."""
    rng = np.random.default_rng(0)
    shapes = [(12, 17), (12,), (16, 13), (16,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jopt, topt = j_optimizer(), mnist_node_optimizer()
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.tensor(p) for p in params]
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        grads = [rng.normal(size=s).astype(np.float32) * 10 for s in shapes]
        ju, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, ju)
        tu, tstate = topt.update([torch.tensor(g) for g in grads], tstate)
        tp = [p + u for p, u in zip(tp, tu)]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _jax_params(dim=16, hidden=12):
    node = JNODE(JMLP(dim=dim, hidden=hidden), rtol=1e-3, atol=1e-3, max_steps=32)
    import flax.linen as fnn

    clf = JClassifier(None, node, fnn.Dense(10))
    x = jnp.asarray(np.random.default_rng(0).uniform(size=(4, dim)), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.jit(clf.init)(jax.random.PRNGKey(0), x))


def test_convert_round_trips_shapes_and_values():
    params = _jax_params()
    sd = classifier_node_state_dict(params)
    de, post = params["de"]["params"], params["post"]["params"]
    np.testing.assert_array_equal(sd["node.dynamics.dense_1.weight"].numpy().T,
                                  de["dense_1"]["kernel"])
    np.testing.assert_array_equal(sd["node.dynamics.dense_2.bias"].numpy(),
                                  de["dense_2"]["bias"])
    np.testing.assert_array_equal(sd["post.weight"].numpy().T, post["kernel"])
    clf = ClassifierNODE(None, NeuralODE(MLPDynamics(16, 12)), torch.nn.Linear(16, 10))
    clf.load_state_dict(sd)  # strict: every key and shape matches
    assert {k: tuple(v.shape) for k, v in clf.state_dict().items()} == {
        "node.dynamics.dense_1.weight": (12, 17), "node.dynamics.dense_1.bias": (12,),
        "node.dynamics.dense_2.weight": (16, 13), "node.dynamics.dense_2.bias": (16,),
        "post.weight": (10, 16), "post.bias": (10,)}
    with pytest.raises(NotImplementedError):
        classifier_node_state_dict({**params, "pre": {}})


def test_mlp_dynamics_matches_flax():
    params = _jax_params()["de"]
    m = MLPDynamics(16, 12)
    m.load_state_dict({k.replace("node.dynamics.", ""): v for k, v in
                       classifier_node_state_dict({"de": params, "post": {"params": {
                           "kernel": np.zeros((16, 10), np.float32),
                           "bias": np.zeros(10, np.float32)}}}).items()
                       if k.startswith("node.dynamics.")})
    x = np.random.default_rng(1).normal(size=(5, 16)).astype(np.float32)
    want = JMLP(dim=16, hidden=12).apply(params, jnp.asarray(x), 0.3)
    got = m(torch.from_numpy(x), 0.3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5,
                               atol=5e-7)


@pytest.mark.parametrize("fused", [True, "solve", "tiled"])
def test_unported_fused_routes_raise_not_implemented(fused):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NeuralODE(MLPDynamics(8, 4), fused=fused)


@pytest.mark.parametrize("kwargs", [
    dict(fused="fast"), dict(per_sample="lanes"), dict(fused="step", solver="dopri5"),
    dict(fused=True, compensated_eest=True)])
def test_bad_options_raise_value_error(kwargs):
    with pytest.raises(ValueError):
        NeuralODE(MLPDynamics(8, 4), **kwargs)


def test_fused_requires_mlp_dynamics():
    with pytest.raises(ValueError):
        NeuralODE(torch.nn.Linear(8, 8), fused="step")


@pytest.mark.parametrize("per_sample", [True, "batched"])
def test_per_sample_raises_not_implemented(per_sample):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NeuralODE(MLPDynamics(8, 4), per_sample=per_sample)
