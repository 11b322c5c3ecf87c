"""The port's CUDA kernels K1/K2 against their plain PyTorch versions.

These tests need a CUDA device and ``nvcc`` (the kernels have no CPU mode)
and skip without one. This file imports no JAX, so it runs on a machine
that has only PyTorch:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -o addopts=""
"""

import numpy as np
import pytest
import torch

from regneuralde_tpu_torch.ops import fused_mlp as fm

T, DT = 0.07, 0.11


def _inputs(batch, dim, hidden, device, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    leaves = [f32(rng.normal(size=(hidden, dim + 1)) / np.sqrt(dim + 1)),
              f32(rng.normal(size=hidden) * 0.1),
              f32(rng.normal(size=(dim, hidden + 1)) / np.sqrt(hidden + 1)),
              f32(rng.normal(size=dim) * 0.1)]
    y = f32(rng.normal(size=(batch, dim)) * 0.5)
    k1 = f32(rng.normal(size=(batch, dim)) * 0.3)
    cts = [f32(rng.normal(size=(batch, dim))), f32(rng.normal(size=(batch, dim))),
           f32(0.7), f32(1.3), f32(-0.4)]
    return y, k1, leaves, cts


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tol", [1e-4, 1.4e-8])
@pytest.mark.parametrize("shape", [(13, 40, 24), (5, 8, 5), (512, 784, 100)])
def test_kernels_match_plain_versions(cuda, shape, tol):
    """Ragged row tiles included (13 and 5 rows). Forward by relative
    Frobenius error <= 1e-4; backward <= 1e-3, since its seeds multiply
    by 1/(atol + |y| rtol) and amplify f32 rounding."""
    y, k1, leaves, cts = _inputs(*shape, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    parts = fm._split_params(*leaves)
    fm.reset_launches()
    kern = fm.normed_sweep_fwd(t, dt, y, k1, leaves, tol, tol)
    plain = fm._reference_normed_sweep(t, dt, y, k1, parts, tol, tol)
    for a, b in zip(kern, plain):
        assert _rel(a, b) <= 1e-4
    kern_b = fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, tol, tol)
    plain_b = fm._normed_bwd_math(t, dt, y, k1, parts, cts, tol, tol)
    for a, b in zip([*kern_b[:4], *kern_b[4]], [*plain_b[:4], *plain_b[4]]):
        assert _rel(a, b) <= 1e-3
    assert fm.LAUNCHES == {"normed_tsit5_fwd": 1, "normed_tsit5_bwd": 1}


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda):
    """Fixed-order sums: two launches give bitwise-equal results."""
    y, k1, leaves, cts = _inputs(64, 96, 32, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    a = fm.normed_sweep_fwd(t, dt, y, k1, leaves, 1e-6, 1e-6)
    b = fm.normed_sweep_fwd(t, dt, y, k1, leaves, 1e-6, 1e-6)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    ga = fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-6, 1e-6)
    gb = fm.normed_sweep_bwd(t, dt, y, k1, leaves, cts, 1e-6, 1e-6)
    assert all(torch.equal(u, v) for u, v in zip([*ga[:4], *ga[4]], [*gb[:4], *gb[4]]))


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(cuda):
    y, k1, leaves, _ = _inputs(8, 16, 12, cuda)
    t, dt = torch.tensor(T, device=cuda), torch.tensor(DT, device=cuda)
    with pytest.raises(TypeError):
        fm.normed_sweep_fwd(t, dt, y.double(), k1, leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_fwd(t, dt, y.t(), k1, leaves, 1e-4, 1e-4)
    with pytest.raises(ValueError):
        fm.normed_sweep_fwd(t, dt, y, k1.cpu(), leaves, 1e-4, 1e-4)
