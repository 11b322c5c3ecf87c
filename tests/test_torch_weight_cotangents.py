"""The weight-cotangent contraction that ends K2, K4<MlpDyn>, K12 and K14
(``regneuralde_tpu_torch.ops.weight_cotangents``) on the CPU: its plain
version on the rows of the plain normed backward, against that backward
and against the JAX package's ``pallas_mlp._normed_bwd_math``; the chunk
rule the kernel runs by; and a float32 emulation of the kernel's order of
summation (each chunk's rows in order, then the chunks in order).

Both packages get the same numpy arrays from a seeded generator
(``MLPDynamics(16, 12)``, batch 8, and 13 for a ragged tile). The kernel
itself runs only on the card: ``test_torch_kernels_cuda.py`` and
``chip_smoke.py`` phase 31.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regneuralde_tpu.ops import pallas_mlp as jmlp
from regneuralde_tpu_torch.ops import fused_mlp as fm
from regneuralde_tpu_torch.ops import weight_cotangents as wc

torch.set_num_threads(1)

DIM, HIDDEN = 16, 12
RTOL = ATOL = 1e-4
T, DT = 0.07, 0.11
SCALAR_CTS = (0.7, 1.3, -0.4)


def _case(batch, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        W1=f32(rng.normal(size=(HIDDEN, DIM + 1)) / np.sqrt(DIM + 1)),
        b1=f32(rng.normal(size=HIDDEN) * 0.1),
        W2=f32(rng.normal(size=(DIM, HIDDEN + 1)) / np.sqrt(HIDDEN + 1)),
        b2=f32(rng.normal(size=DIM) * 0.1),
        y=f32(rng.normal(size=(batch, DIM)) * 0.5),
        k1=f32(rng.normal(size=(batch, DIM)) * 0.3),
        ct_y_new=f32(rng.normal(size=(batch, DIM))),
        ct_k7=f32(rng.normal(size=(batch, DIM))),
    )


def _weight_rows(rows):
    """``(cp2, he, cp1, ye)`` from ``_reverse_stages``' ``rows`` in the
    layout K2 stores them: stage ``i``'s rows at ``(i - 1) * B``, ``he =
    [h, t_i, 1]`` and ``ye = [y_i, t_i, 1]``."""
    def ext(x, ti):
        one = torch.ones_like(x[:, :1])
        return torch.cat([x, ti * one, one], dim=1)

    cp2, he, cp1, ye = [], [], [], []
    for _, ct_pre2, h_i, ct_pre1, yi, ti in sorted(rows, key=lambda r: r[0]):
        cp2.append(ct_pre2)
        he.append(ext(h_i, ti))
        cp1.append(ct_pre1)
        ye.append(ext(yi, ti))
    return tuple(torch.cat(x).contiguous() for x in (cp2, he, cp1, ye))


def _plain_backward(c, dtype):
    """The plain normed backward (K2's plain version) and the rows it
    hands the contraction, in K2's layout."""
    tt = lambda a: torch.tensor(a, dtype=dtype)
    leaves = [tt(c[k]) for k in ("W1", "b1", "W2", "b2")]
    cts = (tt(c["ct_y_new"]), tt(c["ct_k7"]), *(tt(s) for s in SCALAR_CTS))
    rows = []
    out = fm._normed_bwd_math(tt(T), tt(DT), tt(c["y"]), tt(c["k1"]),
                              fm._split_params(*leaves), cts, RTOL, ATOL, rows=rows)
    return out[4], _weight_rows(rows)


def _rel(a, b):
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


@pytest.mark.parametrize("batch", [8, 13])
def test_plain_contraction_equals_plain_backward(batch):
    """The rows' contraction is the backward's weight cotangents summed in
    another order: elementwise within rtol 1e-5 in float64. In float32 the
    norm seeds (1/atol) amplify the rows' own rounding (both results lie
    3e-5 to 7e-5 from float64, relative Frobenius, and 1e-5 from each
    other), so there the contraction is held to within 1.5 times the
    backward's own distance from the float64 result."""
    c = _case(batch)
    exact, rows = _plain_backward(c, torch.float64)
    assert rows[0].shape == (6 * batch, DIM) and rows[1].shape == (6 * batch, HIDDEN + 2)
    assert rows[2].shape == (6 * batch, HIDDEN) and rows[3].shape == (6 * batch, DIM + 2)
    for a, b in zip(wc.weight_cotangents_plain(*rows), exact):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=0)
    want, rows = _plain_backward(c, torch.float32)
    for a, b, x in zip(wc.weight_cotangents(*rows), want, exact):
        assert a.shape == b.shape and _rel(a, x) <= 1.5 * _rel(b, x)


@pytest.mark.parametrize("batch", [8, 13])
def test_plain_contraction_matches_jax_normed_bwd_math(batch):
    """Within the tolerance ``test_torch_fused_mlp`` holds the plain normed
    backward to against JAX's (the JAX package's own, tests/
    test_pallas_fused.py:180-188)."""
    c = _case(batch)
    params = {"params": {
        "dense_1": {"kernel": jnp.asarray(c["W1"].T), "bias": jnp.asarray(c["b1"])},
        "dense_2": {"kernel": jnp.asarray(c["W2"].T), "bias": jnp.asarray(c["b2"])},
    }}
    cts = (jnp.asarray(c["ct_y_new"]), jnp.asarray(c["ct_k7"]),
           *(jnp.float32(s) for s in SCALAR_CTS))
    *_, (cw1x, cw1t, cb1, cw2h, cw2t, cb2) = jmlp._normed_bwd_math(
        jnp.float32(T), jnp.float32(DT), jnp.asarray(c["y"]), jnp.asarray(c["k1"]),
        jmlp._split_params(params), cts, RTOL, ATOL)
    want = [np.concatenate([np.asarray(cw1x), np.asarray(cw1t)], 0).T,
            np.asarray(cb1).reshape(-1),
            np.concatenate([np.asarray(cw2h), np.asarray(cw2t)], 0).T,
            np.asarray(cb2).reshape(-1)]
    _, rows = _plain_backward(c, torch.float32)
    for a, b, name in zip(wc.weight_cotangents(*rows), want, ["W1", "b1", "W2", "b2"]):
        np.testing.assert_allclose(a.numpy(), b, rtol=2e-2, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("K", [0, 5, 48, 78, 384, 3072, 101_376])
@pytest.mark.parametrize("D, H", [(DIM, HIDDEN), (40, 24), (784, 100)])
def test_chunk_rule_covers_every_row_once_in_order(K, D, H):
    p = wc.plan(K, D, H)
    spans = [(c * p.chunk_rows, min(K, (c + 1) * p.chunk_rows)) for c in range(p.nchunks)]
    assert len(spans) == p.nchunks >= 1
    assert p.chunk_rows % wc.CHUNK_ALIGN == 0
    assert spans[0][0] == 0 and spans[-1][1] == K
    for (a0, a1), (b0, b1) in zip(spans, spans[1:]):
        assert a1 == b0  # consecutive, in order, no row twice
    if K:
        assert all(b > a for a, b in spans)  # no empty chunk
        assert all(b - a == p.chunk_rows for a, b in spans[:-1])
    per_chunk = sum(-(-m // 4) * 4 * (-(-n // 4) * 4) for m, n in ((D, H + 2), (H, D + 2)))
    assert p.partial_floats == p.nchunks * per_chunk
    assert p.partial_floats <= max(per_chunk, wc.MAX_PARTIAL_FLOATS)
    assert p.nchunks == 1 or p.chunk_rows >= wc.MIN_CHUNK_ROWS


def test_chunk_rule_fills_the_card_at_the_flagship():
    """At the flagship's 33 trial steps (K = 6 * 512 * 33) the two products
    are 26 tiles of 64 x 128: 20 chunks give 520 blocks, about four an SM
    of 132 and no more than reside at once; at K2's 3072 rows, 20 chunks of
    160."""
    per_chunk = 784 * 104 + 100 * 788
    assert wc.plan(6 * 512 * 33, 784, 100) == wc.Plan(5072, 20, 20 * per_chunk)
    assert wc.plan(3072, 784, 100) == wc.Plan(160, 20, 20 * per_chunk)
    assert 2 * 132 <= 20 * 26 <= wc.TARGET_BLOCKS


def _emulate_chunked(A, B, K, D, H):
    """A^T B in float32 in the kernel's order: every output summed over its
    chunk's rows in order, each step one rounding (fmaf, here a float64
    product and sum rounded once), then the chunks added in chunk order."""
    p = wc.plan(K, D, H)
    pad = p.nchunks * p.chunk_rows - K
    a = torch.cat([A, A.new_zeros(pad, A.shape[1])]).view(p.nchunks, p.chunk_rows, -1)
    b = torch.cat([B, B.new_zeros(pad, B.shape[1])]).view(p.nchunks, p.chunk_rows, -1)
    acc = torch.zeros(p.nchunks, A.shape[1], B.shape[1], dtype=torch.float32)
    for k in range(p.chunk_rows):
        prod = a[:, k, :, None].double() * b[:, k, None, :].double()
        acc = (acc.double() + prod).float()
    out = acc[0]
    for c in range(1, p.nchunks):
        out = out + acc[c]
    return out


@pytest.mark.parametrize("K", [78, 3072, 101_376])
def test_chunked_float32_order_within_plain_distance_from_float64(K):
    """The kernel's order of summation, emulated in float32, lies from the
    float64 product within 3 times the float32 ``torch.mm``'s distance
    plus 1e-7: the bound the card tests hold the kernel to. K = 78 is the
    normed backward's rows at batch 13 (one chunk); 3072 and 101,376 are
    random rows (12 and 264 chunks at this width)."""
    if K == 78:
        _, rows = _plain_backward(_case(13), torch.float32)
    else:
        rng = np.random.default_rng(K)
        rows = [torch.tensor(rng.normal(size=(K, w)).astype(np.float32))
                for w in (DIM, HIDDEN + 2, HIDDEN, DIM + 2)]
    cp2, he, cp1, ye = rows
    for A, B in ((cp2, he), (cp1, ye)):
        exact = torch.mm(A.double().t(), B.double())
        plain = torch.mm(A.t(), B).double()
        emul = _emulate_chunked(A, B, K, DIM, HIDDEN).double()
        d_plain = (plain - exact).abs().max().item()
        d_emul = (emul - exact).abs().max().item()
        assert d_emul <= 3 * d_plain + 1e-7, (d_emul, d_plain)


def test_cpu_wrapper_takes_plain_version_and_launches_nothing():
    _, rows = _plain_backward(_case(8), torch.float32)
    wc.reset_launches()
    got = wc.weight_cotangents(*rows)
    for a, b in zip(got, wc.weight_cotangents_plain(*rows)):
        assert torch.equal(a, b)
    fm.reset_launches()
    c = _case(8)
    leaves = [torch.tensor(c[k]) for k in ("W1", "b1", "W2", "b2")]
    cts = (torch.tensor(c["ct_y_new"]), torch.tensor(c["ct_k7"]),
           *(torch.tensor(s) for s in SCALAR_CTS))
    fm.normed_sweep_bwd(torch.tensor(T), torch.tensor(DT), torch.tensor(c["y"]),
                        torch.tensor(c["k1"]), leaves, cts, RTOL, ATOL)
    assert wc.LAUNCHES == {"weight_cotangents": 0}
    zero = wc.weight_cotangents(*(x[:0] for x in rows))
    assert all(torch.equal(x, torch.zeros_like(x)) for x in zero)


def test_wrapper_refuses_bad_rows():
    _, rows = _plain_backward(_case(8), torch.float32)
    cp2, he, cp1, ye = rows
    with pytest.raises(TypeError):
        wc.weight_cotangents(cp2, he.double(), cp1, ye)
    with pytest.raises(ValueError):
        wc.weight_cotangents(cp2, he[:, :-1], cp1, ye)
    with pytest.raises(ValueError):
        wc.weight_cotangents(cp2, he, cp1, ye[:-1])
    with pytest.raises(ValueError):
        wc.weight_cotangents(cp2, he, cp1, torch.empty(ye.shape[::-1]).t())
    meta = [torch.empty(x.shape, device="meta") for x in rows]
    with pytest.raises(RuntimeError, match="device meta"):
        wc.weight_cotangents(*meta)
    with pytest.raises(ValueError):
        wc.plan(-1, DIM, HIDDEN)
