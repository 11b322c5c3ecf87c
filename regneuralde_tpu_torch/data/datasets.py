"""MNIST, physionet, MiniBooNE and the toy SDE's ground truth, file-backed
when available, synthetic otherwise.

Counterpart of ``load_mnist``, ``load_physionet``, ``load_miniboone`` and
``make_sde_demo`` in ``regneuralde_tpu/data/datasets.py``, numpy route only:
the files (``mnist.npz`` or the IDX files; ``physionet.npz`` or the
reference's ``physionet.bson``; ``miniboone.npy``; ``sde_demo.bson``) are
searched in ``data_dir``, ``$REGNDE_DATA_DIR`` and ``./data``; without them a
deterministic procedural stand-in with the data's shapes is generated, the
same arrays as the JAX package's from the same seed. The BSON files are
decoded by the port's copy of the BSON.jl codec (``data/bson.py``).
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from regneuralde_tpu_torch.data.bson import load_bson
from regneuralde_tpu_torch.data.loader import DataLoader


def _search_file(name_options, data_dir: Optional[str]) -> Optional[Path]:
    roots = []
    if data_dir:
        roots.append(Path(data_dir))
    if os.environ.get("REGNDE_DATA_DIR"):
        roots.append(Path(os.environ["REGNDE_DATA_DIR"]))
    roots.append(Path("data"))
    for root in roots:
        for name in name_options:
            p = root / name
            if p.exists():
                return p
    return None


def _one_hot(labels: np.ndarray, num: int) -> np.ndarray:
    out = np.zeros((labels.shape[0], num), np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        _zero, _dtype, ndim = struct.unpack(">HBB", f.read(4))
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(shape)


def _synthetic_mnist(n_train=4096, n_test=1024, seed=0):
    """Deterministic stand-in with MNIST's shapes: each class is a distinct
    low-frequency 28x28 pattern plus pixel noise."""
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32) / 27.0
    protos = []
    for c in range(10):
        a, b = (c % 5) + 1, (c // 5) + 1
        protos.append(
            0.5 + 0.5 * np.sin(a * np.pi * xx + c) * np.cos(b * np.pi * yy - c)
        )
    protos = np.stack(protos)  # (10, 28, 28)

    def make(n, seed_off):
        r = np.random.default_rng(seed + seed_off)
        labels = r.integers(0, 10, size=n)
        imgs = protos[labels] + 0.25 * r.standard_normal((n, 28, 28)).astype(np.float32)
        return np.clip(imgs, 0, 1).astype(np.float32)[..., None], labels

    xtr, ytr = make(n_train, 1)
    xte, yte = make(n_test, 2)
    return xtr, ytr, xte, yte


def load_mnist(batch_size: int, data_dir: Optional[str] = None,
               flatten: bool = False, seed: int = 0
               ) -> Tuple[DataLoader, DataLoader]:
    """Images in [0, 1] and one-hot labels; ``(train, test)`` loaders."""
    source = "synthetic"
    npz = _search_file(["mnist.npz"], data_dir)
    if npz is not None:
        with np.load(npz) as d:
            xtr, ytr = d["x_train"], d["y_train"]
            xte, yte = d["x_test"], d["y_test"]
        xtr = (xtr.astype(np.float32) / 255.0)[..., None]
        xte = (xte.astype(np.float32) / 255.0)[..., None]
        source = str(npz)
    else:
        idx = _search_file(
            ["train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"], data_dir)
        if idx is not None:
            root = idx.parent
            sfx = ".gz" if idx.suffix == ".gz" else ""

            def rd(name):
                return _read_idx(root / (name + sfx))

            xtr = (rd("train-images-idx3-ubyte").astype(np.float32) / 255.0)[..., None]
            ytr = rd("train-labels-idx1-ubyte")
            xte = (rd("t10k-images-idx3-ubyte").astype(np.float32) / 255.0)[..., None]
            yte = rd("t10k-labels-idx1-ubyte")
            source = str(root)
        else:
            xtr, ytr, xte, yte = _synthetic_mnist(seed=seed)

    if flatten:
        xtr = xtr.reshape(xtr.shape[0], -1)
        xte = xte.reshape(xte.shape[0], -1)
    train = DataLoader((xtr, _one_hot(np.asarray(ytr), 10)), batch_size,
                       shuffle=True, seed=seed, source=source)
    test = DataLoader((xte, _one_hot(np.asarray(yte), 10)), batch_size,
                      shuffle=False, source=source)
    return train, test


def _synthetic_physionet(n=4096, feats=37, steps=49, seed=0):
    """Irregular multivariate series with observation masks, in the
    physionet bundle's schema: one shared irregular grid of ``steps``
    stamps in [0, 1] starting at 0.0, four latent oscillators lifted to
    ``feats`` channels, about 35% of the values observed.

    ``REGNDE_SURROGATE_FREQ="lo,hi"`` overrides the oscillators' frequency
    band (default 1..6), as in the JAX package."""
    rng = np.random.default_rng(seed)
    freq = os.environ.get("REGNDE_SURROGATE_FREQ", "1.0,6.0").split(",")
    f_lo, f_hi = float(freq[0]), float(freq[1])
    grid = np.sort(rng.uniform(0, 1, size=(steps,)).astype(np.float32))
    grid[0] = 0.0
    tp = np.tile(grid, (n, 1))
    z = rng.standard_normal((n, 4)).astype(np.float32)
    w = rng.uniform(f_lo, f_hi, size=(4,)).astype(np.float32)
    lift = rng.standard_normal((4, feats)).astype(np.float32) * 0.7
    phase = tp[..., None] * w  # (n, steps, 4)
    latent = np.sin(2 * np.pi * phase + z[:, None, :])
    data = np.tanh(latent @ lift).astype(np.float32)  # (n, steps, feats)
    mask = (rng.uniform(size=data.shape) < 0.35).astype(np.float32)
    data = data * mask
    return {
        "observed_data": data,
        "observed_mask": mask,
        "data_to_predict": data.copy(),
        "mask_predicted_data": mask.copy(),
        "observed_tp": tp,
        "tp_to_predict": tp.copy(),
    }


_PHYSIONET_DATA_KEYS = ("observed_data", "observed_mask", "data_to_predict",
                        "mask_predicted_data")
_PHYSIONET_TP_KEYS = ("observed_tp", "tp_to_predict")
_PHYSIONET_KEYS = _PHYSIONET_DATA_KEYS + _PHYSIONET_TP_KEYS


def physionet_bundle_from_bson(path) -> dict:
    """Decode the reference's ``physionet.bson`` (a BSON.jl blob holding a
    ``data`` dict of six Julia column-major tensors; src/dataset.jl:65-77)
    into the batch-major layout: data tensors ``(N, steps, feats)``, stamps
    ``(N, steps)``."""
    blob = load_bson(path)
    raw = blob.get("data", blob)
    missing = [k for k in _PHYSIONET_KEYS if k not in raw]
    if missing:
        raise KeyError(f"physionet bundle missing keys {missing}")
    out = {}
    for k in _PHYSIONET_DATA_KEYS:
        arr = np.asarray(raw[k], np.float32)
        if arr.ndim != 3:
            raise ValueError(f"{k}: expected (feats, steps, N), got {arr.shape}")
        out[k] = np.ascontiguousarray(arr.transpose(2, 1, 0))
    for k in _PHYSIONET_TP_KEYS:
        arr = np.asarray(raw[k], np.float32)
        if arr.ndim != 2:
            raise ValueError(f"{k}: expected (steps, N), got {arr.shape}")
        out[k] = np.ascontiguousarray(arr.T)
    return out


def load_physionet(batch_size: int, path: Optional[str] = None,
                   train_split: float = 0.8, seed: int = 0
                   ) -> Tuple[DataLoader, DataLoader]:
    """Six arrays a batch, batch-major: ``(observed_data, observed_mask,
    data_to_predict, mask_predicted_data, observed_tp, tp_to_predict)``,
    data ``(B, 49, 37)`` and stamps ``(B, 49)``. The same split, shuffles
    and dropped partial batches as the JAX package (both loaders shuffle
    and drop the last partial batch, as the reference does).

    Reads the converted ``physionet.npz`` or the reference's raw
    ``physionet.bson``."""
    found = _search_file([path] if path else ["physionet.npz", "physionet.bson"], None)
    if path and Path(path).exists():
        found = Path(path)
    if found is not None:
        if found.suffix == ".bson":
            bundle = physionet_bundle_from_bson(found)
        else:
            with np.load(found) as d:
                bundle = {k: d[k] for k in d.files}
        source = str(found)
    else:
        bundle = _synthetic_physionet(seed=seed)
        source = "synthetic"

    n = bundle["observed_data"].shape[0]
    idx = np.random.default_rng(seed).permutation(n)
    n_train = int(n * train_split)
    train = DataLoader([bundle[k][idx[:n_train]] for k in _PHYSIONET_KEYS],
                       batch_size, shuffle=True, drop_last=True, seed=seed,
                       source=source)
    test = DataLoader([bundle[k][idx[n_train:]] for k in _PHYSIONET_KEYS],
                      batch_size, shuffle=True, drop_last=True, seed=seed + 1,
                      source=source)
    return train, test


def load_miniboone(batch_size: int, path: Optional[str] = None,
                   train_split: float = 0.8, seed: int = 0
                   ) -> Tuple[DataLoader, DataLoader]:
    """MiniBooNE's 43 features, standardized per feature; ``(train, test)``
    loaders of ``x`` batches (the train loader shuffles). Reads
    ``miniboone.npy`` in either orientation (a feature-major file is
    transposed); without it a surrogate of 8192 rows around four centers,
    the same arrays as the JAX package's from the same seed. Reference:
    src/dataset.jl:33-56."""
    found = Path(path) if path and Path(path).exists() else _search_file(
        ["miniboone.npy"], None)
    if found is not None:
        data = np.load(found).astype(np.float32)
        if data.shape[0] == 43 and data.shape[1] != 43:
            data = data.T  # feature-major file -> sample-major
        source = str(found)
    else:
        rng = np.random.default_rng(seed)
        n = 8192
        centers = rng.standard_normal((4, 43)).astype(np.float32) * 2.0
        assign = rng.integers(0, 4, size=n)
        data = centers[assign] + rng.standard_normal((n, 43)).astype(np.float32)
        source = "synthetic"

    data = (data - data.mean(0, keepdims=True)) / (data.std(0, keepdims=True) + 1e-8)
    idx = np.random.default_rng(seed).permutation(data.shape[0])
    n_train = int(data.shape[0] * train_split)
    train = DataLoader((data[idx[:n_train]],), batch_size, shuffle=True, seed=seed,
                       source=source)
    test = DataLoader((data[idx[n_train:]],), batch_size, shuffle=False, source=source)
    return train, test


def make_sde_demo(seed: int = 0, datasize: int = 30):
    """The toy SDE experiment's ground truth: per-timestep means and
    variances ``(datasize, 2)``, the stamps and the source (reference:
    experiments/sde_toy_problem.jl:8-15).

    A findable ``sde_demo.bson`` (the reference's blob) is decoded and its
    truth returned when ``datasize`` is 30; ``seed`` is then unused.
    Otherwise the truth is regenerated: du = f(u) dt + g(u) dW for a damped
    cubic drift over 512 trajectories, Euler-Maruyama at dt = 1/300, the
    same arrays as the JAX package's from the same seed. ``source`` says
    which path was taken (``"bson:<file>"`` or ``"synthetic"``)."""
    found = _search_file(["sde_demo.bson"], None)
    if found is not None and datasize == 30:
        blob = load_bson(found)
        if "sde_data" in blob and "sde_data_vars" in blob:
            means = np.asarray(blob["sde_data"], np.float32).T  # (30, 2)
            vars_ = np.asarray(blob["sde_data_vars"], np.float32).T
            tsteps = np.linspace(0.0, 1.0, means.shape[0]).astype(np.float32)
            return means, vars_, tsteps, f"bson:{found}"
    rng = np.random.default_rng(seed)
    tsteps = np.linspace(0.0, 1.0, datasize).astype(np.float32)
    ntraj = 512
    u = np.tile(np.array([[2.0, 0.0]], np.float32), (ntraj, 1))
    true_A = np.array([[-0.1, 2.0], [-2.0, -0.1]], np.float32)
    dt = 1.0 / 300.0
    out_means, out_vars = [], []
    t = 0.0
    ti = 0
    for _ in range(301):
        while ti < datasize and tsteps[ti] <= t + 1e-9:
            out_means.append(u.mean(0))
            out_vars.append(u.var(0))
            ti += 1
        drift = (u**3) @ true_A.T
        diff_ = 0.2 * u
        u = u + dt * drift + np.sqrt(dt) * diff_ * rng.standard_normal(u.shape).astype(np.float32)
        t += dt
    while ti < datasize:
        out_means.append(u.mean(0))
        out_vars.append(u.var(0))
        ti += 1
    return (np.stack(out_means).astype(np.float32), np.stack(out_vars).astype(np.float32),
            tsteps, "synthetic")
