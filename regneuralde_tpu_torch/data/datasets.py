"""MNIST, file-backed when available, synthetic otherwise.

Counterpart of ``load_mnist`` in ``regneuralde_tpu/data/datasets.py``,
numpy route only: ``mnist.npz`` or the IDX files are searched in
``data_dir``, ``$REGNDE_DATA_DIR`` and ``./data``; without them a
deterministic procedural stand-in with MNIST's shapes is generated, the
same arrays as the JAX package's from the same seed.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

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
