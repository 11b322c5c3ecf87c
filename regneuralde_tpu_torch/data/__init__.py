"""Data: the numpy minibatch loader, MNIST, physionet and MiniBooNE (numpy routes only)."""

from regneuralde_tpu_torch.data.datasets import load_miniboone, load_mnist, load_physionet
from regneuralde_tpu_torch.data.loader import DataLoader

__all__ = ["DataLoader", "load_miniboone", "load_mnist", "load_physionet"]
