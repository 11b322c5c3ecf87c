"""Data: the numpy minibatch loader and MNIST (numpy route only)."""

from regneuralde_tpu_torch.data.datasets import load_mnist
from regneuralde_tpu_torch.data.loader import DataLoader

__all__ = ["DataLoader", "load_mnist"]
