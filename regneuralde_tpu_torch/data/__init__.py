"""Data: the numpy minibatch loader, MNIST, physionet, MiniBooNE and the toy
SDE's ground truth (numpy routes only), and the BSON.jl codec."""

from regneuralde_tpu_torch.data.datasets import (
    load_miniboone,
    load_mnist,
    load_physionet,
    make_sde_demo,
    physionet_bundle_from_bson,
)
from regneuralde_tpu_torch.data.loader import DataLoader

__all__ = ["DataLoader", "load_miniboone", "load_mnist", "load_physionet", "make_sde_demo",
           "physionet_bundle_from_bson"]
