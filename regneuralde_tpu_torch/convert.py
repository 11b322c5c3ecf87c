"""JAX parameters -> the port's ``state_dict``.

Takes the parameter tree of one of the JAX package's models as nested
dicts of numpy arrays and returns the ``state_dict`` of the port's model:
``ClassifierNODE`` (no pre-net, ``MLPDynamics`` node, ``Dense`` post-net),
the latent ODE's ``LatentTimeSeriesModel`` (``LatentGRU``, ``MLP``,
``AlternatingMLP`` node, ``Dense`` decoder), ``FFJORD`` over
``CSLDynamics`` and ``ClassifierNSDE`` (``Dense`` pre-net, ``MLP`` drift and
diffusion, ``Dense`` post-net) and the toy SDE's ``NeuralSDE`` (``CubicDrift``
and a ``Dense`` diffusion). Flax ``Dense`` kernels are ``(in, out)`` and become
``nn.Linear`` weights ``(out, in)``; biases carry over as they are, and the
time row (last row of a flax kernel) becomes the last weight column.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _dense(p: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    kernel = np.asarray(p["kernel"], np.float32)
    return {
        f"{prefix}.weight": torch.from_numpy(np.ascontiguousarray(kernel.T)),
        f"{prefix}.bias": torch.from_numpy(np.asarray(p["bias"], np.float32).copy()),
    }


def classifier_node_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"de": {"params": {"dense_1", "dense_2"}}, "post": {"params"}}``
    -> ``state_dict`` keys ``node.dynamics.dense_{1,2}.*`` and ``post.*``."""
    if "pre" in params:
        raise NotImplementedError("a pre-net is not ported")
    de = params["de"]["params"]
    out = {}
    out.update(_dense(de["dense_1"], "node.dynamics.dense_1"))
    out.update(_dense(de["dense_2"], "node.dynamics.dense_2"))
    out.update(_dense(params["post"]["params"], "post"))
    return out


def _dense_tree(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """Every ``Dense`` under ``tree`` (a dict of flax layer names), keys
    joined with dots."""
    out = {}
    for name, sub in tree.items():
        if "kernel" in sub:
            out.update(_dense(sub, f"{prefix}.{name}"))
        else:
            out.update(_dense_tree(sub, f"{prefix}.{name}"))
    return out


def latent_ode_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"rnn", "enc", "de", "dec"}`` of the JAX ``LatentTimeSeriesModel``
    -> ``state_dict`` keys ``rnn.cell.{update_gate,reset_gate,new_state}.
    dense_i.*`` (flax's ``nn.scan`` keeps the cell's parameters under
    ``rnn/params/cell``), ``enc.dense_i.*``, ``node.dynamics.{up,down}_i.*``
    and ``dec.*``."""
    out = {}
    out.update(_dense_tree(params["rnn"]["params"], "rnn"))
    out.update(_dense_tree(params["enc"]["params"], "enc"))
    out.update(_dense_tree(params["de"]["params"], "node.dynamics"))
    out.update(_dense(params["dec"]["params"], "dec"))
    return out


def ffjord_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": {"csl1", "csl2", "csl3"}}`` of the JAX ``FFJORD`` (its
    ``CSLDynamics``, each layer's ``layer``, ``gate`` and ``bias`` Dense)
    -> ``state_dict`` keys ``dynamics.csl{1,2,3}.{layer,gate,bias}.*``; the
    time Dense layers' ``(1, out)`` kernels become ``(out, 1)`` weights."""
    out = {}
    for name in ("csl1", "csl2", "csl3"):
        layer = params["params"][name]
        prefix = f"dynamics.{name}"
        out.update(_dense(layer["layer"], f"{prefix}.layer"))
        out.update(_dense(layer["bias"], f"{prefix}.bias"))
        gate = np.asarray(layer["gate"]["kernel"], np.float32)
        out[f"{prefix}.gate.weight"] = torch.from_numpy(np.ascontiguousarray(gate.T))
    return out


def classifier_nsde_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"pre", "de": {"drift", "diffusion"}, "post"}`` of the JAX
    ``ClassifierNSDE`` (each a flax ``{"params": ...}`` tree) -> ``state_dict``
    keys ``pre.*``, ``nsde.drift.dense_i.*``, ``nsde.diffusion.dense_i.*`` and
    ``post.*``."""
    out = {}
    out.update(_dense(params["pre"]["params"], "pre"))
    for net in ("drift", "diffusion"):
        out.update(_dense_tree(params["de"][net]["params"], f"nsde.{net}"))
    out.update(_dense(params["post"]["params"], "post"))
    return out


def sde_toy_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"drift", "diffusion"}`` of the JAX ``NeuralSDE`` of
    ``experiments/sde_toy.py`` (``CubicDrift``'s flax ``Dense_0``/``Dense_1``;
    the diffusion a bare ``Dense(2)`` or one named ``Dense_0``) ->
    ``state_dict`` keys ``drift.dense_{0,1}.*`` and ``diffusion.dense_0.*``
    (the port's ``NeuralSDE(CubicDrift(), MLP(2, (2,)))``)."""
    drift = params["drift"]["params"]
    diffusion = params["diffusion"]["params"]
    out = {}
    out.update(_dense(drift["Dense_0"], "drift.dense_0"))
    out.update(_dense(drift["Dense_1"], "drift.dense_1"))
    out.update(_dense(diffusion if "kernel" in diffusion else diffusion["Dense_0"],
                      "diffusion.dense_0"))
    return out
