"""JAX parameters -> the port's ``state_dict``.

Takes the parameter tree of the JAX package's ``ClassifierNODE`` (no
pre-net, ``MLPDynamics`` node, ``Dense`` post-net) as nested dicts of
numpy arrays and returns the ``state_dict`` of the port's
``ClassifierNODE``. Flax ``Dense`` kernels are ``(in, out)`` and become
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
