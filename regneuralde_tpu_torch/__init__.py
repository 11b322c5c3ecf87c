"""regneuralde_tpu_torch: regularized neural-ODE training steps in PyTorch and CUDA.

The port of ``regneuralde_tpu`` (JAX, XLA and Pallas for TPU) to PyTorch on
an NVIDIA H100. It mirrors that package's layout (``ops``, ``models``,
``reg``, ``training``, ``data``) and public names, and imports no JAX: the
JAX package is the reference the port's tests hold it against.

Every f32 contraction runs in IEEE f32, never TF32: the solver's embedded
error estimate is a fifth-order cancellation, and reduced-precision noise
in it inflates the step count (the TPU's bf16 default did so about 25x).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from regneuralde_tpu_torch import data, models, ops, reg, training, utils  # noqa: E402

__all__ = ["data", "models", "ops", "reg", "training", "utils"]
