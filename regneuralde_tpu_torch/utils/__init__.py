"""Metrics (counterpart of ``regneuralde_tpu/utils``; ``loglikelihood`` only)."""

from regneuralde_tpu_torch.utils.metrics import loglikelihood

__all__ = ["loglikelihood"]
