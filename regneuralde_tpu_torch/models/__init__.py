"""Models: the dynamics, NeuralODE, ClassifierNODE and the latent ODE."""

from regneuralde_tpu_torch.models.basic import MLP, AlternatingMLP, LatentGRU, MLPDynamics
from regneuralde_tpu_torch.models.classifiers import ClassifierNODE, ClassifierNODEOutput
from regneuralde_tpu_torch.models.neural_ode import NeuralDEOutput, NeuralODE
from regneuralde_tpu_torch.models.time_series import (
    LatentTimeSeriesModel,
    LatentTimeSeriesOutput,
)

__all__ = ["MLP", "AlternatingMLP", "ClassifierNODE", "ClassifierNODEOutput",
           "LatentGRU", "LatentTimeSeriesModel", "LatentTimeSeriesOutput",
           "MLPDynamics", "NeuralDEOutput", "NeuralODE"]
