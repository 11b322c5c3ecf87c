"""Models: the dynamics, NeuralODE, ClassifierNODE, the latent ODE, FFJORD,
NeuralSDE (with the toy SDE's CubicDrift) and ClassifierNSDE."""

from regneuralde_tpu_torch.models.basic import (
    MLP,
    AlternatingMLP,
    ConcatSquashLinear,
    CSLDynamics,
    LatentGRU,
    MLPDynamics,
)
from regneuralde_tpu_torch.models.classifiers import (
    ClassifierNODE,
    ClassifierNODEOutput,
    ClassifierNSDE,
    ClassifierNSDEOutput,
)
from regneuralde_tpu_torch.models.ffjord import FFJORD, FFJORDOutput
from regneuralde_tpu_torch.models.neural_ode import NeuralDEOutput, NeuralODE
from regneuralde_tpu_torch.models.neural_sde import CubicDrift, NeuralSDE, NeuralSDEOutput
from regneuralde_tpu_torch.models.time_series import (
    LatentTimeSeriesModel,
    LatentTimeSeriesOutput,
)

__all__ = ["MLP", "AlternatingMLP", "ClassifierNODE", "ClassifierNODEOutput", "ClassifierNSDE",
           "ClassifierNSDEOutput",
           "ConcatSquashLinear", "CubicDrift", "CSLDynamics", "FFJORD", "FFJORDOutput", "LatentGRU",
           "LatentTimeSeriesModel", "LatentTimeSeriesOutput", "MLPDynamics",
           "NeuralDEOutput", "NeuralODE", "NeuralSDE", "NeuralSDEOutput"]
