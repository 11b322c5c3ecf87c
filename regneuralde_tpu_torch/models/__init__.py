"""Models: MLPDynamics, NeuralODE and ClassifierNODE."""

from regneuralde_tpu_torch.models.basic import MLPDynamics
from regneuralde_tpu_torch.models.classifiers import ClassifierNODE, ClassifierNODEOutput
from regneuralde_tpu_torch.models.neural_ode import NeuralDEOutput, NeuralODE

__all__ = ["ClassifierNODE", "ClassifierNODEOutput", "MLPDynamics",
           "NeuralDEOutput", "NeuralODE"]
