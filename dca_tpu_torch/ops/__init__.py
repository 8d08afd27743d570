from .activations import ACTIVATIONS, DispAct, MeanAct, get_activation
from .initializers import get_initializer

__all__ = [
    "MeanAct",
    "DispAct",
    "get_activation",
    "ACTIVATIONS",
    "get_initializer",
]
