from .loop import History, train, train_with_args
from .optim import Optimizer, get_optimizer

__all__ = ["train", "train_with_args", "History", "get_optimizer", "Optimizer"]
