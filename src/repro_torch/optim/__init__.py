from .optimizers import Optimizer, sgd

__all__ = ["Optimizer", "sgd"]
