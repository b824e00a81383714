from .classifier import MLP, PaperCNN, accuracy, dense_init, xent_loss

__all__ = ["MLP", "PaperCNN", "accuracy", "dense_init", "xent_loss"]
