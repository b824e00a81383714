from .paper_cnn import CONFIG, CNNConfig

__all__ = ["CNNConfig", "CONFIG"]
