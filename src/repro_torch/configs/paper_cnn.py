"""The DPFL paper's own model: 3-conv + 2-fc CNN for CIFAR10-like inputs
(paper Appendix F.3.2), used by the federated-learning experiments."""
from dataclasses import dataclass


@dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn"
    in_channels: int = 3
    image_size: int = 32
    n_classes: int = 10
    c1: int = 6
    c2: int = 16
    fc1: int = 120
    fc2: int = 84


CONFIG = CNNConfig()
