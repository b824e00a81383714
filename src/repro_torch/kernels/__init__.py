"""The port's hand-written CUDA kernels (``csrc/``), their ctypes
wrappers, their plain PyTorch versions (`ref`) and the device dispatch
(`ops`). Nothing here builds or loads a kernel at import time."""
