"""PyTorch / CUDA port of the DPFL system for NVIDIA Hopper (H100).

Mirrors `repro`'s module layout (``repro_torch.core.dpfl`` is the
counterpart of ``repro.core.dpfl`` and so on) and keeps its flat (N, P)
parameter layout, so rows carry between the two packages unchanged
(`repro_torch.interop`). Imports ``torch`` and numpy only; entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
