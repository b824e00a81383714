from .engine import FLEngine

__all__ = ["FLEngine"]
