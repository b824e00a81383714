from .ckpt import CheckpointManager, load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree", "CheckpointManager"]
