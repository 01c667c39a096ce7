"""Checkpoint files shared with the JAX package."""
from repro_torch.checkpoint.npz import (as_float_array, latest_step,
                                        load_flat, restore_checkpoint,
                                        save_checkpoint, tree_keys)

__all__ = ["save_checkpoint", "restore_checkpoint", "tree_keys", "load_flat",
           "latest_step", "as_float_array"]
