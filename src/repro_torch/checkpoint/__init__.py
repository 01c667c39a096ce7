"""Checkpoint files shared with the JAX package (numpy only)."""
from repro_torch.checkpoint.npz import (as_float_array, latest_step,
                                        load_flat, save_checkpoint)

__all__ = ["save_checkpoint", "load_flat", "latest_step", "as_float_array"]
