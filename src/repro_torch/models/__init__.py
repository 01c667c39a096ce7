"""Model configuration, layers and the transformer stack (PyTorch)."""
