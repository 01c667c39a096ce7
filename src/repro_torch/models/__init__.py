"""Model configuration, layers, the transformer stack and the paper's
vision models (PyTorch)."""
