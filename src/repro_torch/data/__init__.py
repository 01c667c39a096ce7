"""Synthetic data (the port's copy of ``repro.data``, numpy only)."""
from repro_torch.data.synthetic import (TokenStream, classification_dataset,
                                        node_partitioned_batches)

__all__ = ["TokenStream", "classification_dataset",
           "node_partitioned_batches"]
