"""Serving: paged KV cache, continuous-batching engine, checkpoint ingest."""
from repro_torch.serving.engine import (Request, ServeStats, ServingEngine,
                                        StaticServingEngine)
from repro_torch.serving.kv_cache import TRASH_PAGE, PagedKVCache

__all__ = ["Request", "ServeStats", "ServingEngine", "StaticServingEngine",
           "PagedKVCache", "TRASH_PAGE"]
