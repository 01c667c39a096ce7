"""Serving example: continuous batching against a small decoder LM.

The port of ``examples/serve_lm.py``. Builds a reduced chatglm3-family
model (seeded weights) and serves a ragged mix of requests (different
prompt lengths and token budgets) through the continuous-batching
engine: requests stream through 4 slots backed by a paged KV cache -- a
finished request frees its pages and the next queued request is
prefilled into the vacated slot mid-flight.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm            # on the GPU
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.models import transformer
from repro_torch.serving import Request, ServingEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config("chatglm3-6b")
    params = transformer.init_params(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, params, max_batch=4, max_seq=96,
                           page_size=8, device=args.device)

    rng = np.random.default_rng(0)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab_size, size=n).tolist(),
                max_new_tokens=m)
        for n, m in [(8, 12), (5, 6), (11, 16), (8, 4), (16, 8), (3, 8),
                     (9, 2), (16, 8)]
    ]
    t0 = time.time()
    engine.serve(requests)
    dt = time.time() - t0
    tokens = sum(len(r.output) for r in requests)
    stats = engine.last_stats
    print(f"served {len(requests)} requests / {tokens} new tokens "
          f"in {dt:.2f}s")
    print(f"kv pages: peak {stats.pages_peak} vs dense-equivalent "
          f"{stats.pages_dense_equiv}")
    for i, r in enumerate(requests):
        print(f"  req{i}: len(prompt)={len(r.prompt):2d} "
              f"budget={r.max_new_tokens:2d} ttft={r.ttft_s:.3f}s "
              f"-> {r.output}")
    assert all(len(r.output) <= r.max_new_tokens for r in requests)
    assert all(len(r.output) > 0 for r in requests)
    print("all requests satisfied within their budgets")


if __name__ == "__main__":
    main()
