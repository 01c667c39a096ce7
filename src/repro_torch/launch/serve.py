"""Serving launcher: continuous-batching greedy decoding on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch whisper-large-v3 --dtype bfloat16 --requests 8

Runs on CUDA by default, where decode attention goes through the paged
flash-decode kernel; ``--device cpu`` runs the plain versions instead.
The audio and vlm families get the JAX launcher's stub context: every
row filled with 0.01, (max_batch, encoder_seq or n_image_tokens,
d_model), in the model's dtype.
Serve a trained decentralized checkpoint (the trainer's npz holds all n
node replicas; they are consensus-averaged into one model at load):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --smoke --checkpoint runs/ck --requests 8
"""
from __future__ import annotations

import argparse
import time

_DTYPES = ("float32", "bfloat16")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--checkpoint", default=None,
                    help="trainer checkpoint file or directory; the "
                         "stacked node replicas are consensus-averaged "
                         "into the serving model")
    ap.add_argument("--checkpoint-step", type=int, default=None)
    ap.add_argument("--engine", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--ragged", action="store_true",
                    help="vary prompt lengths in [1, prompt-len]")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=_DTYPES, default="float32")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serving import Request, ServingEngine, StaticServingEngine
    from repro_torch.serving.ingest import ingest_checkpoint

    dtype = getattr(torch, args.dtype)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.checkpoint:
        params, report = ingest_checkpoint(args.checkpoint, cfg,
                                           step=args.checkpoint_step,
                                           dtype=dtype, device=args.device)
        print(report)
    else:
        params = transformer.init_params(cfg, seed=args.seed, dtype=dtype,
                                         device=args.device)

    max_seq = args.prompt_len + args.max_new + 8
    if args.engine == "static":
        engine = StaticServingEngine(cfg, params, max_batch=args.max_batch,
                                     max_seq=max_seq, dtype=dtype,
                                     device=args.device)
    else:
        engine = ServingEngine(cfg, params, max_batch=args.max_batch,
                               max_seq=max_seq, page_size=args.page_size,
                               dtype=dtype, device=args.device)

    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests):
        plen = (int(rng.integers(1, args.prompt_len + 1)) if args.ragged
                else args.prompt_len)
        reqs.append(Request(
            prompt=rng.integers(0, cfg.vocab_size, size=plen).tolist(),
            max_new_tokens=args.max_new))

    context = transformer.stub_context(cfg, args.max_batch, dtype,
                                       engine.device)
    t0 = time.time()
    engine.serve(reqs, context=context)
    dt = time.time() - t0
    total_new = sum(len(r.output) for r in reqs)
    where = (torch.cuda.get_device_name(engine.device)
             if engine.device.type == "cuda" else "cpu")
    print(f"served {len(reqs)} requests, {total_new} tokens "
          f"in {dt:.2f}s ({total_new / dt:.1f} tok/s) on {where}")
    stats = engine.last_stats
    if stats is not None:
        print(f"  kv pages peak {stats.pages_peak} / dense-equivalent "
              f"{stats.pages_dense_equiv}; prefills {stats.prefills}, "
              f"decode steps {stats.decode_steps}")
    for i, r in enumerate(reqs[:4]):
        print(f"  req{i}: prompt[:4]={r.prompt[:4]} -> out={r.output}")


if __name__ == "__main__":
    main()
