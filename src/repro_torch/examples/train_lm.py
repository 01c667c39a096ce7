"""End-to-end example: train a ~100M-param transformer with SDM-DSGD.

The port of ``examples/train_lm.py``. A gemma2-family model (12 layers,
d_model=512 -> ~104M params incl. embeddings) trains for a few hundred
steps on the synthetic token stream across 4 simulated edge nodes (ring
gossip, sparsified differentials, Gaussian masking), all held on one
device as one node block and stepped by the per-node executor.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300   # full run
  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20    # quick look
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \\
      --steps 3 --layers 2 --d-model 64 --seq 32     # a small CPU run
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import gemma2_2b
from repro_torch.core.sdm_dsgd import SDMConfig
from repro_torch.core.transport import StackTransport
from repro_torch.launch.train import train
from repro_torch.train import steps as steps_mod


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch-per-node", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        gemma2_2b.config(), name="gemma2-100m",
        n_layers=args.layers, d_model=args.d_model, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=4 * args.d_model, vocab_size=32_768,
        sliding_window=128, attn_chunk_q=None)
    n_params = cfg.param_count()
    print(f"model: {cfg.name}  params={n_params / 1e6:.1f}M  "
          f"layers={cfg.n_layers} d={cfg.d_model}")

    tc = steps_mod.DistributedTrainConfig(
        model=cfg,
        sdm=SDMConfig(p=0.25, theta=0.5, gamma=0.5, sigma=0.0, clip_c=1.0),
        method="sdm-dsgd", param_dtype=torch.float32)
    transport = StackTransport(args.nodes, args.device)

    def report(t, loss, seconds):
        if t % 10 == 0 or t == args.steps - 1:
            print(f"step {t:4d} loss {loss:.4f} ({seconds:.2f}s)",
                  flush=True)

    t_start = time.time()
    run = train(tc, transport, steps=args.steps,
                global_batch=args.nodes * args.batch_per_node,
                seq_len=args.seq, seed=0, on_step=report)
    losses = run.losses
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"in {time.time() - t_start:.0f}s "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
