"""Quickstart: private + communication-efficient decentralized training.

The port of ``examples/quickstart.py``. Eight simulated edge nodes on a
ring train a shared logistic-regression model with SDM-DSGD: each node
only ever transmits a Bernoulli(p)-sparsified, Gaussian-masked
differential to its two ring neighbours. Prints loss, accuracy, the
communicated element count, and the (eps, delta)-DP spend from the
Theorem-1 accountant.

  PYTHONPATH=src python -m repro_torch.examples.quickstart            # on the GPU
  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

import torch

from repro_torch import prng, tree as tree_mod
from repro_torch._device import resolve_device
from repro_torch.core import PrivacyParams, SDMConfig, sdm_dsgd, topology
from repro_torch.data import classification_dataset, node_partitioned_batches
from repro_torch.models import vision_small
from repro_torch.train.trainer import run_decentralized

N_NODES, FEATURES, CLASSES = 8, 64, 10
STEPS = 300


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    topo = topology.ring(N_NODES)
    cfg = SDMConfig(p=0.2, theta=0.25, gamma=0.05, sigma=1.0, clip_c=5.0)
    cfg.validate_against(topo)  # Lemma 1's theta bound

    (x_tr, y_tr), (x_te, y_te) = classification_dataset(
        FEATURES, CLASSES, 4000, 1000, seed=0)
    params0 = vision_small.mlr_init(prng.PRNGKey(0, device=dev), FEATURES,
                                    CLASSES)
    params = tree_mod.tree_map(
        lambda p: p[None].expand((N_NODES,) + tuple(p.shape)).clone(),
        params0)
    grad_fn = vision_small.make_stacked_grad_fn(vision_small.mlr_apply)
    eval_fn = vision_small.make_eval_fn(
        vision_small.mlr_apply, torch.as_tensor(x_te, device=dev),
        torch.as_tensor(y_te, device=dev))
    batches = node_partitioned_batches(x_tr, y_tr, N_NODES, 16, seed=0)

    m = 4000 // N_NODES
    pp = PrivacyParams(G=5.0, m=m, tau=16 / m, p=cfg.p, sigma=cfg.sigma)
    res = run_decentralized(
        topo=topo, algorithm="sdm_dsgd", sdm_cfg=cfg, params_stack=params,
        grad_fn=grad_fn, batches=batches, steps=STEPS, privacy=pp,
        eps_target=1.0, eval_fn=eval_fn, eval_every=50, log_every=50,
        device=dev)

    # compare against DSGD's cost on the SAME wire plane
    full = sum(w.shape[0] * w.shape[1]
               for w in sdm_dsgd.wire_shape_tree(params0))
    sent = sdm_dsgd.transmitted_elements_per_step(params0, cfg)
    print(f"\nfinal loss        : {res.losses[-1]:.4f}")
    print(f"test accuracy     : {res.eval_accuracy[-1]:.4f}")
    print(f"per-node traffic  : {sent}/{full} elements/iter "
          f"({100 * sent / full:.0f}% of DSGD)")
    print(f"privacy spent     : eps={res.epsilons[-1]:.3e} at delta=1e-5 "
          f"after {STEPS} steps")


if __name__ == "__main__":
    main()
