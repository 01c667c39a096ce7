"""Figure 2: DC-DSGD diverges at p=0.2 (theta=1) while SDM-DSGD converges
with theta chosen inside Lemma 1's bound. Also verifies the paper's ER
consensus matrix gives lambda_n = 1/3 (so the theta bound is 2p/(2/3+gL)).

Port of ``benchmarks/fig2_divergence.py`` on the port's
``run_decentralized``, the 50-node ER(0.35) MLR test bed on ``device``.

  PYTHONPATH=src python -m repro_torch.bench.fig2_divergence      # the card
  PYTHONPATH=src python -m repro_torch.bench.fig2_divergence --device cpu
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench import common
from repro_torch.core import baselines, sdm_dsgd, theory
from repro_torch.train.trainer import run_decentralized

__all__ = ["run"]


def run(steps: int = 250, gamma: float = 0.05, device="cuda",
        check: bool = True) -> common.PaperRun:
    """``data`` holds both loss curves (what the JAX script returns);
    claims: p = 0.2 lies below DC-DSGD's validity threshold, DC-DSGD
    diverges and SDM-DSGD converges."""
    topo, params, grad_fn, eval_fn, batches, m = common.make_mlr_testbed(
        device=device)
    results = {}

    # DC-DSGD: theta = 1 at p = 0.2 — below Remark 1's validity threshold.
    min_p = theory.dcdsgd_min_p(topo.lambda_n)
    if check:
        assert 0.2 < min_p, (0.2, min_p)
    dc = baselines.dcdsgd_config(p=0.2, gamma=gamma)
    res_dc = run_decentralized(topo=topo, algorithm="dc-dsgd", sdm_cfg=dc,
                               params_stack=params, grad_fn=grad_fn,
                               batches=batches, steps=steps, device=device)
    results["dc_dsgd_p0.2"] = res_dc.losses

    # SDM-DSGD: theta=0.55 < 2p/(1 - lambda_n + gamma L) ~= 0.6.
    bound = theory.theta_upper_bound(0.2, topo.lambda_n, gamma, 1.0)
    sdm = sdm_dsgd.SDMConfig(p=0.2, theta=min(0.55, 0.9 * bound), gamma=gamma)
    sdm.validate_against(topo)
    res_sdm = run_decentralized(topo=topo, algorithm="sdm-dsgd", sdm_cfg=sdm,
                                params_stack=params, grad_fn=grad_fn,
                                batches=batches, steps=steps, device=device)
    results["sdm_dsgd_p0.2"] = res_sdm.losses

    dc_final = res_dc.losses[-1]
    sdm_final = res_sdm.losses[-1]
    dc_diverged = (not np.isfinite(dc_final)) or dc_final > 2 * res_dc.losses[0]
    sdm_converged = np.isfinite(sdm_final) and sdm_final < 0.8 * res_sdm.losses[0]
    derived = (f"lambda_n={topo.lambda_n:.3f};theta_bound={bound:.3f};"
               f"dc_final={dc_final:.3e};sdm_final={sdm_final:.4f};"
               f"dc_diverged={dc_diverged};sdm_converged={sdm_converged}")
    common.emit("fig2_divergence", res_sdm.wall_s * 1e6 / steps, derived)
    claims = {"p_below_dc_min_p": 0.2 < min_p,
              "dc_diverged": bool(dc_diverged),
              "sdm_converged": bool(sdm_converged)}
    return common.settle(common.PaperRun(
        data=results, derived=derived, claims=claims,
        details={"step_s": {"dc_dsgd_p0.2": res_dc.step_s,
                            "sdm_dsgd_p0.2": res_sdm.step_s}}), check)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    run(steps=args.steps, device=args.device)
