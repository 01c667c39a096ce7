"""Theory benchmarks: Theorem 4's O(m^4) budget scaling (2 orders above the
O(m^2) prior art), Proposition 5's 1/p^2 gap for the reversed design, and
Lemma 1's four-term bound evaluated on the experimental topology.

Port of ``benchmarks/theory_tradeoff.py``: the same ``name,us,derived``
line from the port's own copies of ``privacy``, ``theory`` and
``topology`` (host arithmetic; no tensor work).

  PYTHONPATH=src python -m repro_torch.bench.theory_tradeoff --device cpu
"""
from __future__ import annotations

from repro_torch._device import resolve_device
from repro_torch.bench import common
from repro_torch.core import privacy, theory, topology

__all__ = ["run"]


def run(device="cuda", check: bool = True) -> common.PaperRun:
    """``data`` is Lemma 1's terms (what the JAX script returns); claims:
    T_max(m) grows as m^4, the reversed design pays exactly 1/p^2, and
    Corollary 3's rate decreases in T. ``device`` is validated only:
    everything here is host arithmetic."""
    resolve_device(device)
    topo = topology.erdos_renyi(50, 0.35, seed=0)

    # Theorem 4: T_max(m) ~ m^4.
    ms = [100, 200, 400, 800]
    ts = [privacy.max_iterations(G=5.0, m=m, p=0.2, eps=1.0) for m in ms]
    ratios = [ts[i + 1] / ts[i] for i in range(len(ts) - 1)]

    # Proposition 5: reversed design pays 1/p^2.
    gaps, gap_exact = [], []
    for p in (0.1, 0.2, 0.5):
        params = privacy.PrivacyParams(G=5.0, m=500, tau=1 / 500, p=p,
                                       sigma=2.0)
        sdm = privacy.epsilon_sdm(params, 1000, 0.5) - 0.25
        alt = privacy.epsilon_alternative(params, 1000, 0.5) - 0.25
        gaps.append(alt / sdm)
        gap_exact.append(abs(alt / sdm - 1.0 / p ** 2) < 1e-6)

    # Lemma 1 terms at the experimental operating point.
    x = theory.BoundInputs(
        n=50, m=200, d=7850, p=0.2,
        theta=min(0.55, 0.9 * theory.theta_upper_bound(
            0.2, topo.lambda_n, 0.05, 1.0)),
        gamma=0.05, beta=topo.beta, lambda_n=topo.lambda_n, sigma=1.0)
    terms = theory.lemma1_terms(x, T=10_000)
    dominant = max(terms, key=terms.get)

    # Corollary 3's rate decreases in T.
    r1 = theory.corollary3_rate(50, 10_000)
    r2 = theory.corollary3_rate(50, 100_000)

    derived = (f"m4_ratios={[round(r, 2) for r in ratios]};"
               f"p2_gaps={[round(g, 1) for g in gaps]};"
               f"lemma1_dominant={dominant};"
               "terms=" + ",".join(f"{k}:{v:.3e}" for k, v in terms.items()))
    common.emit("theory_tradeoff", 0.0, derived)
    claims = {"m4_ratios_16": all(abs(r - 16.0) < 0.5 for r in ratios),
              "p2_gap_exact": all(gap_exact),
              "corollary3_decreasing": r2 < r1}
    return common.settle(common.PaperRun(data=terms, derived=derived,
                                         claims=claims), check)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(device=ap.parse_args().device)
