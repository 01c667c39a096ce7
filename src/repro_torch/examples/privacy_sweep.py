"""Privacy design-space sweep (the paper's §4.3 guidelines, executable).

The port of ``examples/privacy_sweep.py``, on the port's own copy of
``core.privacy``. Sweeps the sparsifier probability p and iteration
budget T, printing:
  * the Gaussian sigma that Corollary 2 demands for (eps, delta),
  * Theorem 4's maximum iteration budget T_max = O(m^4),
  * the 1/p^2 penalty the REVERSED (sparsify-then-randomize) design pays
    (Proposition 5) — why randomize-then-sparsify is the right order.

Host arithmetic only, so it takes no ``--device``.

  PYTHONPATH=src python -m repro_torch.examples.privacy_sweep
"""
from repro_torch.core import privacy

G, M, DELTA = 5.0, 1000, 1e-5


def main() -> None:
    print(f"setup: G={G} m={M} delta={DELTA} tau=1/m\n")
    print("Theorem 4 budget T_max (eps=1):")
    for m in (250, 500, 1000, 2000):
        t = privacy.max_iterations(G=G, m=m, p=0.2, eps=1.0, delta=DELTA)
        print(f"  m={m:5d}  T_max={t:>14,}   (m^4 scaling; prior art ~m^2={m*m:,})")

    print("\nCorollary 2 sigma for (eps=1, delta=1e-5) at m=100, T=1e6:")
    for p in (0.05, 0.1, 0.2, 0.5, 1.0):
        try:
            s = privacy.sigma_for_budget(G=G, m=100, p=p, T=1_000_000,
                                         eps=1.0, delta=DELTA)
            print(f"  p={p:4.2f}  sigma={s:8.4f}  (smaller p -> less noise needed)")
        except ValueError as e:
            print(f"  p={p:4.2f}  infeasible: {e}")

    print("\nProposition 5: eps-part penalty of the reversed design:")
    for p in (0.05, 0.1, 0.2, 0.5):
        params = privacy.PrivacyParams(G=G, m=M, tau=1.0 / M, p=p, sigma=2.0,
                                       delta=DELTA)
        sdm = privacy.epsilon_sdm(params, 1000, 0.5) - 0.25
        alt = privacy.epsilon_alternative(params, 1000, 0.5) - 0.25
        print(f"  p={p:4.2f}  eps_reversed/eps_sdm = {alt / sdm:10.1f} "
              f"(= 1/p^2 = {1 / p**2:.1f})")
    print("\nconclusion: randomize-then-sparsify (the paper's order) wins.")


if __name__ == "__main__":
    main()
