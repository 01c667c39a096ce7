"""RDP-based differential-privacy accountant for SDM-DSGD.

Implements, as executable functions, exactly the quantities the paper
proves:

* Lemma 2 (subsampled Gaussian RDP, from Wang-Balle-Kasiviswanathan):
  per-step `(alpha, 4*alpha*(tau*G / (m*sigma))^2)`-RDP; the sparsifier
  multiplies the *expected* RDP order by p (Theorem 1), because only the
  active coordinates `C_{1,t}` (a Binomial(d, p) subset) are released.
* Theorem 1: T-step composition is
  `(4*alpha*p*T*(tau*G/(m*sigma))^2 + eps/2, delta)`-DP in expectation
  with `alpha = 2*log(1/delta)/eps + 1`.
* Corollary 2: the noise level needed for a target (eps, delta):
  `sigma^2 = 8*p*T*G^2*(2*log(1/delta) + eps) / (m^4 * eps^2)`,
  valid while `sigma^2 >= 1/1.25` and `eps <= 10*p*T*G^2/m^4`.
* Theorem 4: the training-privacy trade-off
  `T_max = m^4 * eps^2 / (20 * G^2 * log(1/delta) * p) = O(m^4)` —
  two orders of magnitude better than the O(m^2) prior art.
* Proposition 5: the reversed design ("sparsify-then-randomize") pays a
  `1/p^2` factor in the eps-part — the co-design insight of §4.3.

The accountant is pure Python/NumPy (it runs on the host, once per run,
and is consumed by the training loop for online budget tracking).

The port's own copy of ``repro/core/privacy.py`` (numpy/math only): importing it
from the JAX package would run ``repro/core/__init__.py``, which
imports jax. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "PrivacyParams",
    "SIGMA_SQ_MIN",
    "rdp_alpha",
    "per_step_rdp",
    "epsilon_sdm",
    "epsilon_alternative",
    "sigma_sq_for_epsilon",
    "sigma_for_budget",
    "max_iterations",
    "PrivacyAccountant",
]

# Lower bound sigma^2 >= 1/1.25 required for the subsampled-RDP
# amplification (Theorem 1 / Remark 2, following Wang et al. 2018).
SIGMA_SQ_MIN = 1.0 / 1.25


@dataclasses.dataclass(frozen=True)
class PrivacyParams:
    """Static privacy configuration of a run.

    Attributes:
      G: l2-sensitivity bound of a single-example gradient (Assumption 1(4)
         gives coordinate-wise G/sqrt(d), hence ||grad|| <= G).
      m: local dataset size per node.
      tau: subsampling rate (batch fraction); the paper's headline results
         use tau = 1/m (one sample per step).
      p: sparsifier transmit probability — a scalar, or a per-node tuple
         for heterogeneous sparsity budgets. Theorem 1's per-step RDP is
         linear in p, so with per-node budgets the accountant charges
         every node the WORST-CASE (max-p) node's leakage: the reported
         epsilon upper-bounds each node's true spend.
      sigma: Gaussian masking noise std-dev (per coordinate).
      delta: target delta.
      participation_q: per-round node participation fraction. With
         partial participation (the edge-fleet simulator samples an
         active subgraph of expected size q*n per round) a node's data
         enters a release only in rounds it participates in, and the
         participation sampling composes with the paper's data
         subsampling: the effective subsampled-Gaussian rate is q*tau,
         so the per-step RDP picks up a q^2 amplification factor
         (Wang-Balle-Kasiviswanathan, same lemma that gives the tau^2).
         q = 1 (default) is full participation and changes nothing.
    """

    G: float
    m: int
    tau: float
    p: "float | tuple"
    sigma: float
    delta: float = 1e-5
    participation_q: float = 1.0

    def __post_init__(self) -> None:
        if isinstance(self.p, (list, tuple)):
            object.__setattr__(self, "p", tuple(float(v) for v in self.p))
            if not self.p:
                raise ValueError("per-node p must be non-empty")
            if any(not (0.0 < v <= 1.0) for v in self.p):
                raise ValueError("every per-node p must be in (0, 1]")
        elif not (0.0 < self.p <= 1.0):
            raise ValueError("p must be in (0, 1]")
        if not (0.0 < self.tau <= 1.0):
            raise ValueError("tau must be in (0, 1]")
        if not (0.0 < self.participation_q <= 1.0):
            raise ValueError(
                f"participation_q must be in (0, 1], got {self.participation_q!r}: "
                "q is a sampling fraction — q=0 means no node ever "
                "participates (nothing is released, but nothing trains "
                "either) and q>1 is not a probability")
        if not self.sigma > 0.0:
            raise ValueError(
                f"sigma must be > 0, got {self.sigma!r}: the accountant's "
                "per-step RDP is (tau*G/(m*sigma))^2 — sigma=0 claims no "
                "privacy and every downstream epsilon would be inf/NaN")
        if not (0.0 < self.delta < 1.0):
            raise ValueError("delta must be in (0, 1)")
        if not self.G > 0.0:
            raise ValueError(f"G (sensitivity bound) must be > 0, got {self.G!r}")
        if self.m < 1:
            raise ValueError(f"m (local dataset size) must be >= 1, got {self.m!r}")

    @classmethod
    def from_compressor(cls, comp, *, G: float, m: int, tau: float,
                        sigma: float, delta: float = 1e-5,
                        participation_q: float = 1.0
                        ) -> "PrivacyParams":
        """Accountant parameters with the release probability READ OFF
        the compressor (``repro_torch.core.compressor``).

        Sparsifying compressors release each coordinate w.p. p — the
        factor Theorem 1 multiplies into the per-step RDP; quantizers
        (qsgd) release every coordinate (``release_probability == 1``),
        so quantization buys wire bits but no subsampling amplification.
        Per-node tuples pass through: the accountant charges the
        worst-case (max-p) node as always.
        """
        return cls(G=G, m=m, tau=tau, p=comp.release_probability,
                   sigma=sigma, delta=delta, participation_q=participation_q)

    @property
    def p_worst(self) -> float:
        """The accountant's p: the max-p node dominates the RDP spend."""
        return max(self.p) if isinstance(self.p, tuple) else self.p

    @property
    def p_sparsest(self) -> float:
        """min-p node: dominates the REVERSED design's 1/p leakage."""
        return min(self.p) if isinstance(self.p, tuple) else self.p


def _check_eps_target(eps: float) -> None:
    if not eps > 0.0:
        raise ValueError(
            f"eps_target must be > 0, got {eps!r}: Theorem 1's Rényi order "
            "alpha = 2*log(1/delta)/eps + 1 diverges at eps=0")


def rdp_alpha(eps: float, delta: float) -> float:
    """Theorem 1's Rényi order: alpha = 2 log(1/delta)/eps + 1."""
    _check_eps_target(eps)
    if not (0.0 < delta < 1.0):
        raise ValueError("delta must be in (0, 1)")
    return 2.0 * math.log(1.0 / delta) / eps + 1.0


def _theorem1_K(alpha: float, *, G: float, m: int, tau: float, p: float,
                participation_q: float = 1.0) -> float:
    """Theorem 1's per-step RDP with sigma^2 factored out.

    K(alpha) = 4 * alpha * p * (q * tau * G / m)^2, so a step is
    K/sigma^2-RDP at order alpha. This single coefficient is the ONLY
    place the sigma <-> epsilon trade-off lives: ``per_step_rdp`` (and
    hence ``epsilon_sdm``) divides it by sigma^2, and
    ``sigma_sq_for_epsilon`` inverts it — so the forward accountant and
    Corollary 2's calibration can never drift apart.
    """
    return 4.0 * alpha * p * (participation_q * tau * G / m) ** 2


def per_step_rdp(params: PrivacyParams, alpha: float) -> float:
    """Expected per-step RDP of the released S(d_t) (Theorem 1 proof).

    rho_t = 4 * alpha * p * (q * tau * G / (m * sigma))^2, with p the
    worst-case (max) node budget when p is per-node and q the per-round
    participation fraction: partial participation composes with the
    data subsampling into an effective subsampled-Gaussian rate q*tau,
    so q < 1 amplifies privacy quadratically (subsampled RDP, same
    Wang-Balle-Kasiviswanathan lemma as the tau^2 factor). q = 1
    recovers Theorem 1 verbatim.
    Requires sigma^2 >= 1/1.25 for the subsampling amplification.
    """
    return _theorem1_K(
        alpha, G=params.G, m=params.m, tau=params.tau, p=params.p_worst,
        participation_q=params.participation_q) / params.sigma ** 2


def epsilon_sdm(params: PrivacyParams, T: int, eps_target: float) -> float:
    """Theorem 1: total epsilon after T iterations of SDM-DSGD.

    eps_total = 4*alpha*p*T*(tau*G/(m*sigma))^2 + eps_target/2, with
    alpha = 2*log(1/delta)/eps_target + 1. Returns +inf when the
    sigma^2 >= 1/1.25 precondition fails.
    """
    if params.sigma ** 2 < SIGMA_SQ_MIN:
        return math.inf
    alpha = rdp_alpha(eps_target, params.delta)
    return T * per_step_rdp(params, alpha) + eps_target / 2.0


def epsilon_alternative(params: PrivacyParams, T: int, eps_target: float) -> float:
    """Proposition 5: epsilon of the reversed sparsify-then-randomize design.

    eps_alt = 4*alpha*T*(tau*G)^2 / (m^2 * sigma^2 * p) + eps_target/2.
    The eps-part exceeds Theorem 1's by exactly 1/p^2 — the paper's
    co-design argument for randomize-then-sparsify. Leakage here scales
    as 1/p, so with per-node budgets the SPARSEST (min-p) node is the
    worst case.
    """
    if params.sigma ** 2 < SIGMA_SQ_MIN:
        return math.inf
    alpha = rdp_alpha(eps_target, params.delta)
    rho = 4.0 * alpha * (params.tau * params.G) ** 2 / (
        params.m ** 2 * params.sigma ** 2 * params.p_sparsest)
    return T * rho + eps_target / 2.0


def sigma_sq_for_epsilon(*, G: float, m: int, tau: float, p: float, T: int,
                         eps: float, delta: float,
                         participation_q: float = 1.0) -> float:
    """Exact inversion of Theorem 1 for sigma^2 at a total budget eps.

    Theorem 1 reads eps_total = T*K(alpha)/sigma^2 + eps/2 with
    alpha = rdp_alpha(eps, delta); solving eps_total = eps gives
    sigma^2 = 2*T*K(alpha)/eps. Because this uses the SAME
    ``_theorem1_K`` the forward accountant divides by sigma^2, feeding
    the returned sigma back through ``epsilon_sdm`` reproduces eps
    identically (up to float round-off) — the round-trip
    ``tests/test_core_privacy.py`` asserts.
    """
    _check_eps_target(eps)
    alpha = rdp_alpha(eps, delta)
    return 2.0 * T * _theorem1_K(
        alpha, G=G, m=m, tau=tau, p=p, participation_q=participation_q) / eps


def sigma_for_budget(G: float, m: int, p: float, T: int, eps: float,
                     delta: float = 1e-5, clamp: bool = False) -> float:
    """Corollary 2: sigma so that T iterations are (eps, delta)-DP.

    sigma^2 = 8*p*T*G^2*(2 log(1/delta) + eps) / (m^4 * eps^2), using the
    paper's headline subsampling rate tau = 1/m — the closed form is
    exactly ``sigma_sq_for_epsilon`` at tau = 1/m, which is how it is
    computed here. Raises if the resulting sigma^2 violates the 1/1.25
    amplification precondition, which the paper guarantees whenever
    eps <= 10*p*T*G^2/m^4.

    With ``clamp=True`` (for budgets with T below Theorem 4's T_max) the
    returned sigma is floored at sqrt(1/1.25): strictly MORE noise than
    Corollary 2 asks, so the run is at least (eps, delta)-DP and the
    amplification lemma stays valid.
    """
    _check_eps_target(eps)
    if not (0.0 < p <= 1.0):
        raise ValueError(f"p must be in (0, 1], got {p!r}")
    if not G > 0.0:
        raise ValueError(f"G must be > 0, got {G!r}")
    if T < 1:
        raise ValueError(f"T must be >= 1, got {T!r}")
    sigma_sq = sigma_sq_for_epsilon(G=G, m=m, tau=1.0 / m, p=p, T=T,
                                    eps=eps, delta=delta)
    if sigma_sq < SIGMA_SQ_MIN:
        if clamp:
            return math.sqrt(SIGMA_SQ_MIN)
        raise ValueError(
            f"Corollary 2 precondition violated: sigma^2={sigma_sq:.4g} < 1/1.25. "
            "Increase T or decrease eps (need eps <~ 10*p*T*G^2/m^4 = "
            f"{10.0 * p * T * G**2 / m**4:.4g}).")
    return math.sqrt(sigma_sq)


def max_iterations(G: float, m: int, p: float, eps: float,
                   delta: float = 1e-5) -> int:
    """Theorem 4: T = m^4 eps^2 / (20 G^2 log(1/delta) p) = O(m^4).

    The maximum iteration count under a fixed (eps, delta) budget. The
    state of the art prior to this paper scaled as O(m^2) (Remark 5).
    """
    _check_eps_target(eps)
    if not (0.0 < p <= 1.0):
        raise ValueError(f"p must be in (0, 1], got {p!r}")
    return max(1, int(m ** 4 * eps ** 2 / (20.0 * G ** 2 * math.log(1.0 / delta) * p)))


def convergence_at_budget(G: float, m: int, n: int, p: float, eps: float,
                          delta: float = 1e-5) -> float:
    """Theorem 4's rate: min_t ||grad f||^2 = O(sqrt(20 G^2 log(1/delta) p) / (sqrt(n) m^2 eps))."""
    return math.sqrt(20.0 * G ** 2 * math.log(1.0 / delta) * p) / (
        math.sqrt(n) * m ** 2 * eps)


class PrivacyAccountant:
    """Online tracker: accumulates per-step RDP and reports (eps, delta)-DP.

    Mirrors the paper's "we keep track of the privacy loss based on
    Theorem 1" experimental procedure (§5).
    """

    def __init__(self, params: PrivacyParams, eps_target: float):
        self.params = params
        self.eps_target = eps_target
        self.alpha = rdp_alpha(eps_target, params.delta)
        self._rho = 0.0
        self.steps = 0

    def step(self, n_steps: int = 1) -> None:
        self._rho += n_steps * per_step_rdp(self.params, self.alpha)
        self.steps += n_steps

    @property
    def rdp(self) -> float:
        return self._rho

    @property
    def epsilon(self) -> float:
        """Lemma 4 conversion: eps = rho + log(1/delta)/(alpha - 1)."""
        if self.params.sigma ** 2 < SIGMA_SQ_MIN:
            return math.inf
        return self._rho + math.log(1.0 / self.params.delta) / (self.alpha - 1.0)

    def exhausted(self, eps_budget: float) -> bool:
        return self.epsilon >= eps_budget
