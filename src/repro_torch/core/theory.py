"""Executable convergence theory of SDM-DSGD (Lemma 1, Corollary 3, Remark 1).

These calculators back the theory benchmarks: they evaluate the paper's
convergence bound terms for concrete (n, p, theta, gamma, beta,
lambda_n, ...) choices so the experiments can check parameter validity
(theta bound, DC-DSGD p-threshold) and plot predicted-vs-measured error.

The port's own copy of ``repro/core/theory.py`` (numpy/math only): importing it
from the JAX package would run ``repro/core/__init__.py``, which
imports jax. Keep the two in step.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = [
    "BoundInputs",
    "theta_upper_bound",
    "default_theta",
    "default_gamma",
    "dcdsgd_min_p",
    "lemma1_terms",
    "lemma1_bound",
    "corollary3_rate",
    "min_iterations_for_rate",
]


@dataclasses.dataclass(frozen=True)
class BoundInputs:
    """Everything Lemma 1 needs.

    Attributes:
      n: number of nodes.  m: local dataset size.  d: parameter dimension.
      p: sparsifier transmit probability.  theta, gamma: step parameters.
      beta: second-largest |eigenvalue| of W.  lambda_n: smallest eigenvalue.
      L: gradient Lipschitz constant.  G: gradient bound (Assumption 1(4)).
      sigma: Gaussian masking std.  sigma_tilde: stochastic-gradient std.
      tau: subsampling rate.  C1: f(0) - f*.
    """

    n: int
    m: int
    d: int
    p: float
    theta: float
    gamma: float
    beta: float
    lambda_n: float
    L: float = 1.0
    G: float = 1.0
    sigma: float = 1.0
    sigma_tilde: float = 1.0
    tau: float = 1.0
    C1: float = 1.0

    @property
    def C2(self) -> float:
        """C2 = n*sigma_tilde^2/(m*tau) + n*d*sigma^2."""
        return self.n * self.sigma_tilde ** 2 / (self.m * self.tau) + \
            self.n * self.d * self.sigma ** 2

    @property
    def C3(self) -> float:
        """C3 = (n G)^2 + (n d sigma)^2."""
        return (self.n * self.G) ** 2 + (self.n * self.d * self.sigma) ** 2


def theta_upper_bound(p: float, lambda_n: float, gamma: float, L: float) -> float:
    """Lemma 1's validity condition: theta < 2p / (1 - lambda_n + gamma L)."""
    return 2.0 * p / (1.0 - lambda_n + gamma * L)


def default_theta(p: float, lambda_n: float, gamma: float, L: float) -> float:
    """Corollary 3 / Theorem 4 choice: theta = min{p/(1-lambda_n+gamma L), p/2}."""
    return min(p / (1.0 - lambda_n + gamma * L), p / 2.0)


def default_gamma(n: int, T: int, c: float = 1.0) -> float:
    """Corollary 3 step size: gamma = c sqrt(n log(T) / T)."""
    if T < 2:
        raise ValueError("T must be >= 2")
    return c * math.sqrt(n * math.log(T) / T)


def dcdsgd_min_p(lambda_n: float) -> float:
    """Remark 1: DC-DSGD (theta = 1) needs
    p > 4(1-lambda_n)^2 / (4(1-lambda_n)^2 + (1-|lambda_n|)^2).

    SDM-DSGD's theta removes this restriction — the generalization claim.
    """
    a = 4.0 * (1.0 - lambda_n) ** 2
    b = (1.0 - abs(lambda_n)) ** 2
    return a / (a + b)


def lemma1_terms(x: BoundInputs, T: int) -> dict:
    """The four error terms (I)-(IV) of Lemma 1 (Eq. 7)."""
    th, g, p, n = x.theta, x.gamma, x.p, x.n
    one_m_beta = 1.0 - x.beta
    lip_v = 1.0 - x.lambda_n + x.gamma * x.L  # Lipschitz const of grad V
    denom = 2.0 * p - lip_v * th
    if denom <= 0:
        raise ValueError(
            f"theta={th} violates Lemma 1 bound {theta_upper_bound(p, x.lambda_n, g, x.L):.4g}")
    term1 = 2.0 * x.C1 / (th * g * T)
    term2 = 2.0 * x.L * x.C3 / x.n * (g / one_m_beta) ** 2
    term3 = (2.0 * th * g ** 2 * x.L * x.C2 / (n * one_m_beta)) * (1.0 / p - 1.0) + \
        x.L * th * g * x.C2 / (n ** 2 * p)
    term4 = (2.0 * g * x.L / (n * one_m_beta) + x.L / n ** 2) * (1.0 / p - 1.0) * (
        2.0 * p * n * x.C1 / (denom * T) + lip_v * th ** 2 * g * x.C2 / denom)
    return {"I": term1, "II": term2, "III": term3, "IV": term4}


def lemma1_bound(x: BoundInputs, T: int) -> float:
    """min_t ||grad f(xbar_t)||^2 <= (I)+(II)+(III)+(IV)."""
    return sum(lemma1_terms(x, T).values())


def corollary3_rate(n: int, T: int) -> float:
    """The headline rate O(sqrt(log(T)/(n T)))."""
    return math.sqrt(math.log(T) / (n * T))


def min_iterations_for_rate(n: int, beta: float) -> float:
    """Corollary 3 requires T > n^5 / (1-beta)^4 for the clean rate."""
    return n ** 5 / (1.0 - beta) ** 4
