"""Improved variance minimization (paper §3.2, App. A-C).

Models normalized activations with the clipped normal
``CN_[1/D](μ=B/2, σ=-μ/Φ⁻¹(1/D))`` (paper Eq. 7), computes the expected
stochastic-rounding variance for an arbitrary level table (Eq. 9/10), and
numerically optimizes the interior quantization levels (App. B).

All of this runs at *configuration* time in numpy/scipy; the resulting level
table is a tiny constant fed into the quantizers.  A framework-free copy of
the reference's ``repro.core.variance`` (the port never imports ``repro``).
"""
from __future__ import annotations

import functools

import numpy as np

_SQRT2 = float(np.sqrt(2.0))
# numpy < 2 names the trapezoid rule ``trapz``
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _ndtri(p: float) -> float:
    """Φ⁻¹ — prefer scipy, fall back to a rational approximation."""
    try:
        from scipy.special import ndtri

        return float(ndtri(p))
    except Exception:  # pragma: no cover - scipy is installed here
        # Acklam's approximation
        a = [-3.969683028665376e01, 2.209460984245205e02, -2.759285104469687e02,
             1.383577518672690e02, -3.066479806614716e01, 2.506628277459239e00]
        b = [-5.447609879822406e01, 1.615858368580409e02, -1.556989798598866e02,
             6.680131188771972e01, -1.328068155288572e01]
        c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e00,
             -2.549732539343734e00, 4.374664141464968e00, 2.938163982698783e00]
        d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e00,
             3.754408661907416e00]
        plow, phigh = 0.02425, 1 - 0.02425
        if p < plow:
            q = np.sqrt(-2 * np.log(p))
            return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
                   ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
        if p <= phigh:
            q = p - 0.5
            r = q * q
            return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q / \
                   (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
        q = np.sqrt(-2 * np.log(1 - p))
        return -(((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]) / \
               ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)


def clipped_normal_params(D: int, bits: int = 2) -> tuple[float, float]:
    """(μ, σ) of CN_[1/D] (paper Eq. 7): μ = B/2, σ = -μ/Φ⁻¹(1/D)."""
    B = 2**bits - 1
    mu = B / 2.0
    sigma = -mu / _ndtri(1.0 / D)
    return mu, sigma


def _normal_pdf(h: np.ndarray, mu: float, sigma: float) -> np.ndarray:
    z = (h - mu) / sigma
    return np.exp(-0.5 * z * z) / (sigma * np.sqrt(2 * np.pi))


def clipped_normal_pdf_grid(
    D: int, bits: int = 2, n_grid: int = 8192
) -> tuple[np.ndarray, np.ndarray]:
    """(h_grid, density) of the *continuous part* of CN on (0, B).

    The clip masses at h=0 and h=B (each exactly 1/D) sit at quantization
    levels and contribute zero SR variance, so the expected-variance integral
    only needs the continuous part.
    """
    B = 2**bits - 1
    mu, sigma = clipped_normal_params(D, bits)
    h = np.linspace(0.0, float(B), n_grid)
    return h, _normal_pdf(h, mu, sigma)


def sr_variance(h: np.ndarray, levels: np.ndarray) -> np.ndarray:
    """Var(⌊h⌉) for each h given a strictly-increasing level table (Eq. 9).

    For h in bin [α_{i-1}, α_i] of width δ_i:
    Var = δ_i (h − α_{i-1}) − (h − α_{i-1})².
    """
    levels = np.asarray(levels, dtype=np.float64)
    idx = np.clip(np.searchsorted(levels, h, side="right"), 1, len(levels) - 1)
    lo = levels[idx - 1]
    hi = levels[idx]
    t = h - lo
    return (hi - lo) * t - t * t


def expected_sr_variance(
    levels, D: int, bits: int = 2, n_grid: int = 8192
) -> float:
    """E[Var(⌊h⌉)] under CN_[1/D] (paper Eq. 10), trapezoid-integrated."""
    h, pdf = clipped_normal_pdf_grid(D, bits, n_grid)
    v = sr_variance(h, np.asarray(levels, np.float64))
    return float(_trapezoid(v * pdf, h))


def expected_sr_variance_uniform(D: int, bits: int = 2, n_grid: int = 8192) -> float:
    B = 2**bits - 1
    return expected_sr_variance(np.arange(B + 1.0), D, bits, n_grid)


@functools.lru_cache(maxsize=None)
def optimize_levels(D: int, bits: int = 2, n_grid: int = 8192) -> tuple[float, ...]:
    """Interior levels minimizing Eq. 10; returns the full level table.

    INT2: optimize [α, β] of the central bin (paper Fig. 1-B).  Generic in
    ``bits`` — 2**bits − 2 free interior levels.  App. B: computed once per
    D (the paper precomputes D ∈ {4..2048}); lru_cache is our table.
    """
    B = 2**bits - 1
    n_int = 2**bits - 2
    h, pdf = clipped_normal_pdf_grid(D, bits, n_grid)

    def unconstrain(free: np.ndarray) -> np.ndarray:
        # strictly-increasing interior levels in (0, B) via softmax-like gaps
        gaps = np.exp(free - np.max(free))
        gaps = gaps / gaps.sum()
        cuts = np.cumsum(gaps)[:-1] * B
        return cuts

    def objective(free: np.ndarray) -> float:
        interior = unconstrain(free)
        levels = np.concatenate([[0.0], interior, [float(B)]])
        v = sr_variance(h, levels)
        return float(_trapezoid(v * pdf, h))

    x0 = np.zeros(n_int + 1)  # uniform gaps == EXACT levels
    try:
        from scipy.optimize import minimize

        res = minimize(objective, x0, method="Nelder-Mead",
                       options={"xatol": 1e-6, "fatol": 1e-12, "maxiter": 4000})
        best = res.x
    except Exception:  # pragma: no cover
        best = x0
        step = 0.5
        fb = objective(best)
        for _ in range(200):
            improved = False
            for i in range(len(best)):
                for s in (+step, -step):
                    cand = best.copy()
                    cand[i] += s
                    fc = objective(cand)
                    if fc < fb:
                        best, fb, improved = cand, fc, True
            if not improved:
                step *= 0.5
                if step < 1e-6:
                    break
    interior = unconstrain(best)
    return tuple([0.0, *interior.tolist(), float(B)])


def variance_reduction(D: int, bits: int = 2) -> float:
    """Fractional reduction of E[Var] from VM levels vs uniform (Table 2)."""
    u = expected_sr_variance_uniform(D, bits)
    o = expected_sr_variance(optimize_levels(D, bits), D, bits)
    return 1.0 - o / u


def js_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """Jensen-Shannon divergence between two histograms (Table 2 metric)."""
    p = np.asarray(p, np.float64) + eps
    q = np.asarray(q, np.float64) + eps
    p = p / p.sum()
    q = q / q.sum()
    m = 0.5 * (p + q)
    kl = lambda a, b: float(np.sum(a * np.log(a / b)))
    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def model_histogram(D: int, bits: int, edges: np.ndarray, kind: str) -> np.ndarray:
    """Histogram (over ``edges``) of the uniform or clipped-normal model.

    Used by the Table 2 benchmark to compare both models against observed
    normalized activations.  Includes the clip masses at 0 and B for the CN.
    """
    B = 2**bits - 1
    if kind == "uniform":
        w = np.diff(edges) / B
        return w
    mu, sigma = clipped_normal_params(D, bits)
    try:
        from scipy.stats import norm

        cdf = norm.cdf(edges, mu, sigma)
    except Exception:  # pragma: no cover
        from math import erf

        cdf = np.array([0.5 * (1 + erf((e - mu) / (sigma * _SQRT2))) for e in edges])
    hist = np.diff(cdf)
    hist[0] += cdf[0]          # mass clipped to 0
    hist[-1] += 1.0 - cdf[-1]  # mass clipped to B
    return hist
