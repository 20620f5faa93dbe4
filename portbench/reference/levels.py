"""Variance-minimized quantization levels (the paper's section 3.2 and
App. B), worked out again for the reference: the interior levels that
minimize the expected stochastic-rounding variance of activations modelled
as the clipped normal ``CN_[1/D](mu = B/2, sigma = -mu / Phi^-1(1/D))``,
by Nelder-Mead over softmax gaps starting from the uniform levels.
"""
from __future__ import annotations

import functools

import numpy as np

_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _sr_variance(h: np.ndarray, levels: np.ndarray) -> np.ndarray:
    idx = np.clip(np.searchsorted(levels, h, side="right"), 1,
                  len(levels) - 1)
    lo, hi = levels[idx - 1], levels[idx]
    t = h - lo
    return (hi - lo) * t - t * t


@functools.lru_cache(maxsize=None)
def vm_levels(d: int, bits: int, n_grid: int = 8192) -> tuple[float, ...]:
    """The full level table ``0 .. B`` for the CN model of dimension ``d``."""
    # scipy is imported here, after a run's window: it is slow to import
    from scipy.optimize import minimize
    from scipy.special import ndtri

    b = 2**bits - 1
    mu = b / 2.0
    sigma = -mu / float(ndtri(1.0 / d))
    h = np.linspace(0.0, float(b), n_grid)
    z = (h - mu) / sigma
    pdf = np.exp(-0.5 * z * z) / (sigma * np.sqrt(2 * np.pi))

    def interior(free: np.ndarray) -> np.ndarray:
        gaps = np.exp(free - np.max(free))
        gaps = gaps / gaps.sum()
        return np.cumsum(gaps)[:-1] * b

    def objective(free: np.ndarray) -> float:
        lv = np.concatenate([[0.0], interior(free), [float(b)]])
        return float(_trapezoid(_sr_variance(h, lv) * pdf, h))

    res = minimize(objective, np.zeros(2**bits - 1), method="Nelder-Mead",
                   options={"xatol": 1e-6, "fatol": 1e-12, "maxiter": 4000})
    return tuple([0.0, *interior(res.x).tolist(), float(b)])


def level_table(bits: int, group_size: int, rp_ratio: int, vm: bool):
    """The levels a stash of this recipe rounds onto: the integers
    ``0 .. B``, or the VM table for D = the block size after projection
    (``group_size // rp_ratio``, at least 2)."""
    if not vm:
        return tuple(float(v) for v in range(2**bits))
    d = group_size // rp_ratio if rp_ratio > 1 else group_size
    return vm_levels(max(int(d), 2), bits)
