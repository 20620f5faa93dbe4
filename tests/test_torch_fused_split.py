"""The fused forward's product arithmetic, repeated in plain torch on the
CPU, against the JAX reference.

``csrc/fused_matmul.cu``'s ``matmul_quant`` runs y = x @ w on tensor cores
in TF32: it splits x and w into hi = rna(v) and lo = rna(v - hi) (TF32,
round to nearest with ties away from zero) and sums three products, lo.hi,
hi.lo and hi.hi, into one float32 sum per output.  Here the three products
are summed in float64 (exact enough to isolate the split), then rounded to
float32.  That emulation must stay inside the kernel's band of rtol/atol
2e-4 of the JAX reference's y (``repro.kernels.fused_matmul.
matmul_quant_call``, the Pallas kernel in interpret mode, and ``jnp.dot``)
at the rp_ratio-0 slice's three layer widths, with x ~ 1.7 N(0, 1) and
w ~ N(0, 1/D) as ``chip_smoke.check_fused`` draws them, scaled by 1e-3, 1
and 1e3.  Both sides are linear in x, so for x scaled by c the absolute
part of the band is 2e-4 * c.  One TF32 pass, and a split of one operand
alone, must fall outside it: unlike RP's exact +-1, w is an arbitrary
float32, so the kernel needs all three products.  The stash is quantized
from the float32 x and does not see the split (its bits are checked in
``tests/test_torch_fused.py`` and, on the card, ``tests/test_torch_cuda.py``;
so is the tensor cores' own summation order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_matmul import matmul_quant_call
from tf32_split import split
from torch_threads import one_thread  # noqa: F401

SHAPES = [(256, 256, 256), (256, 512, 256), (256, 512, 40)]   # (m, d, n)
SCALES = [1e-3, 1.0, 1e3]
BAND = 2e-4
THREE = ("lo.hi", "hi.lo", "hi.hi")
#: what a kernel with fewer TF32 products would sum
FEWER = {"one_pass": ("hi.hi",), "x_split_alone": ("lo.hi", "hi.hi"),
         "w_split_alone": ("hi.lo", "hi.hi")}


def _inputs(m, d, n, c):
    r = np.random.default_rng(m + d + n)
    x = (r.normal(size=(m, d)) * 1.7 * c).astype(np.float32)
    w = (r.normal(size=(d, n)) / np.sqrt(d)).astype(np.float32)
    return x, w


def kernel_product(x: np.ndarray, w: np.ndarray,
                   passes=THREE) -> np.ndarray:
    """The named products of the hi/lo parts of x and w, summed in float64
    and rounded to float32."""
    xh, xl = split(torch.from_numpy(x))
    wh, wl = split(torch.from_numpy(w))
    parts = {"hi.hi": (xh, wh), "hi.lo": (xh, wl), "lo.hi": (xl, wh)}
    acc = sum(a.double() @ b.double() for a, b in (parts[p] for p in passes))
    return acc.float().numpy()


def _dot(x, w):
    return np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("c", SCALES)
@pytest.mark.parametrize("m,d,n", SHAPES)
def test_three_pass_product_matches_jax_dot(m, d, n, c):
    x, w = _inputs(m, d, n, c)
    np.testing.assert_allclose(kernel_product(x, w), _dot(x, w), rtol=BAND,
                               atol=BAND * c)


@pytest.mark.parametrize("c", SCALES)
@pytest.mark.parametrize("m,d,n", SHAPES)
def test_three_pass_product_matches_pallas_interp(m, d, n, c):
    """The reference kernel's y, with row and column tiles that divide M
    and N (`_build_matmul_quant` asserts both: N = 40 takes tn = 40)."""
    x, w = _inputs(m, d, n, c)
    y_ref = np.asarray(matmul_quant_call(jnp.asarray(x), jnp.asarray(w), 2,
                                         7, group_size=256, tm=128,
                                         tn=min(n, 128), interpret=True)[0])
    np.testing.assert_allclose(kernel_product(x, w), y_ref, rtol=BAND,
                               atol=BAND * c)


@pytest.mark.parametrize("m,d,n", SHAPES)
def test_three_pass_error_within_the_dropped_terms(m, d, n):
    """Against the exact product of the float32 inputs, the emulation
    misses at most the dropped lo.lo and the two split residuals, each
    <= 2^-22 |x||w| a term, plus the final rounding to float32."""
    x, w = _inputs(m, d, n, 1.0)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    err = np.abs(kernel_product(x, w).astype(np.float64) - exact)
    limit = 3 * 2.0 ** -22 * (np.abs(x).astype(np.float64) @ np.abs(w)) \
        + 2.0 ** -24 * np.abs(exact)
    assert bool((err <= limit).all())


@pytest.mark.parametrize("variant", sorted(FEWER))
@pytest.mark.parametrize("c", SCALES)
@pytest.mark.parametrize("m,d,n", SHAPES)
def test_fewer_tf32_products_break_the_band(m, d, n, c, variant):
    """One pass drops up to 2^-11 |x||w| a term, a one-operand split up to
    2^-11 of the other operand: outside rtol/atol 2e-4 of jnp.dot."""
    x, w = _inputs(m, d, n, c)
    y_ref = _dot(x, w)
    y = kernel_product(x, w, FEWER[variant])
    excess = np.abs(y - y_ref) / (BAND * c + BAND * np.abs(y_ref))
    assert excess.max() > 1.0
