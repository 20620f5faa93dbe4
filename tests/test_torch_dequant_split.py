"""The fused backward's product arithmetic, repeated in plain torch on the
CPU, against the JAX reference.

``csrc/fused_matmul.cu``'s ``dequant_matmul`` runs dw = x_hat^T @ g on
tensor cores in bf16: it decodes the stash to float32 x_hat, splits x_hat
and g into hi = rn(v) and lo = rn(v - hi) (bf16, round to nearest with ties
to even, as ``cvt.rn.bf16x2.f32``) and sums three products, lo.hi, hi.lo
and hi.hi, into one float32 sum per output.  Here the three products are
summed in float64 (exact enough to isolate the split), then rounded to
float32.  That emulation must stay within 1e-4 * (|x_hat|^T |g|)
elementwise, the kernel's band on the card, of the JAX reference's dw
(``repro.kernels.fused_matmul.dequant_matmul_call``, the Pallas kernel in
interpret mode, and ``jnp.dot`` on the dequantized stash) at the
rp_ratio-0 slice's three layer widths, on the INT2 stash (G = 256) of
x ~ 1.7 N(0, 1) with VM and uniform levels, and g scaled by 1e-3, 1 and
1e3.

The VM levels are arbitrary float32 values, so x_hat is a general float32
and both operands need the split.  On random data rounding errors of
random sign cancel, so the aligned case holds the split to the band where
nothing cancels: identical stash rows and identical non-negative g rows.
There one pass and a split of either operand alone fall outside the band,
and the three products stay inside it.

The accumulation, emulated in the aligned case at the slice's 169,343 rows
and over its row ranges (``splits()``): ``mma.sync`` adds to its
accumulator truncating.  Two models of that bracket the hardware: the
step's exact sum cut once to float32 toward zero, and each product aligned
to the largest exponent and cut before the sum (Fasi et al. 2021 for the
generations before Hopper).  The kernel's order, three products a k16 step
into a fresh accumulator added to the output's float32 sum rounding to
nearest, then the fixed-order tree over the ranges, stays in the band
under both; under the second, one truncating chain along each range does
not.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels.fused_matmul import dequant_matmul_call
from repro_torch.core.compressor import CompressionConfig
from repro_torch.kernels import fused_matmul as t_fk
from repro_torch.kernels import ref as t_ref
from tf32_split import split_bf16
from torch_threads import one_thread  # noqa: F401

G, BITS = 256, 2
SHAPES = [(256, 256, 256), (256, 512, 256), (256, 512, 40)]   # (m, d, n)
SCALES = [1e-3, 1.0, 1e3]
ALIGNED = (4096, 256, 64)
BAND = 1e-4
THREE = ("lo.hi", "hi.lo", "hi.hi")
#: what a kernel with fewer bf16 products would sum
FEWER = {"one_pass": ("hi.hi",), "x_split_alone": ("lo.hi", "hi.hi"),
         "g_split_alone": ("hi.lo", "hi.hi")}
LEVELS = {"vm": CompressionConfig(BITS, G, 0, vm=True).levels(),
          "uniform": None}


def _stash(m, d, n, c, levels, aligned=False):
    """The JAX quantizer's INT2 stash of x (M, D) and g (M, N) as numpy;
    aligned: every stash row a copy of row 0's, every g row |N(0, 1)|."""
    r = np.random.default_rng(m + d + n)
    rows = 1 if aligned else m
    x = (r.normal(size=(rows, d)) * 1.7).astype(np.float32)
    if aligned:
        g = np.tile(np.abs(r.normal(size=(1, n))), (m, 1)) * c
    else:
        g = r.normal(size=(m, n)) / 400 * c
    p, z, rg = (np.array(a) for a in j_ops.quantize_packed(
        jnp.asarray(x).reshape(-1, G), BITS, 5, levels, impl="jnp"))
    if aligned:
        p, z, rg = np.tile(p, (m, 1)), np.tile(z, m), np.tile(rg, m)
    return p, z, rg, g.astype(np.float32)


def _x_hat(p, z, rg, m, d, levels) -> torch.Tensor:
    return t_ref.dequantize_packed(torch.from_numpy(p.view(np.int32)),
                                   torch.from_numpy(z), torch.from_numpy(rg),
                                   BITS, G, levels).reshape(m, d)


def kernel_product(x_hat: torch.Tensor, g: np.ndarray,
                   passes=THREE) -> np.ndarray:
    """The named products of the bf16 hi/lo parts of x_hat and g, summed
    in float64 and rounded to float32: dw (D, N)."""
    xh, xl = split_bf16(x_hat)
    gh, gl = split_bf16(torch.from_numpy(g))
    parts = {"hi.hi": (xh, gh), "hi.lo": (xh, gl), "lo.hi": (xl, gh)}
    acc = sum(a.double().T @ b.double() for a, b in (parts[p] for p in passes))
    return acc.float().numpy()


def _pallas(p, z, rg, g, d, levels) -> np.ndarray:
    n = g.shape[1]
    return np.asarray(dequant_matmul_call(
        jnp.asarray(p), jnp.asarray(z)[:, None], jnp.asarray(rg)[:, None],
        jnp.asarray(g), BITS, G, d, levels, tn=128 if n % 128 == 0 else n,
        interpret=True))


def _jnp_dot(p, z, rg, g, m, d, levels) -> np.ndarray:
    x_hat = j_ops.dequantize_packed(jnp.asarray(p), jnp.asarray(z),
                                    jnp.asarray(rg), BITS, G, levels,
                                    impl="jnp").reshape(m, d)
    return np.asarray(jnp.dot(x_hat.T, jnp.asarray(g)))


def _excess(dw, want, x_hat, g) -> float:
    """max |dw - want| / (BAND * |x_hat|^T |g|): above 1 is outside."""
    scale = x_hat.double().abs().T @ torch.from_numpy(g).double().abs()
    return float((np.abs(dw.astype(np.float64) - want) / (BAND * scale.numpy())
                  ).max())


@pytest.mark.parametrize("lv", sorted(LEVELS))
@pytest.mark.parametrize("c", SCALES)
@pytest.mark.parametrize("m,d,n", SHAPES)
def test_three_pass_product_matches_pallas_interp(m, d, n, c, lv):
    levels = LEVELS[lv]
    p, z, rg, g = _stash(m, d, n, c, levels)
    x_hat = _x_hat(p, z, rg, m, d, levels)
    dw = kernel_product(x_hat, g)
    assert _excess(dw, _pallas(p, z, rg, g, d, levels), x_hat, g) <= 1.0
    assert _excess(dw, _jnp_dot(p, z, rg, g, m, d, levels), x_hat, g) <= 1.0


@pytest.mark.parametrize("lv", sorted(LEVELS))
def test_three_pass_product_aligned_errors_stay_in_band(lv):
    """Nothing cancels: the three products stay within the band of both
    JAX references, and of the exact product of the float32 inputs."""
    m, d, n = ALIGNED
    levels = LEVELS[lv]
    p, z, rg, g = _stash(m, d, n, 1.0, levels, aligned=True)
    x_hat = _x_hat(p, z, rg, m, d, levels)
    dw = kernel_product(x_hat, g)
    exact = (x_hat.double().T @ torch.from_numpy(g).double()).numpy()
    for want in (_pallas(p, z, rg, g, d, levels),
                 _jnp_dot(p, z, rg, g, m, d, levels), exact):
        assert _excess(dw, want, x_hat, g) <= 1.0


@pytest.mark.parametrize("variant", sorted(FEWER))
@pytest.mark.parametrize("lv", sorted(LEVELS))
def test_fewer_bf16_products_break_the_band_on_aligned_errors(lv, variant):
    """One pass drops up to 2^-9 |x_hat||g| a term, a one-operand split up
    to 2^-9 of the other operand: aligned, outside 1e-4 of the Pallas
    kernel's dw."""
    m, d, n = ALIGNED
    levels = LEVELS[lv]
    p, z, rg, g = _stash(m, d, n, 1.0, levels, aligned=True)
    x_hat = _x_hat(p, z, rg, m, d, levels)
    dw = kernel_product(x_hat, g, FEWER[variant])
    assert _excess(dw, _pallas(p, z, rg, g, d, levels), x_hat, g) > 1.0


@pytest.mark.parametrize("m,d,n", SHAPES)
def test_three_pass_error_within_the_dropped_terms(m, d, n):
    """Against the exact product of x_hat and g, the emulation misses at
    most the dropped lo.lo and the two split residuals, each <= 2^-16
    |x_hat||g| a term, plus the final rounding to float32."""
    levels = LEVELS["vm"]
    p, z, rg, g = _stash(m, d, n, 1.0, levels)
    x_hat = _x_hat(p, z, rg, m, d, levels)
    xd, gd = x_hat.double(), torch.from_numpy(g).double()
    exact = (xd.T @ gd).numpy()
    err = np.abs(kernel_product(x_hat, g).astype(np.float64) - exact)
    limit = 3 * 2.0 ** -16 * (xd.abs().T @ gd.abs()).numpy() \
        + 2.0 ** -24 * np.abs(exact)
    assert bool((err <= limit).all())


# ------------------------------------------- the accumulation (aligned case)
#: the rp_ratio-0 slice's rows and layer widths (d, n)
SLICE_M = 169_343
SLICE_LAYERS = [(256, 256), (512, 256), (512, 40)]


def _rz32(v: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 toward zero (as float64)."""
    f = v.float()
    f = torch.where(f.double().abs() > v.abs(),
                    torch.nextafter(f, torch.zeros_like(f)), f)
    return f.double()


def _mma_sum(c, p, k):
    """One m16n8k16 step on k identical rows, each adding the product p:
    the exact sum cut once to float32."""
    return _rz32(c + k * p)


def _mma_per_term(c, p, k):
    """The same, each term aligned to the largest exponent and cut to 24
    bits before the sum, the sum cut again."""
    big = torch.maximum(c.abs(), p.abs()).clamp_min(2.0 ** -1000)
    q = torch.pow(2.0, torch.floor(torch.log2(big)) - 23)
    return _rz32(torch.trunc(c / q) * q + k * (torch.trunc(p / q) * q))


MODELS = {"sum_cut": _mma_sum, "per_term_cut": _mma_per_term}


def _range_sum(products, rows, mma, fresh):
    """One row range of ``rows`` identical rows in k16 steps (the last one
    partial): fresh, three products a step into a zero accumulator added
    to a float32 sum rounding to nearest (the kernel); else one truncating
    chain along the range."""
    acc = torch.zeros_like(products[0])
    for i in range(math.ceil(rows / 16)):
        k = min(16, rows - 16 * i)
        t = torch.zeros_like(acc) if fresh else acc
        for p in products:
            t = mma(t, p, k)
        acc = (acc.float() + t.float()).double() if fresh else t
    return acc


def _tree(parts):
    """tree_sum_kernel's fixed pairwise order, in float32."""
    parts = [p.float() for p in parts]
    while len(parts) > 1:
        half = len(parts) // 2
        parts = [parts[2 * j] + parts[2 * j + 1] for j in range(half)] + (
            [parts[-1]] if len(parts) % 2 else [])
    return parts[0].double()


def _aligned_excess(d, n, lv, model, fresh) -> float:
    """max |dw - exact| / (BAND * |x_hat|^T |g|) of the emulated kernel on
    SLICE_M identical rows over the port's row ranges.  x_hat takes a few
    distinct values (levels x blocks), so only those are summed."""
    p, z, rg, g = _stash(1, d, n, 1.0, LEVELS[lv], aligned=True)
    x = torch.unique(_x_hat(p, z, rg, 1, d, LEVELS[lv])[0])
    g = torch.from_numpy(g[0])
    (xh, xl), (gh, gl) = split_bf16(x), split_bf16(g)
    outer = lambda a, b: torch.outer(a.double(), b.double())   # exact
    products = [outer(xl, gh), outer(xh, gl), outer(xh, gh)]  # kernel order
    s, rows = t_fk.splits(SLICE_M, d, n)
    full = _range_sum(products, rows, MODELS[model], fresh)
    last = _range_sum(products, SLICE_M - (s - 1) * rows, MODELS[model],
                      fresh)
    dw = _tree([full] * (s - 1) + [last])
    exact = SLICE_M * outer(x, g)
    return float(((dw - exact).abs() / (BAND * exact.abs())).max())


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("lv", sorted(LEVELS))
@pytest.mark.parametrize("d,n", SLICE_LAYERS)
def test_kernel_accumulation_aligned_stays_in_band(d, n, lv, model):
    """A fresh accumulator a k16 step: the cuts stay within the step, and
    the float32 sums and the tree round to nearest, inside the band at the
    slice's longest ranges under either model of the cut."""
    assert _aligned_excess(d, n, lv, model, fresh=True) <= 1.0


@pytest.mark.parametrize("lv", sorted(LEVELS))
@pytest.mark.parametrize("d,n", SLICE_LAYERS)
def test_one_truncating_chain_a_range_breaks_the_band(d, n, lv):
    """Where each product is cut before the sum, one accumulator along a
    range's 5,312 or 10,592 rows loses in proportion to its length:
    outside the band."""
    assert _aligned_excess(d, n, lv, "per_term_cut", fresh=False) > 1.0
