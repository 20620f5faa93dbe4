"""The RP kernel's arithmetic, repeated in plain torch on the CPU, against
the JAX reference.

``csrc/rp_matmul.cu`` runs the product on tensor cores in TF32: it splits x
into hi = rna(x) and lo = rna(x - hi) (TF32, round to nearest with ties
away from zero), multiplies both by the +-1 signs of R (exact in TF32) into
one float32 sum, and scales that sum by 1/sqrt(r) once.  Here the rounding
is done by bit operations on the float32 words, the signs come from
``rp_matrix``, and the sum of the two products is taken in float64 (exact
enough to isolate the split), then rounded to float32 and scaled.  That
emulation must stay inside the kernel's band of rtol/atol 2e-4 of the JAX
reference (``repro.core.random_projection.rp``/``irp`` and the Pallas kernel
in interpret mode).  Both sides are linear in x, so for inputs scaled by c
the absolute part of the band is 2e-4 * c.  One TF32 pass (hi alone) must
fall outside it: that is why the kernel splits.  The tensor cores' own
summation order is checked on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import random_projection as j_rp
from repro.kernels.rp_matmul import irp_project_call, rp_project_call
from repro_torch.core.random_projection import rp_matrix, rp_scale
from tf32_split import split, tf32_rna
from torch_threads import one_thread  # noqa: F401

SHAPES = [(677, 256, 32), (130, 512, 64), (33, 40, 5)]
SCALES = [1e-3, 1.0, 1e3]
BAND = 2e-4


def kernel_product(x: torch.Tensor, signs: torch.Tensor, r: int,
                   parts: int = 2) -> torch.Tensor:
    """(hi @ S + lo @ S) summed in float64, rounded to float32, times
    1/sqrt(r) in float32; ``parts=1`` is a single TF32 pass."""
    hi, lo = split(x)
    acc = hi.double() @ signs
    if parts == 2:
        acc = acc + lo.double() @ signs
    return acc.float() * torch.tensor(rp_scale(r), dtype=torch.float32)


def _x(m, d, c):
    x = np.random.default_rng(m + d).normal(size=(m, d)) * 2.3 + 0.7
    return (x * c).astype(np.float32)


@pytest.mark.parametrize("c", SCALES)
@pytest.mark.parametrize("m,d,r", SHAPES)
def test_split_residual_within_2_pow_minus_22(m, d, r, c):
    x = torch.from_numpy(_x(m, d, c))
    hi, lo = split(x)
    # both parts are TF32: the 13 low bits are clear
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -22 * x.double().abs()).all())
    assert bool(((x - hi).double() == x.double() - hi.double()).all())


def test_tf32_rna_ties_away_from_zero():
    one = 0x3F800000
    words = torch.tensor([one | 0x1000, one | 0x0FFF, one | 0x3000,
                          one | 0x1FFF], dtype=torch.int32)
    for sign in (0, -2**31):
        x = (words + sign).view(torch.float32)
        got = tf32_rna(x).view(torch.int32) - sign
        assert got.tolist() == [one | 0x2000, one, one | 0x4000,
                                one | 0x2000]


@pytest.mark.parametrize("c", SCALES)
@pytest.mark.parametrize("m,d,r", SHAPES)
def test_kernel_arithmetic_matches_jax_rp_irp(m, d, r, c):
    x = _x(m, d, c)
    signs = torch.sign(rp_matrix(7, d, r)).double()
    y = kernel_product(torch.from_numpy(x), signs, r)
    y_ref = np.array(j_rp.rp(jnp.asarray(x), 7, r))
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=BAND, atol=BAND * c)
    xi = kernel_product(torch.from_numpy(y_ref), signs.T, r)
    xi_ref = np.asarray(j_rp.irp(jnp.asarray(y_ref), 7, d))
    np.testing.assert_allclose(xi.numpy(), xi_ref, rtol=BAND, atol=BAND * c)


@pytest.mark.parametrize("m,d,r", SHAPES)
def test_kernel_arithmetic_matches_pallas_interp(m, d, r):
    """One tile spanning each whole dimension, so the Pallas kernel takes
    every shape here (its 128 tile rule binds only on the TPU)."""
    x = _x(m, d, 1.0)
    signs = torch.sign(rp_matrix(7, d, r)).double()
    y_ref = np.array(rp_project_call(jnp.asarray(x), 7, r, tm=m, tn=r,
                                     tk=d, interpret=True))
    np.testing.assert_allclose(
        kernel_product(torch.from_numpy(x), signs, r).numpy(), y_ref,
        rtol=BAND, atol=BAND)
    xi_ref = np.asarray(irp_project_call(jnp.asarray(y_ref), 7, d, tm=m,
                                         tn=d, tk=r, interpret=True))
    np.testing.assert_allclose(
        kernel_product(torch.from_numpy(y_ref), signs.T, r).numpy(), xi_ref,
        rtol=BAND, atol=BAND)


@pytest.mark.parametrize("c", SCALES)
@pytest.mark.parametrize("m,d,r", SHAPES)
def test_single_tf32_pass_breaks_the_band(m, d, r, c):
    """hi alone drops up to 2^-11 |x| a term: outside rtol/atol 2e-4."""
    x = _x(m, d, c)
    signs = torch.sign(rp_matrix(7, d, r)).double()
    y_ref = np.array(j_rp.rp(jnp.asarray(x), 7, r))
    one = kernel_product(torch.from_numpy(x), signs, r, parts=1).numpy()
    excess = np.abs(one - y_ref) / (BAND * c + BAND * np.abs(y_ref))
    assert excess.max() > 1.0
