"""The port's kernel modules against the JAX reference on the CPU: the plain
versions (what a kernel wrapper runs for a CPU tensor) must write the same
packed words, zero and range as both the jnp path and the Pallas kernels in
interpret mode, and RP/IRP must agree to float tolerance.  The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.quant_blockwise import dequant_unpack_call, quant_pack_call
from repro.kernels.rp_matmul import irp_project_call, rp_project_call
from repro.core import random_projection as j_rp
from repro.core.quant import group_reshape as j_group_reshape
from repro_torch.core import quant as t_quant
from repro_torch.core.variance import optimize_levels
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import quant_blockwise as t_qk
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import rp_matmul as t_rk
from torch_threads import one_thread  # noqa: F401

VM2 = optimize_levels(32, 2)


def _x(n, g, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, g)) * 2.3
            + 0.7).astype(np.float32)


def _words(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("n,g,bits", [(37, 256, 2), (8, 64, 2), (24, 128, 4),
                                      (16, 32, 1), (8, 64, 8)])
def test_quant_words_bit_equal_to_jnp_and_interp(levels, n, g, bits):
    if levels is not None and bits != 2:
        levels = optimize_levels(32, bits) if bits <= 4 else None
    x = _x(n, g, seed=n * g + bits)
    pt, zt, rt = t_qk.quant_pack(torch.from_numpy(x), bits, 42, levels)
    pj, zj, rj = j_ref.quantize_packed(jnp.asarray(x), bits, 42, levels)
    np.testing.assert_array_equal(pt.numpy(), _words(pj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    # the Pallas kernel in interpret mode (rows padded to its 8-row tile)
    pad = (-n) % 8
    xp = np.concatenate([x, np.zeros((pad, g), np.float32)]) if pad else x
    pi, zi, ri = quant_pack_call(jnp.asarray(xp), bits, 42, levels,
                                 interpret=True)
    np.testing.assert_array_equal(pt.numpy(), _words(pi)[:n])
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zi)[:n, 0])
    np.testing.assert_array_equal(rt.numpy(), np.asarray(ri)[:n, 0])
    # dequantize within the reference's 1e-5 band (tests/test_kernels.py)
    dt = t_qk.dequant_unpack(pt, zt, rt, bits, g, levels).numpy()
    dj = np.asarray(j_ref.dequantize_packed(pj, zj, rj, bits, g, levels))
    np.testing.assert_allclose(dt, dj, atol=1e-5)
    di = np.asarray(dequant_unpack_call(pi, zi, ri, bits, g, levels,
                                        interpret=True))[:n]
    np.testing.assert_allclose(dt, di, atol=1e-5)


def test_ragged_tail_blocks_bit_equal():
    """A tensor whose element count is not whole blocks: the replicate-
    padded tail (as on every layer of the full-width run, N odd)."""
    x = np.random.default_rng(5).normal(size=(677, 32)).astype(np.float32)
    jb, _ = j_group_reshape(jnp.asarray(x), 256)
    tb, n = t_quant.group_reshape(torch.from_numpy(x), 256)
    assert n % 256 and tb.shape == jb.shape
    pt, zt, rt = t_ops.quantize_packed(tb, 2, 9, VM2, impl="torch")
    for impl in ("jnp", "interp"):
        pj, zj, rj = j_ops.quantize_packed(jb, 2, 9, VM2, impl=impl)
        np.testing.assert_array_equal(pt.numpy(), _words(pj))
        np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))


@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
def test_kernel_sr_arithmetic_matches_searchsorted(levels):
    """The CUDA kernel's stochastic rounding, written out in numpy float32
    (uniform: floor; VM: count the interior levels <= h), gives the codes
    of the plain version's searchsorted(side="right") clipped to
    [1, nlev-1]."""
    rs = np.random.default_rng(11)
    h = rs.uniform(0, 3, 20000).astype(np.float32)
    h[:6] = [0.0, 3.0, 1.0, 2.0, np.float32(VM2[1]), np.float32(VM2[2])]
    u = rs.uniform(0, 1, h.shape).astype(np.float32)
    if levels is None:
        lo = np.floor(h)
        kern = lo.astype(np.int64) + (u < h - lo)
        lv = np.arange(4, dtype=np.float32)
    else:
        lv = np.asarray(levels, np.float32)
        idx = sum((h >= lv[i]).astype(np.int64) for i in range(1, 3))
        lo, hi = lv[idx], lv[idx + 1]
        p_up = (h - lo) / np.maximum(hi - lo, np.float32(1e-10))
        kern = idx + (u < p_up)
    upper = np.clip(np.searchsorted(lv, h, side="right"), 1, 3)
    lo, hi = lv[upper - 1], lv[upper]
    p_up = (h - lo) / np.maximum(hi - lo, np.float32(1e-10))
    plain = np.where(u < p_up, upper, upper - 1)
    np.testing.assert_array_equal(kern, plain)


@pytest.mark.parametrize("m,d,r", [(64, 256, 128), (100, 512, 128),
                                   (128, 128, 256)])
def test_rp_irp_match_pallas_interp(m, d, r):
    """rtol/atol 2e-4: float32 sums in another order (the reference's own
    band in tests/test_kernels.py)."""
    x = np.random.default_rng(m + d).normal(size=(m, d)).astype(np.float32)
    mp = m + (-m) % 128
    xp = np.concatenate([x, np.zeros((mp - m, d), np.float32)])
    y = t_rk.rp_project(torch.from_numpy(x), 7, r)
    yj = np.asarray(rp_project_call(jnp.asarray(xp), 7, r, interpret=True))
    np.testing.assert_allclose(y.numpy(), yj[:m], rtol=2e-4, atol=2e-4)
    xi = t_rk.irp_project(y, 7, d)
    yp = np.concatenate([y.numpy(), np.zeros((mp - m, r), np.float32)])
    xij = np.asarray(irp_project_call(jnp.asarray(yp), 7, d, interpret=True))
    np.testing.assert_allclose(xi.numpy(), xij[:m], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d,r", [(128, 16), (256, 32), (512, 64)])
def test_rp_irp_match_jnp_off_tile(d, r):
    """r = 16/32/64 are off the TPU's 128 tile: the reference takes its jnp
    matmul there, the port its kernel (plain version on the CPU)."""
    x = np.random.default_rng(d).normal(size=(301, d)).astype(np.float32)
    y = t_ops.rp_project(torch.from_numpy(x), 5, r)
    yj = np.asarray(j_rp.rp(jnp.asarray(x), 5, r))
    np.testing.assert_allclose(y.numpy(), yj, rtol=2e-4, atol=2e-4)
    xi = t_ops.irp_project(y, 5, d)
    xj = np.asarray(j_rp.irp(jnp.asarray(yj), 5, d))
    np.testing.assert_allclose(xi.numpy(), xj, rtol=2e-4, atol=2e-4)


def test_wrappers_take_plain_path_only_on_cpu():
    x = torch.from_numpy(_x(16, 256))
    before = (t_qk.quant_pack.launches, t_rk.rp_project.launches)
    p, z, r = t_qk.quant_pack(x, 2, 3, VM2)
    pr, zr, rr = t_ref.quantize_packed(x, 2, 3, VM2)
    assert torch.equal(p, pr) and torch.equal(z, zr) and torch.equal(r, rr)
    t_rk.rp_project(x, 3, 32)
    assert (t_qk.quant_pack.launches, t_rk.rp_project.launches) == before


def test_impl_resolution():
    assert t_ops.resolve_impl("auto", "cpu") == "torch"
    assert t_ops.resolve_impl("auto", "cuda") == "cuda"
    assert t_ops.resolve_impl("torch", "cuda") == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        t_ops.resolve_impl("cuda", "cpu")
    with pytest.raises(ValueError):
        t_ops.resolve_impl("pallas", "cpu")
    assert t_ops.static_levels(np.array([0, 1.5, 3])) == (0.0, 1.5, 3.0)
    assert t_ops.static_levels(torch.tensor([0.0, 3.0])) == (0.0, 3.0)
