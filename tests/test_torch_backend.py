"""The port's dispatch layer and compressor against the JAX reference:
routing makes the reference's eligibility decisions, and compress writes
the reference's packed words for the paper config."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as j_backend
from repro.core import compressor as j_comp
from repro_torch.core import backend as t_backend
from repro_torch.core import compressor as t_comp
from torch_threads import one_thread  # noqa: F401

LEVEL_CASES = [None, (0.0, 1.0, 2.0, 3.0), tuple(float(i) for i in range(16)),
               tuple(float(i) for i in range(17))]
GRID = list(itertools.product([1, 2, 3, 4, 5, 8, 16], [32, 64, 96, 100, 256],
                              LEVEL_CASES))


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _port_takes(bits, levels):
    """The quant kernels' rule: bits divides 32 and a VM table has at most
    256 levels (any group size: ragged words pack with zero fields)."""
    return 32 % bits == 0 and (levels is None or len(levels) <= 256)


@pytest.mark.parametrize("bits,g,levels", GRID)
def test_route_quant_decisions_match_reference(bits, g, levels):
    """The port's "cuda" (explicit or by "auto" on a CUDA device) takes
    every config the reference's kernel impl takes, and besides the ones
    the reference leaves to its jnp path on the TPU (ragged words, VM
    tables of up to 256 levels); it refuses only ``32 % bits`` and larger
    tables.  The CPU path ("auto" there) always runs the plain version, as
    the reference's jnp path does off the TPU."""
    ref_reason = j_backend.quant_kernel_unsupported(bits, g, levels)
    port_reason = t_backend.quant_kernel_unsupported(bits, g, levels)
    assert (port_reason is None) == _port_takes(bits, levels)
    if ref_reason is None:
        assert port_reason is None
    ref_raises = _raises(lambda: j_backend.route_quant("interp", bits, g,
                                                       levels))
    assert ref_raises == (ref_reason is not None)
    for impl in ("cuda", "auto"):
        assert _raises(lambda: t_backend.route_quant(
            impl, bits, g, levels, "cuda")) == (port_reason is not None)
    assert j_backend.route_quant("auto", bits, g, levels) == "jnp"
    assert t_backend.route_quant("auto", bits, g, levels, "cpu") == "torch"


@pytest.mark.parametrize("bits,g", [(8, 256), (8, 125), (4, 1000), (2, 4096),
                                    (16, 64)])
@pytest.mark.parametrize("n_levels", [17, 256, 257])
def test_route_quant_takes_tables_up_to_256_levels(bits, g, n_levels):
    levels = tuple(float(i) for i in range(n_levels))
    raises = _raises(lambda: t_backend.route_quant("auto", bits, g, levels,
                                                   "cuda"))
    assert raises == (n_levels > 256)
    # the reference's kernel impl stops at 16 levels
    assert j_backend.quant_kernel_unsupported(bits, g, levels) is not None


SHAPES = [(64, 256), (100, 256), (33, 256), (512, 32), (4, 96), (8, 512),
          (10, 24), (3, 4, 64)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits,g", [(2, 256), (2, 64), (4, 128), (3, 64),
                                    (8, 32)])
def test_fused_eligibility_matches_reference(shape, bits, g):
    lv = (0.0, 1.1, 1.9, 3.0) if bits == 2 else None
    want = j_backend.fused_unsupported(shape, bits, g, lv)
    got = t_backend.fused_unsupported(shape, bits, g, lv)
    assert (got is None) == (want is None)
    assert t_backend.supports_fused(shape, bits, g, lv) == (want is None)
    for rp_ratio in (0, 8):
        ref_raises = _raises(lambda: j_backend.route_fused(
            "on", "jnp", shape, bits, g, lv, rp_ratio))
        for device, concrete in (("cpu", "torch"), ("cuda", "cuda")):
            if ref_raises:
                with pytest.raises(ValueError):
                    t_backend.route_fused("on", "auto", shape, bits, g, lv,
                                          rp_ratio, device)
            else:
                assert t_backend.route_fused("on", "auto", shape, bits, g,
                                             lv, rp_ratio, device) == concrete
            assert t_backend.route_fused("off", "auto", shape, bits, g, lv,
                                         rp_ratio, device) is None
        # "auto" fuses only on the kernel path: the card, where the
        # reference's kernel impl ("pallas") would fuse
        want = j_backend.route_fused("auto", "pallas", shape, bits, g, lv,
                                     rp_ratio)
        assert (want == "pallas") == (not ref_raises)
        assert t_backend.route_fused("auto", "auto", shape, bits, g, lv,
                                     rp_ratio, "cuda") == (
                                         "cuda" if want else None)
        assert t_backend.route_fused("auto", "auto", shape, bits, g, lv,
                                     rp_ratio, "cpu") is None
        assert j_backend.route_fused("auto", "auto", shape, bits, g, lv,
                                     rp_ratio) is None
    with pytest.raises(ValueError):
        t_backend.route_fused("sometimes", "auto", shape, bits, g, lv)


def test_route_rp_takes_every_shape():
    # the reference sends r = 32/64 to jnp on the TPU (128-tile rule); the
    # CUDA kernel masks its edges, so the port routes them to the kernel
    assert j_backend.rp_kernel_unsupported(256, 32) is not None
    assert t_backend.route_rp("auto", "cuda") == "cuda"
    assert t_backend.route_rp("auto", "cpu") == "torch"


@pytest.mark.parametrize("shape", [(677, 256), (301, 512), (64, 256)])
@pytest.mark.parametrize("vm", [False, True])
def test_compress_paper_config_bit_equal(shape, vm):
    """INT2, G=256, RP 8 (the paper's Table-1 config): words, zero and range
    of JAX ``compress(impl="jnp")``.  RP is a float matmul, so its outputs
    can differ in the last bit between the two packages; the codes are
    robust to that except for values exactly at a rounding threshold, which
    these seeded inputs do not hit."""
    x = np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32)
    jcfg = j_comp.CompressionConfig(2, 256, 8, vm=vm)
    tcfg = t_comp.CompressionConfig(2, 256, 8, vm=vm)
    jct = j_comp.compress(jnp.asarray(x), jcfg, 1234, impl="jnp")
    tct = t_comp.compress(torch.from_numpy(x), tcfg, 1234)
    assert tct.cfg.impl == "auto" and tct.packed.device.type == "cpu"
    np.testing.assert_array_equal(tct.packed.numpy(),
                                  np.asarray(jct.packed).view(np.int32))
    np.testing.assert_allclose(tct.zero.numpy(), np.asarray(jct.zero),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tct.rng.numpy(), np.asarray(jct.rng),
                               rtol=1e-6, atol=1e-6)
    assert tct.seed == int(jct.rp_seed)
    assert tct.nbytes == jct.nbytes
    # decompress (dequantize, then IRP): the reference's reconstruction
    np.testing.assert_allclose(t_comp.decompress(tct).numpy(),
                               np.asarray(j_comp.decompress(jct, impl="jnp")),
                               rtol=1e-4, atol=1e-4)


def test_compress_matmul_unfused_spelling():
    x = np.random.default_rng(1).normal(size=(300, 256)).astype(np.float32)
    w = np.random.default_rng(2).normal(size=(256, 16)).astype(np.float32)
    g = np.random.default_rng(3).normal(size=(300, 16)).astype(np.float32)
    cfg = t_comp.CompressionConfig(2, 256, 8, vm=True)
    y, ct = t_comp.compress_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                   cfg, 5)
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=1e-4, atol=1e-4)
    dw = t_comp.decompress_matmul(ct, torch.from_numpy(g))
    np.testing.assert_allclose(
        dw.numpy(), t_comp.decompress(ct).numpy().T @ g, rtol=1e-4,
        atol=1e-4)
    with pytest.raises(ValueError):
        t_comp.compress_matmul(torch.from_numpy(x), torch.from_numpy(w), cfg,
                               5, fused="on")


@pytest.mark.parametrize("vm_dim,rp,want", [(None, 8, 32), (None, 0, 256),
                                            (7, 8, 7)])
def test_cn_dim_and_levels_match_reference(vm_dim, rp, want):
    j = j_comp.CompressionConfig(2, 256, rp, vm=True, vm_dim=vm_dim)
    t = t_comp.CompressionConfig(2, 256, rp, vm=True, vm_dim=vm_dim)
    assert t.cn_dim() == j.cn_dim() == want
    assert t.levels() == j.levels()
    with pytest.raises(ValueError):
        t_comp.CompressionConfig(vm=True, vm_dim=1).cn_dim()
