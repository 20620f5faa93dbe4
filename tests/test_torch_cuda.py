"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip without a CUDA device (as on a CPU-only host) and
import nothing of JAX, so the card's host runs them with
``python -m pytest -q -m gpu tests/test_torch_cuda.py``.  Quantize and
dequantize must be bit-equal; RP/IRP agree to rtol/atol 2e-4 (the kernel
sums two TF32 parts of x times +-1 on the tensor cores, cuBLAS the float32
products, each in its own order), and so does the fused forward's y (three
TF32 products of split x and w); its stash is bit-equal."""
import numpy as np
import pytest
import torch

from repro_torch.core.variance import optimize_levels
from repro_torch.kernels import quant_blockwise as t_qk
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import rp_matmul as t_rk

VM2 = optimize_levels(32, 2)


def _x(n, g, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, g)) * 2.3
            + 0.7).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("n,g,bits", [(37, 256, 2), (1001, 64, 4),
                                      (9, 96, 1), (5, 250, 16)])
def test_cuda_quant_kernels_bit_equal_to_plain(cuda, levels, n, g, bits):
    if levels is not None and bits != 2:
        levels = None
    x = torch.from_numpy(_x(n, g, seed=n)).cuda()
    got = t_qk.quant_pack(x, bits, 42, levels)
    want = t_ref.quantize_packed(x, bits, 42, levels)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    d = t_qk.dequant_unpack(*got, bits, g, levels)
    assert torch.equal(d, t_ref.dequantize_packed(*want, bits, g, levels))


@pytest.mark.gpu
def test_cuda_quant_misaligned_input(cuda):
    """A contiguous view whose start is not 16-byte aligned takes the
    kernel's scalar loads, with the same bits."""
    flat = torch.from_numpy(_x(1, 33 * 256 + 1)).cuda().reshape(-1)
    x = flat[1:].reshape(33, 256)
    got = t_qk.quant_pack(x, 2, 5, VM2)
    for a, b in zip(got, t_ref.quantize_packed(x, 2, 5, VM2)):
        assert torch.equal(a, b)


def _assert_quant_round_trip(x, bits, seed, levels, rows_per_seed=None):
    """quant_pack's words, zero and range and dequant_unpack's values
    bit-equal to the plain version's; returns the kernel's triplet."""
    g = x.shape[1]
    got = t_qk.quant_pack(x, bits, seed, levels, rows_per_seed=rows_per_seed)
    want = t_ref.quantize_packed(x, bits, seed, levels,
                                 rows_per_seed=rows_per_seed)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(t_qk.dequant_unpack(*got, bits, g, levels),
                       t_ref.dequantize_packed(*want, bits, g, levels))
    return got


#: Every shape the quant kernels take on the main path (PERF.md section 6):
#: the RP-8 slice's layers and the rp_ratio-0 slice's fused="off" layer
#: inputs (2 bits, uniform and VM levels), and the KV cache's prefill (one
#: seed a token of 40 blocks), decode step and one decode read: K and V of
#: a page of each of 4 slots (4 bits, uniform).
MAIN_QUANT_SHAPES = {
    **{f"{name}_{lv}": (n, 256, 2, None, lv) for name, n in (
        ("rp8_21168", 21_168), ("rp8_42336", 42_336),
        ("rp0_169343", 169_343), ("rp0_338686", 338_686))
       for lv in ("uniform", "vm")},
    "kv_prefill": (161_280, 64, 4, 40, "uniform"),
    "kv_decode": (160, 64, 4, 40, "uniform"),
    "kv_page": (5_120, 64, 4, None, "uniform")}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(MAIN_QUANT_SHAPES))
def test_cuda_quant_main_path_shapes_bit_equal(cuda, shape):
    from repro_torch.engine.seeds import kv_seed

    n, g, bits, rps, lv = MAIN_QUANT_SHAPES[shape]
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn((n, g), device="cuda", generator=gen) * 1.9 + 0.3
    seed = 1234
    if rps:
        tok = torch.arange(n // rps, device="cuda")
        seed = kv_seed(tok % 1008, tok // 1008, 7, 1)
    _assert_quant_round_trip(x, bits, seed, VM2 if lv == "vm" else None, rps)


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("n,g,bits", [
    (1, 256, 2), (1, 64, 4), (1, 250, 16),     # one block
    (25_357, 256, 2), (100_003, 64, 4),         # past whole sweeps of the
    (8_191, 128, 16), (3_001, 8, 16),           # persistent grid, ragged
    (4_099, 128, 1), (4_099, 64, 1),            # bits 1: vector / scalar
    (2_053, 64, 8), (2_053, 256, 8),            # bits 8
    (517, 250, 16), (517, 32, 16),              # bits 16: scalar / vector
    (300, 512, 2), (77, 96, 4)])                # scalar: G off the vector path
def test_cuda_quant_paths_bit_equal(cuda, levels, n, g, bits):
    """Both paths of both kernels, at counts that are not a multiple of the
    blocks a CTA or the persistent grid takes (VM at 8 bits: the 256-level
    table of the scalar path)."""
    if levels is not None and bits != 2:
        levels = optimize_levels(32, bits) if bits <= 8 else None
    x = torch.from_numpy(_x(n, g, seed=n + bits)).cuda()
    _assert_quant_round_trip(x, bits, 99, levels)


#: Ragged words: G not a multiple of the codes a word holds (Table 1's
#: flickr group sizes at 2 bits, and G = 125 at 1, 4 and 8 bits).
RAGGED = [(125, 2), (250, 2), (500, 2), (1000, 2), (125, 1), (125, 4),
          (125, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("vm", [False, True])
@pytest.mark.parametrize("g,bits", RAGGED)
@pytest.mark.parametrize("n", [1, 37, 4_099])
def test_cuda_quant_ragged_words_bit_equal(cuda, vm, g, bits, n):
    """The scalar path's masked last word: words, zero and range bit-equal
    to the plain version (which pads the codes with zeros), uniform and
    with a VM table of 2**bits levels (256 at 8 bits)."""
    levels = optimize_levels(32, bits) if vm else None
    x = torch.from_numpy(_x(n, g, seed=g * bits + n)).cuda()
    p, _, _ = _assert_quant_round_trip(x, bits, 31, levels)
    assert p.shape == (n, -(-g * bits // 32))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [42_336, 21_168, 517])
def test_cuda_quant_vm8_bit_equal(cuda, n):
    """8-bit VM (a 256-level table in shared memory, searched in eight
    steps) at the autoprec phase's block counts, and after a misaligned
    start."""
    levels = optimize_levels(32, 8)
    gen = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn((n, 256), device="cuda", generator=gen) * 1.9 + 0.3
    _assert_quant_round_trip(x, 8, 1234, levels)
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])
    _assert_quant_round_trip(flat[1:].reshape(n, 256), 8, 77, levels)


@pytest.mark.gpu
def test_cuda_quant_vm8_ties_and_table_edges(cuda):
    """Values exactly on the table's levels and at both of its ends take
    the bin searchsorted(right) gives, as the plain version does."""
    levels = optimize_levels(32, 8)
    lv = torch.tensor(levels, dtype=torch.float32)
    assert float(lv[0]) == 0.0 and float(lv[-1]) == 255.0
    # blocks whose min is 0 and max 255, so h lies on or next to the levels:
    # every level, then the midpoints between neighbours
    mid = (lv[1:] + lv[:-1]) / 2
    x = torch.stack([lv, torch.cat([mid[:254], lv[:1], lv[-1:]])]).cuda()
    _assert_quant_round_trip(x, 8, 5, levels)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_cuda_fused_pair_uniform_widths_bit_equal_stash(cuda, bits):
    """The fused pair at the autoprec widths (uniform levels): the forward's
    stash bit-equal to the plain version and quant_pack, and the backward
    within 1e-4 of |x_hat|^T |g| of the plain version."""
    from repro_torch.kernels import fused_matmul as t_fk

    m, d, g, n = 677, 256, 256, 40
    x = torch.from_numpy(_x(m, d, seed=bits)).cuda()
    w = torch.from_numpy((_x(d, n, seed=d) / 16).astype(np.float32)).cuda()
    y, *stash = t_fk.matmul_quant(x, w, bits, 42, None, group_size=g)
    y_p, *stash_p = t_ref.matmul_quantize_packed(x, w, bits, 42, None,
                                                 group_size=g)
    for a, b, c in zip(stash, stash_p,
                       t_qk.quant_pack(x.reshape(-1, g), bits, 42)):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    gr = torch.from_numpy(_x(m, n, seed=7) / 300).cuda()
    dw = t_fk.dequant_matmul(*stash, gr, bits, g, d)
    dw_p = t_ref.dequant_matmul_packed(*stash_p, gr, bits, g, d)
    x_hat = t_ref.dequantize_packed(*stash_p, bits, g).reshape(-1, d)
    assert bool(((dw - dw_p).abs() <= 1e-4 * (x_hat.abs().T @ gr.abs())
                 + 1e-30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("g,bits,vm", [(125, 2, False), (1000, 2, False),
                                       (256, 8, True), (64, 8, True)])
def test_cuda_route_fused_auto_declines_without_raising(cuda, g, bits, vm):
    """Ragged words and 256-level tables are the quant kernels' alone:
    "auto" runs the two-pass spelling on them (no raise), "on" refuses."""
    from repro_torch.core import backend

    levels = optimize_levels(32, bits) if vm else None
    shape = (1000, 2000 if g == 1000 else 2 * g)
    assert backend.route_quant("auto", bits, g, levels, "cuda") == "cuda"
    assert backend.route_fused("auto", "auto", shape, bits, g, levels, 0,
                               "cuda") is None
    with pytest.raises(ValueError):
        backend.route_fused("on", "auto", shape, bits, g, levels, 0, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("vm", [False, True])
def test_cuda_quant_takes_every_table1_config(cuda, bits, vm):
    """BIT_CHOICES x {uniform, VM} x Table 1's group sizes (both datasets'
    base_r = 2 F / 8 times G/R in 1..64, capped at 4096): route_quant
    raises for none, and both kernels run each bit-equal to the plain
    version."""
    from repro_torch.core import backend

    for base_r in (32, 125):
        for gr in (1, 2, 4, 8, 16, 32, 64):
            g = min(base_r * gr, 4096)
            levels = optimize_levels(32, bits) if vm else None
            assert backend.route_quant("auto", bits, g, levels, "cuda") \
                == "cuda"
            x = torch.from_numpy(_x(9, g, seed=g + bits)).cuda()
            _assert_quant_round_trip(x, bits, g, levels)


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("g,bits", [(256, 2), (64, 4)])
def test_cuda_dequant_misaligned_words(cuda, levels, g, bits):
    """Words whose start is 4 bytes past a 16-byte boundary take the
    scalar unpack, with the same values."""
    x = torch.from_numpy(_x(301, g, seed=g)).cuda()
    p, z, r = t_qk.quant_pack(x, bits, 3, levels)
    flat = torch.empty(p.numel() + 1, dtype=torch.int32, device="cuda")
    flat[1:] = p.reshape(-1)
    p_mis = flat[1:].reshape(p.shape)
    assert p_mis.data_ptr() % 16
    assert torch.equal(t_qk.dequant_unpack(p_mis, z, r, bits, g, levels),
                       t_ref.dequantize_packed(p, z, r, bits, g, levels))


@pytest.mark.gpu
@pytest.mark.parametrize("g,bits", [(256, 2), (64, 4), (250, 16)])
def test_cuda_quant_zero_range_and_denormal_blocks(cuda, g, bits):
    """Constant blocks (range 0, clamped to EPS), blocks of denormals and
    of a denormal spread on a large offset, beside ordinary blocks."""
    x = _x(64, g, seed=5)
    x[1] = 3.25
    x[2] = 0.0
    tiny = np.random.default_rng(6).integers(1, 2**23, size=(3, g))
    x[3:6] = tiny.astype(np.uint32).view(np.float32)   # positive denormals
    x[6] = -x[3]
    x[7] = np.float32(1e-38) + x[4]
    x[8, ::2] = np.float32(-0.0)
    x[8, 1::2] = np.float32(0.0)
    for levels in (None, VM2 if bits == 2 else None):
        _assert_quant_round_trip(torch.from_numpy(x).cuda(), bits, 17, levels)


@pytest.mark.gpu
@pytest.mark.parametrize("n,g,bits,rps", [(42_336, 256, 2, None),
                                          (161_280, 64, 4, 40),
                                          (301, 250, 16, None)])
def test_cuda_quant_bit_identical_repeat(cuda, n, g, bits, rps):
    from repro_torch.engine.seeds import kv_seed

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((n, g), device="cuda", generator=gen)
    seed = 8
    if rps:
        seed = kv_seed(torch.arange(n // rps, device="cuda"), 0, 3, 0)
    a = t_qk.quant_pack(x, bits, seed, rows_per_seed=rps)
    b = t_qk.quant_pack(x, bits, seed, rows_per_seed=rps)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert torch.equal(t_qk.dequant_unpack(*a, bits, g),
                       t_qk.dequant_unpack(*b, bits, g))


@pytest.mark.gpu
def test_cuda_quant_lanes_per_block_is_the_kernels(cuda):
    """The Python rule of the vector path (what the CPU layout test
    mirrors) is the one the library applies."""
    lib = t_qk._lib()
    for g in (4, 8, 16, 32, 64, 96, 128, 250, 256, 512, 1024):
        for bits in (1, 2, 4, 8, 16):
            assert lib.quant_lanes_per_block(g, bits) == \
                t_qk.lanes_per_block(g, bits), (g, bits)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,r", [(677, 256, 32), (130, 512, 64),
                                   (33, 40, 5), (300, 24, 8)])
def test_cuda_rp_kernels_match_plain(cuda, m, d, r):
    x = torch.from_numpy(_x(m, d)).cuda()
    y = t_rk.rp_project(x, 7, r)
    torch.testing.assert_close(y, t_ref.rp_project(x, 7, r), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(t_rk.irp_project(y, 7, d),
                               t_ref.irp_project(y, 7, d), rtol=2e-4,
                               atol=2e-4)


def _rp_case(case):
    """(x for RP, d, r) for each path of the RP kernel that the main path's
    shapes do not take."""
    if case == "misaligned":      # base 4 bytes past a 16-byte boundary
        flat = torch.from_numpy(_x(1, 300 * 256 + 1)).cuda().reshape(-1)
        return flat[1:].reshape(300, 256), 256, 32
    if case == "k_mod_4":         # K = 130 (RP), 70 (IRP): 4-byte copies
        return torch.from_numpy(_x(300, 130)).cuda(), 130, 70
    if case == "ragged_m":        # 2 row tiles of 128 and 1 row
        return torch.from_numpy(_x(257, 512)).cuda(), 512, 64
    # K = 2100 > 2048 at 64 columns (and 4300 > 4096 at 32): the signs are
    # hashed in windows of K.  x is zero except in 64 columns of each
    # window, so the sum rounds as a K = 128 product while its signs come
    # from both windows.  For IRP, N = 4300 is 68 chunks of 64 columns:
    # more than a sign table holds, so several slabs on blockIdx.y.
    m, d, r, starts = ((129, 2100, 40, (100, 2030)) if case == "k_windows"
                       else (6, 4300, 20, (100, 4200)))
    x = torch.zeros((m, d), device="cuda")
    for k0 in starts:
        x[:, k0:k0 + 64] = torch.from_numpy(_x(m, 64, seed=k0)).cuda()
    return x, d, r


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["misaligned", "k_mod_4", "ragged_m",
                                  "k_windows", "n_slabs"])
def test_cuda_rp_kernel_paths_match_plain(cuda, case):
    x, d, r = _rp_case(case)
    y = t_rk.rp_project(x, 11, r)
    torch.testing.assert_close(y, t_ref.rp_project(x, 11, r), rtol=2e-4,
                               atol=2e-4)
    if case == "misaligned":
        flat = torch.empty(y.numel() + 1, device="cuda")
        flat[1:] = y.reshape(-1)
        y = flat[1:].reshape(y.shape)
    torch.testing.assert_close(t_rk.irp_project(y, 11, d),
                               t_ref.irp_project(y, 11, d), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,r", [(1000, 512, 64), (677, 256, 32)])
def test_cuda_rp_kernels_bit_identical_repeat(cuda, m, d, r):
    """Each output is summed by one warp in a fixed order: two calls give
    the same bits."""
    x = torch.from_numpy(_x(m, d, seed=3)).cuda()
    y = t_rk.rp_project(x, 5, r)
    assert torch.equal(y, t_rk.rp_project(x, 5, r))
    assert torch.equal(t_rk.irp_project(y, 5, d), t_rk.irp_project(y, 5, d))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["sage", "gcn"])
def test_cuda_training_matches_cpu(cuda, arch):
    """Three epochs through the kernels against the plain path on the CPU,
    from the same weights: rtol 1e-3 (summation order differs, and a
    last-ulp difference can flip a rare SR code)."""
    from repro_torch.core.compressor import CompressionConfig
    from repro_torch.graph.data import arxiv_like
    from repro_torch.graph.models import GNN, GNNConfig
    from repro_torch.graph.train import train_gnn

    g = arxiv_like(scale=0.004)
    cfg = GNNConfig(arch=arch, hidden=(64, 64), n_classes=40,
                    compression=CompressionConfig(2, 256, 8, vm=True))
    model = GNN(cfg, g.n_feats, generator=torch.Generator().manual_seed(0))
    before = t_qk.quant_pack.launches
    on_card = train_gnn(g, cfg, n_epochs=3, params=model, impl="cuda")
    on_cpu = train_gnn(g, cfg, n_epochs=3, params=model, device="cpu")
    assert t_qk.quant_pack.launches == before + 9
    np.testing.assert_allclose([h[1] for h in on_card["history"]],
                               [h[1] for h in on_cpu["history"]], rtol=1e-3)


FUSED_SHAPES = [(96, 64, 64, 48), (9, 64, 64, 48), (10, 32, 64, 48),
                (100, 64, 32, 48), (677, 512, 256, 40), (678, 128, 256, 256),
                (5000, 256, 256, 40), (6, 2048, 1024, 48), (99, 96, 288, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("m,d,g,n", FUSED_SHAPES)
def test_cuda_matmul_quant_matches_plain_and_quant_pack(cuda, levels, m, d,
                                                        g, n):
    """The fused forward's stash triplet is bit-equal to the plain version
    and to the quant_pack kernel on the same x; y is within 2e-4 of the
    cuBLAS product (the RP kernel's band: another summation order)."""
    from repro_torch.kernels import fused_matmul as t_fk

    x = torch.from_numpy(_x(m, d, seed=m)).cuda()
    w = torch.from_numpy(
        (_x(d, n, seed=d) / np.sqrt(d)).astype(np.float32)).cuda()
    before = t_fk.matmul_quant.launches
    y, *stash = t_fk.matmul_quant(x, w, 2, 42, levels, group_size=g)
    assert t_fk.matmul_quant.launches == before + 1
    y_p, *stash_p = t_ref.matmul_quantize_packed(x, w, 2, 42, levels,
                                                 group_size=g)
    stash_q = t_qk.quant_pack(x.reshape(-1, g), 2, 42, levels)
    for a, b, c in zip(stash, stash_p, stash_q):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)


#: (m, d, g, n) for each path of the tensor-core forward: D % 8 != 0 and
#: D % 4 != 0 (4-byte copies of x; blocks spanning rows, copied back from
#: device memory), N below 8 and N odd (4-byte copies of w, scalar stores),
#: M not a multiple of the 64-row tile, every column width the kernel is
#: instantiated for (40, 64, 256, and slabs of 256 beyond) at and below
#: its full width,
#: chunks of whole blocks of unequal width (D = 288, G = 96), a block larger
#: than the chunk buffer, and slabs with blocks spanning rows.
FUSED_PATHS = {"d_mod_8": (36, 20, 80, 40), "d_mod_4": (40, 10, 80, 40),
               "n_below_8": (100, 64, 64, 5), "n_odd": (100, 64, 64, 43),
               "ragged_m": (130, 128, 128, 256), "n16": (200, 64, 64, 16),
               "n40": (200, 64, 64, 40), "n64": (200, 64, 64, 64),
               "n128": (200, 64, 64, 128), "n256": (200, 64, 64, 256),
               "n520_slabs": (150, 64, 64, 520),
               "chunks_192_96": (70, 288, 96, 40),
               "huge_block": (1024, 8, 4096, 8),
               "slabs_spanning": (129, 96, 288, 520)}


def _check_matmul_quant(t_fk, x, w, g, levels):
    """The stash bit-equal to the plain version and to quant_pack, y within
    2e-4 of the plain version; returns the kernel's outputs."""
    got = t_fk.matmul_quant(x, w, 2, 42, levels, group_size=g)
    y_p, *stash_p = t_ref.matmul_quantize_packed(x, w, 2, 42, levels,
                                                 group_size=g)
    stash_q = t_qk.quant_pack(x.reshape(-1, g), 2, 42, levels)
    for a, b, c in zip(got[1:], stash_p, stash_q):
        assert torch.equal(a, b) and torch.equal(a, c)
    torch.testing.assert_close(got[0], y_p, rtol=2e-4, atol=2e-4)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("case", sorted(FUSED_PATHS))
def test_cuda_matmul_quant_kernel_paths(cuda, levels, case):
    from repro_torch.kernels import fused_matmul as t_fk

    m, d, g, n = FUSED_PATHS[case]
    x = torch.from_numpy(_x(m, d, seed=m + d)).cuda()
    w = torch.from_numpy(
        (_x(d, n, seed=n) / np.sqrt(d)).astype(np.float32)).cuda()
    _check_matmul_quant(t_fk, x, w, g, levels)


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
def test_cuda_matmul_quant_misaligned_inputs(cuda, levels):
    """x and w views starting 4 bytes past a 16-byte boundary take the
    4-byte copies, with the same bits in the stash."""
    from repro_torch.kernels import fused_matmul as t_fk

    m, d, g, n = 300, 256, 256, 256
    flat_x = torch.from_numpy(_x(1, m * d + 1, seed=5)).cuda().reshape(-1)
    flat_w = torch.from_numpy(
        (_x(1, d * n + 1, seed=6) / np.sqrt(d)).astype(np.float32)).cuda()
    x = flat_x[1:].reshape(m, d)
    w = flat_w.reshape(-1)[1:].reshape(d, n)
    _check_matmul_quant(t_fk, x, w, g, levels)


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(256, 256), (512, 256), (512, 40)])
def test_cuda_matmul_quant_bit_identical_repeat(cuda, d, n):
    """Each output is summed by one warp in a fixed order and the stash is
    written once: two calls at the slice's layer widths give the same bits
    in y and in the stash."""
    from repro_torch.kernels import fused_matmul as t_fk

    x = torch.from_numpy(_x(3000, d, seed=d + n)).cuda() * 1.7
    w = torch.from_numpy(
        (_x(d, n, seed=n) / np.sqrt(d)).astype(np.float32)).cuda()
    first = _check_matmul_quant(t_fk, x, w, 256, VM2)
    again = t_fk.matmul_quant(x, w, 2, 42, VM2, group_size=256)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def _check_dequant_matmul(t_fk, packed, zero, rng, gr, bits, g, d, levels):
    """dw within 1e-4 * (|x_hat|^T |g|) of the plain version and two calls
    bit-identical; returns dw."""
    dw = t_fk.dequant_matmul(packed, zero, rng, gr, bits, g, d, levels)
    again = t_fk.dequant_matmul(packed, zero, rng, gr, bits, g, d, levels)
    assert torch.equal(dw, again)
    x_hat = t_ref.dequantize_packed(packed, zero, rng, bits, g,
                                    levels).reshape(-1, d)
    want = t_ref.dequant_matmul_packed(packed, zero, rng, gr, bits, g, d,
                                       levels)
    scale = x_hat.abs().T @ gr.abs()
    assert bool(((dw - want).abs() <= 1e-4 * scale + 1e-30).all())
    return dw


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("m,d,g,n", FUSED_SHAPES)
def test_cuda_dequant_matmul_matches_plain(cuda, levels, m, d, g, n):
    """|dw_kernel - dw_plain| <= 1e-4 * (|x_hat|^T |g|) elementwise (the
    row sum is long and its order differs), and two calls give the same
    bits (fixed row ranges, fixed-order tree, no atomics)."""
    from repro_torch.kernels import fused_matmul as t_fk

    x = torch.from_numpy(_x(m, d, seed=m)).cuda()
    gr = torch.from_numpy(_x(m, n, seed=n)).cuda()
    packed, zero, rng = t_qk.quant_pack(x.reshape(-1, g), 2, 42, levels)
    _check_dequant_matmul(t_fk, packed, zero, rng, gr, 2, g, d, levels)


#: (m, d, g, n, bits) for each path of the tensor-core backward: every
#: column width it is instantiated for (40, 64, 256) at and below its full
#: width (48, odd 43, below 8), slabs of 256 beyond, M just past a row step
#: of 64 or 32 rows (a one-row last range), blocks spanning rows
#: (G % D == 0), D not a multiple of the 64- or 128-row tile, and blocks
#: shorter than a thread's run of 8 columns (G = 4 at 8 bits).
DEQUANT_PATHS = {"n40": (1000, 512, 256, 40, 2),
                 "n48": (1000, 256, 256, 48, 2),
                 "n256": (1000, 256, 256, 256, 2),
                 "n_odd": (300, 64, 64, 43, 2),
                 "n_below_8": (300, 64, 64, 5, 2),
                 "n520_slabs": (150, 64, 64, 520, 2),
                 "m_past_step": (65, 256, 256, 64, 2),
                 "m_past_step_n256": (33, 256, 256, 256, 2),
                 "spanning_rows": (136, 32, 256, 40, 2),
                 "d_ragged": (100, 96, 96, 256, 2),
                 "short_blocks": (200, 64, 4, 40, 8)}


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("case", sorted(DEQUANT_PATHS))
def test_cuda_dequant_matmul_kernel_paths(cuda, levels, case):
    from repro_torch.kernels import fused_matmul as t_fk

    m, d, g, n, bits = DEQUANT_PATHS[case]
    lv = levels if bits == 2 else None
    x = torch.from_numpy(_x(m, d, seed=m + d)).cuda()
    gr = torch.from_numpy(_x(m, n, seed=n)).cuda()
    packed, zero, rng = t_qk.quant_pack(x.reshape(-1, g), bits, 42, lv)
    _check_dequant_matmul(t_fk, packed, zero, rng, gr, bits, g, d, lv)


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
def test_cuda_dequant_matmul_misaligned_gradient(cuda, levels):
    """A gradient view starting 4 bytes past a 16-byte boundary takes the
    4-byte copies."""
    from repro_torch.kernels import fused_matmul as t_fk

    m, d, g, n = 300, 256, 256, 256
    x = torch.from_numpy(_x(m, d, seed=8)).cuda()
    flat = torch.from_numpy(_x(1, m * n + 1, seed=7)).cuda().reshape(-1)
    gr = flat[1:].reshape(m, n)
    packed, zero, rng = t_qk.quant_pack(x.reshape(-1, g), 2, 42, levels)
    _check_dequant_matmul(t_fk, packed, zero, rng, gr, 2, g, d, levels)


@pytest.mark.gpu
def test_cuda_dequant_matmul_tile_is_the_wrappers(cuda):
    """The kernel launches, for each configuration index, the tile the
    wrapper sizes the row ranges and the scratch for (and the fixed
    rule's index for n picks the same tile); an unknown index is -1."""
    import ctypes

    from repro_torch.kernels import fused_matmul as t_fk

    got = (ctypes.c_int * 3)()
    for config in range(len(t_fk.TILES)):
        t_fk._lib().dequant_matmul_tile(config, got)
        assert tuple(got) == t_fk.TILES[config]
    for n in (1, 5, 40, 41, 48, 64, 65, 256, 520):
        t_fk._lib().dequant_matmul_tile(t_fk.tile_index(n), got)
        assert tuple(got) == t_fk.tile(n)
    t_fk._lib().dequant_matmul_tile(len(t_fk.TILES), got)
    assert tuple(got) == (-1, -1, -1)


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("m,d,n", [(4096, 256, 40), (4096, 512, 64),
                                   (2000, 256, 256), (700, 96, 300)])
def test_cuda_fused_pair_every_configuration(cuda, levels, m, d, n):
    """Each compiled configuration of the forward and each tile of the
    backward (at the fixed rule's split count and at S = 1 and 5) runs
    on any n: the forward's stash bit-equal to quant_pack and y within
    2e-4 of the plain product, dw within the backward's band; an index
    the library lacks raises."""
    from repro_torch.kernels import fused_matmul as t_fk

    g = 256 if d % 256 == 0 else d
    x = torch.from_numpy(_x(m, d, seed=m + n)).cuda()
    w = torch.from_numpy(
        (_x(d, n, seed=n) / np.sqrt(d)).astype(np.float32)).cuda()
    gr = torch.from_numpy(_x(m, n, seed=d)).cuda()
    stash_q = t_qk.quant_pack(x.reshape(-1, g), 2, 42, levels)
    y_p = t_ref.matmul_quantize_packed(x, w, 2, 42, levels,
                                       group_size=g)[0]
    for config in range(len(t_fk.FWD_CONFIGS)):
        y, *stash = t_fk.matmul_quant(x, w, 2, 42, levels, group_size=g,
                                      config=config)
        assert all(torch.equal(a, b) for a, b in zip(stash, stash_q))
        torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    want = t_ref.dequant_matmul_packed(*stash_q, gr, 2, g, d, levels)
    x_hat = t_ref.dequantize_packed(*stash_q, 2, g, levels).reshape(-1, d)
    scale = x_hat.abs().T @ gr.abs()
    for config in range(len(t_fk.TILES)):
        for s in (None, 1, 5):
            dw = t_fk.dequant_matmul(*stash_q, gr, 2, g, d, levels,
                                     config=config,
                                     n_splits=s or t_fk.splits(
                                         m, d, n, config)[0])
            assert bool(((dw - want).abs() <= 1e-4 * scale + 1e-30).all())
    with pytest.raises(ValueError, match="no compiled"):
        t_fk.matmul_quant(x, w, 2, 42, levels, group_size=g, config=3)
    with pytest.raises(ValueError, match="no compiled"):
        t_fk.dequant_matmul(*stash_q, gr, 2, g, d, levels, config=3,
                            n_splits=1)


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("n,g,bits,row0", [(37, 256, 2, 11), (1001, 64, 4, 3),
                                           (9, 96, 1, 5),
                                           (20_480, 256, 2, 20_480)])
def test_cuda_quant_pack_offset_bit_equal_to_plain(cuda, levels, n, g, bits,
                                                   row0):
    """A shard's rows quantized with their global block offset: the
    kernel's words, zero and range are the plain version's with the same
    offset, and the rows of the unsharded call (vector and scalar
    paths)."""
    if levels is not None and bits != 2:
        levels = None
    x = torch.from_numpy(_x(row0 + n, g, seed=n)).cuda()
    got = t_qk.quant_pack(x[row0:], bits, 42, levels, row0=row0)
    want = t_ref.quantize_packed(x[row0:], bits, 42, levels, row0=row0)
    whole = t_qk.quant_pack(x, bits, 42, levels)
    for a, b, c in zip(got, want, whole):
        assert torch.equal(a, b) and torch.equal(a, c[row0:])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,cols,split,g,bits", [(64, 1024, 2, 256, 8),
                                                    (33, 768, 3, 64, 2),
                                                    (8, 4000, 4, 125, 8)])
def test_cuda_quant_pack_block_stride_bit_equal_to_plain(cuda, rows, cols,
                                                         split, g, bits):
    """A column split's shard (each of ``split`` ranks' columns of a
    (rows, cols) moment in blocks of ``g``): the kernel with the shard's
    ``row0`` and ``block_stride`` gives the plain version's words, zero
    and range, and the unsharded call's blocks (vector and scalar
    paths)."""
    x = torch.from_numpy(_x(rows, cols, seed=cols)).cuda()
    whole = t_qk.quant_pack(x.reshape(-1, g), bits, 9)
    local, per_row = cols // split, cols // g
    for r in range(split):
        part = x[:, r * local:(r + 1) * local].reshape(-1, g)
        off = dict(row0=r * local // g, block_stride=(local // g, per_row))
        got = t_qk.quant_pack(part.contiguous(), bits, 9, **off)
        want = t_ref.quantize_packed(part.contiguous(), bits, 9, **off)
        blocks = (torch.arange(rows)[:, None] * per_row + r * local // g
                  + torch.arange(local // g)[None, :]).reshape(-1).cuda()
        for a, b, c in zip(got, want, whole):
            assert torch.equal(a, b) and torch.equal(a, c[blocks])


@pytest.mark.gpu
@pytest.mark.parametrize("levels", [None, VM2], ids=["uniform", "vm"])
@pytest.mark.parametrize("m,d,n", [(4096, 256, 64), (4096, 256, 256),
                                   (4096, 512, 256), (4096, 512, 40),
                                   (169_343, 256, 256), (169_343, 512, 256),
                                   (169_343, 512, 40)])
def test_cuda_dequant_matmul_aligned_errors_in_band(cuda, levels, m, d, n):
    """Identical stash rows and identical non-negative g rows, so no
    rounding error cancels (the split's, the tensor cores' truncating
    steps, the float32 sums): dw within 1e-4 * (|x_hat|^T |g|) of the exact
    product of x_hat and g (float64), also at the slice's 169,343 rows,
    whose row ranges (splits()) are the longest sums.  One bf16 pass, a
    split of one operand alone, or one truncating chain along a range
    would leave it (tests/test_torch_dequant_split.py)."""
    from repro_torch.kernels import fused_matmul as t_fk

    g = 256
    x = torch.from_numpy(_x(1, d, seed=d)).cuda()
    packed, zero, rng = t_qk.quant_pack(x.reshape(-1, g), 2, 42, levels)
    packed, zero, rng = packed.repeat(m, 1), zero.repeat(m), rng.repeat(m)
    gr = torch.from_numpy(np.abs(_x(1, n, seed=n))).cuda().repeat(m, 1)
    dw = t_fk.dequant_matmul(packed, zero, rng, gr, 2, g, d, levels)
    x_hat = t_ref.dequantize_packed(packed, zero, rng, 2, g,
                                    levels).reshape(m, d).double()
    exact = x_hat.T @ gr.double()
    scale = x_hat.abs().T @ gr.double().abs()
    excess = float(((dw.double() - exact).abs() / (1e-4 * scale)).max())
    assert excess <= 1.0, f"aligned errors {excess} of the band"


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(256, 256), (512, 256), (512, 40)])
def test_cuda_dequant_matmul_bit_identical_repeat(cuda, d, n):
    """Fixed row ranges, each output summed by one warp in a fixed order,
    the fixed-order tree, no atomics: two calls at the slice's layer widths
    give the same bits (over 16 to 64 ranges)."""
    from repro_torch.kernels import fused_matmul as t_fk

    m, g = 20000, 256
    x = torch.from_numpy(_x(m, d, seed=d + n)).cuda() * 1.7
    gr = torch.from_numpy(_x(m, n, seed=n)).cuda() / 400
    packed, zero, rng = t_qk.quant_pack(x.reshape(-1, g), 2, 42, VM2)
    assert t_fk.splits(m, d, n)[0] > 1
    _check_dequant_matmul(t_fk, packed, zero, rng, gr, 2, g, d, VM2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,hidden,g,fused_layers",
                         [("sage", (128, 128), 256, 3),
                          ("gcn", (256, 256), 256, 2),
                          ("sage", (1024, 1024), 1024, 2)])
def test_cuda_fused_training_matches_cpu(cuda, arch, hidden, g,
                                         fused_layers):
    """rp_ratio 0, fused="auto": every eligible layer runs the fused pair
    on the card, within rtol 1e-3 of the CPU plain path.  GCN's layer 0
    (677 x 128, G=256) and SAGE's layer 0 at G=1024 (677 x 256) are not
    whole blocks and take the quant kernels; SAGE's 677 x 2048 layers at
    G=1024 fuse."""
    from repro_torch.core.compressor import CompressionConfig
    from repro_torch.graph.data import arxiv_like
    from repro_torch.graph.models import GNN, GNNConfig
    from repro_torch.graph.train import train_gnn
    from repro_torch.kernels import fused_matmul as t_fk

    graph = arxiv_like(scale=0.004)
    cfg = GNNConfig(arch=arch, hidden=hidden, n_classes=40,
                    compression=CompressionConfig(2, g, 0, vm=True))
    model = GNN(cfg, graph.n_feats,
                generator=torch.Generator().manual_seed(0))
    counts = lambda: (t_fk.matmul_quant.launches,
                      t_fk.dequant_matmul.launches, t_qk.quant_pack.launches)
    before = counts()
    on_card = train_gnn(graph, cfg, n_epochs=3, params=model)
    after = counts()
    assert [a - b for a, b in zip(after, before)] == [
        3 * fused_layers, 3 * fused_layers, 3 * (3 - fused_layers)]
    on_cpu = train_gnn(graph, cfg, n_epochs=3, params=model, device="cpu")
    np.testing.assert_allclose([h[1] for h in on_card["history"]],
                               [h[1] for h in on_cpu["history"]], rtol=1e-3)
    assert on_card["stash_bytes"] == on_cpu["stash_bytes"]


# ------------------------------------------------------------ flash (B.6)
def _qkv(bh, sq, skv, dh, dtype, seed=0):
    r = np.random.default_rng(seed)
    mk = lambda s: torch.from_numpy(r.normal(size=(bh, s, dh)).astype(
        np.float32)).to(dtype).cuda()
    return mk(sq), mk(skv), mk(skv)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv,dh,causal", [
    (4, 256, 256, 64, True), (2, 256, 512, 64, False),
    (2, 128, 128, 128, True), (1, 512, 256, 64, False),
    (3, 77, 77, 16, True), (2, 100, 37, 32, False)])
def test_cuda_flash_matches_plain_f32(cuda, bh, sq, skv, dh, causal):
    """The reference flash test's shapes (and ragged ones, d_head 16/32):
    within its 3e-5 band, both scale orders."""
    from repro_torch.kernels import flash_attention as t_fa

    q, k, v = _qkv(bh, sq, skv, dh, torch.float32, seed=sq + skv)
    for scale_q in (False, True):
        before = t_fa.flash_attention.launches
        got = t_fa.flash_attention(q, k, v, causal=causal, scale_q=scale_q)
        assert t_fa.flash_attention.launches == before + 1
        want = t_ref.flash_attention(q, k, v, causal=causal, scale_q=scale_q)
        torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv,dh", [(2, 128, 128, 64),
                                          (80, 1000, 1000, 128)])
def test_cuda_flash_matches_plain_bf16(cuda, bh, sq, skv, dh):
    """bf16 in and out, float32 inside: within one bf16 ulp of the plain
    version (2**-7 relative; an output may round to the other neighbouring
    bf16 value), 1e-3 absolute near zero."""
    from repro_torch.kernels import flash_attention as t_fa

    q, k, v = _qkv(bh, sq, skv, dh, torch.bfloat16, seed=dh)
    got = t_fa.flash_attention(q, k, v, causal=True, scale_q=True)
    assert got.dtype == torch.bfloat16
    want = t_ref.flash_attention(q, k, v, causal=True, scale_q=True)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                               rtol=2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (3e-5, 3e-5)),
                                       (torch.bfloat16, (1e-3, 2.0 ** -7))])
def test_cuda_flash_offset_and_kv_len(cuda, dtype, tol):
    """Ragged Sq != Skv with q_offset (a chunk of a longer prompt) and
    kv_len (a padded cache), causal and full."""
    from repro_torch.kernels import flash_attention as t_fa

    q, k, v = _qkv(6, 70, 200, 128, dtype, seed=3)
    for causal, q_offset, kv_len in ((True, 130, 200), (True, 100, 150),
                                     (False, 0, 131), (True, 0, 1)):
        got = t_fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len, scale_q=True)
        want = t_ref.flash_attention(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     scale_q=True)
        torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                                   rtol=tol[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,skv,causal,q_offset,kv_len", [
    (77, 141, True, 64, None),      # ragged, a chunk of a longer prompt
    (100, 130, False, 0, 97),       # ragged, a padded cache
    (192, 192, True, 0, 150)])      # whole tiles, kv_len < Skv
def test_cuda_flash_bf16_tensor_core_cases(cuda, dh, sq, skv, causal,
                                           q_offset, kv_len):
    """The bf16 tensor-core kernel at every d_head, Sq and Skv not multiples
    of its 64-row tiles, kv_len < Skv: within one bf16 ulp of the plain
    version in both scale orders (the kernel scales the scores in both)."""
    from repro_torch.kernels import flash_attention as t_fa

    q, k, v = _qkv(3, sq, skv, dh, torch.bfloat16, seed=dh + sq)
    for scale_q in (True, False):
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len,
                  scale_q=scale_q)
        got = t_fa.flash_attention(q, k, v, **kw)
        want = t_ref.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(got.float(), want.float(), atol=1e-3,
                                   rtol=2.0 ** -7)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_bit_identical_repeat(cuda, dtype):
    """No atomics and a fixed order of sums: two calls give the same bits."""
    from repro_torch.kernels import flash_attention as t_fa

    q, k, v = _qkv(8, 300, 300, 128, dtype, seed=11)
    for causal in (True, False):
        assert torch.equal(t_fa.flash_attention(q, k, v, causal=causal),
                           t_fa.flash_attention(q, k, v, causal=causal))


@pytest.mark.gpu
def test_cuda_flash_bf16_misaligned_inputs(cuda):
    """Contiguous views whose start is not 16-byte aligned take the bf16
    kernel's plain loads instead of cp.async, with the same bits."""
    from repro_torch.kernels import flash_attention as t_fa

    q, k, v = _qkv(2, 90, 90, 64, torch.bfloat16, seed=4)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        flat[1:] = t.reshape(-1)
        return flat[1:].reshape(t.shape)

    assert torch.equal(
        t_fa.flash_attention(shifted(q), shifted(k), shifted(v)),
        t_fa.flash_attention(q, k, v))


@pytest.mark.gpu
def test_cuda_flash_refuses_what_it_cannot_run(cuda):
    from repro_torch.kernels import flash_attention as t_fa

    q, k, v = _qkv(2, 16, 16, 48, torch.float32)
    with pytest.raises(ValueError, match="d_head"):
        t_fa.flash_attention(q, k, v)
    q, k, v = _qkv(2, 16, 16, 64, torch.float32)
    with pytest.raises(ValueError, match="one dtype"):
        t_fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="kv_len"):
        t_fa.flash_attention(q, k, v, kv_len=0)


@pytest.mark.gpu
def test_cuda_online_attention_matches_cpu(cuda):
    """The model's prefill attention on the card (kernel) against the CPU
    (plain version), GQA-expanded, bf16: within 3e-2."""
    from repro_torch.models.attention import online_attention

    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.normal(size=(2, 90, 8, 64)).astype(
        np.float32)).bfloat16() for _ in range(3))
    got = online_attention(q.cuda(), k.cuda(), v.cuda(), causal=True)
    want = online_attention(q, k, v, causal=True)
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=3e-2,
                               rtol=3e-2)


# ------------------------------------------- seeded quant_pack (KV cache)
@pytest.mark.gpu
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_cuda_seeded_quant_pack_bit_equal_to_plain(cuda, bits):
    """One seed per token (run of rows), counters restarting per token:
    words, zero and range bit-equal to the plain version."""
    from repro_torch.engine.seeds import kv_seed

    nbt, g, n_tok = 40, 64, 37
    x = torch.from_numpy(_x(n_tok * nbt, g, seed=bits)).cuda()
    seeds = kv_seed(torch.arange(n_tok, device="cuda") + 2**31 - 5, 3, 39, 1)
    before = t_qk.quant_pack.launches
    got = t_qk.quant_pack(x, bits, seeds, rows_per_seed=nbt)
    assert t_qk.quant_pack.launches == before + 1
    want = t_ref.quantize_packed(x.cpu(), bits, seeds.cpu(),
                                 rows_per_seed=nbt)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_cuda_one_seed_table_equals_the_plain_seed(cuda):
    """A table of one seed over every row is the one-seed kernel: the
    null-table path keeps its bits."""
    x = torch.from_numpy(_x(301, 256, seed=9)).cuda()
    table = torch.tensor([2**32 - 3], device="cuda")
    got = t_qk.quant_pack(x, 2, table, VM2, rows_per_seed=301)
    plain = t_qk.quant_pack(x, 2, 2**32 - 3, VM2)
    want = t_ref.quantize_packed(x, 2, 2**32 - 3, VM2)
    for a, b, c in zip(got, plain, want):
        assert torch.equal(a, b) and torch.equal(b, c)


# ------------------------------------------------------------- serving
@pytest.mark.gpu
def test_cuda_serving_matches_cpu(cuda):
    """The smoke-size engine (float32 activations, 8-bit KV) on the card
    against the CPU from the same weights: greedy tokens equal, logits
    within 2e-3 (cuBLAS and the CPU sum in other orders, and a last-ulp
    difference in K or V can move an 8-bit SR code by one level)."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.models import Model
    from repro_torch.serving import KVCacheConfig, Request, ServeEngine

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen1.5-4b"]),
                              act_mode="none", act_dtype="float32")
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 40))
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(copy.deepcopy(model).to(dev),
                          kv=KVCacheConfig(bits=8, page_tokens=16,
                                           n_pages=12),
                          max_batch=2, max_prompt=40, gen_cap=8,
                          collect_logits=True)
        before = t_fa.flash_attention.launches
        outs[dev] = eng.run([Request(rid=i, prompt=prompts[i], max_new=8)
                             for i in range(3)])
        launched = t_fa.flash_attention.launches - before
        assert launched == (4 if dev == "cuda" else 0)   # 2 groups x 2 layers
    for a, b in zip(outs["cuda"]["results"], outs["cpu"]["results"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for rid in range(3):
        np.testing.assert_allclose(outs["cuda"]["logits"][rid],
                                   outs["cpu"]["logits"][rid], atol=2e-3)


@pytest.mark.gpu
def test_cuda_moe_ffn_matches_cpu(cuda):
    """``moe_ffn`` on the card against the CPU from the same weights, bf16
    activations and experts at a small width: the routing (idx, keep,
    slot) equal, with dropped pairs, and y within 2**-5 absolute + 2**-6
    relative (each device rounds the three bf16 products its own way)."""
    import types

    from repro_torch.models import moe

    rng = np.random.default_rng(21)
    e, k, d, f = 16, 4, 256, 128
    x = torch.from_numpy(rng.normal(size=(2, 64, d)).astype(np.float32))
    w = {"router": rng.normal(size=(d, e)) * 0.1,
         "w_gate": rng.normal(size=(e, d, f)) / d ** 0.5,
         "w_up": rng.normal(size=(e, d, f)) / d ** 0.5,
         "w_down": rng.normal(size=(e, f, d)) / f ** 0.5}
    w = {n: torch.from_numpy(a.astype(np.float32)) for n, a in w.items()}
    for n in ("w_gate", "w_up", "w_down"):
        w[n] = w[n].to(torch.bfloat16)
    x = x.to(torch.bfloat16)
    out = {}
    for dev in ("cpu", "cuda"):
        p = types.SimpleNamespace(**{n: t.to(dev) for n, t in w.items()})
        xd = x.to(dev)
        c = moe.capacity(64, e, k, 0.5)
        r = moe.route(moe.router_probs(xd, p.router), k, c)
        y, aux = moe.moe_ffn(xd, p, n_experts=e, top_k=k,
                             capacity_factor=0.5)
        out[dev] = ({key: r[key].cpu() for key in ("idx", "keep", "slot")},
                    y.float().cpu(), float(aux))
    for key in ("idx", "keep", "slot"):
        assert torch.equal(out["cuda"][0][key], out["cpu"][0][key]), key
    assert not out["cpu"][0]["keep"].all()
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1],
                               atol=2.0 ** -5, rtol=2.0 ** -6)
    assert abs(out["cuda"][2] - out["cpu"][2]) <= 1e-5 * out["cpu"][2]


@pytest.mark.gpu
def test_cuda_moe_serving_matches_cpu(cuda):
    """The smoke-size qwen3-moe engine (2 layers, float32 activations,
    8-bit KV) on the card against the CPU from the same weights: greedy
    tokens equal, logits within 2e-3 (as the dense engine's test), the
    flash kernel launched once a layer and group."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.models import Model
    from repro_torch.serving import KVCacheConfig, Request, ServeEngine

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-moe-235b-a22b"]),
                              act_mode="none", act_dtype="float32")
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (3, 40))
    outs = {}
    for dev in ("cuda", "cpu"):
        eng = ServeEngine(copy.deepcopy(model).to(dev),
                          kv=KVCacheConfig(bits=8, page_tokens=16,
                                           n_pages=12),
                          max_batch=2, max_prompt=40, gen_cap=8,
                          collect_logits=True)
        before = t_fa.flash_attention.launches
        outs[dev] = eng.run([Request(rid=i, prompt=prompts[i], max_new=8)
                             for i in range(3)])
        launched = t_fa.flash_attention.launches - before
        assert launched == (4 if dev == "cuda" else 0)   # 2 groups x 2 layers
    for a, b in zip(outs["cuda"]["results"], outs["cpu"]["results"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for rid in range(3):
        np.testing.assert_allclose(outs["cuda"]["logits"][rid],
                                   outs["cpu"]["logits"][rid], atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mistral-nemo-12b", "qwen3-32b",
                                  "qwen1.5-32b"])
def test_cuda_dense_trio_serve_launcher_matches_cpu(cuda, name):
    """The serve launcher's engine (``launch.serve.build_engine``) over the
    4-bit paged cache, on the smoke-size dense trio (float32 activations,
    the same weights) on the card against the CPU: the same tokens, with
    the flash kernel launched once a layer and prefill group on the card
    only."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.launch import serve
    from repro_torch.models import Model

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[name]),
                              act_mode="none", act_dtype="float32")
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    argv = ["--arch", name, "--requests", "3", "--max-batch", "2",
            "--prompt-len", "32", "--gen-len", "6", "--kv-bits", "4"]
    outs = {}
    for dev in ("cuda", "cpu"):
        args = serve.parser().parse_args(argv + ["--device", dev])
        eng, reqs = serve.build_engine(args, copy.deepcopy(model).to(dev))
        before = t_fa.flash_attention.launches
        outs[dev] = eng.run(reqs)
        launched = t_fa.flash_attention.launches - before
        # 2 prefill groups: the third request takes a freed slot
        assert launched == (2 * cfg.n_layers if dev == "cuda" else 0)
    for a, b in zip(outs["cuda"]["results"], outs["cpu"]["results"]):
        assert a.status == b.status == "done"
        np.testing.assert_array_equal(a.tokens, b.tokens)


def _small_batched_setup(rp):
    from repro_torch.core.compressor import CompressionConfig
    from repro_torch.graph.data import synthetic_graph
    from repro_torch.graph.models import GNN, GNNConfig

    g = synthetic_graph("t", 700, 3500, 32, 5, homophily=0.5,
                        feature_noise=1.5, seed=1)
    cfg = GNNConfig(arch="sage", hidden=(64, 64), n_classes=5,
                    compression=CompressionConfig(2, 64, rp, vm=True))
    return g, cfg, GNN(cfg, 32, generator=torch.Generator().manual_seed(0))


@pytest.mark.gpu
@pytest.mark.parametrize("fused,rp", [("auto", 8), ("auto", 0), ("off", 0)])
def test_cuda_batched_run_matches_plain(cuda, fused, rp):
    """train_gnn_batched (4 bfs parts, halo 1, grad_accum 2) with the
    kernels against impl="torch" on the card, from the same weights:
    losses within rtol 1e-3 (the kernels' matmuls sum in another order),
    the same stash bytes, and a bit-identical repeat."""
    from repro_torch.graph.train import train_gnn_batched

    g, cfg, model = _small_batched_setup(rp)
    kw = dict(n_epochs=3, params=model, grad_accum=2, halo=1, fused=fused)
    runs = [train_gnn_batched(g, cfg, 4, impl=impl, **kw)
            for impl in ("cuda", "cuda", "torch")]
    losses = [[h[1] for h in r["history"]] for r in runs]
    assert losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], losses[2], rtol=1e-3)
    assert runs[0]["stash_bytes"] == runs[2]["stash_bytes"]


@pytest.mark.gpu
def test_cuda_batched_one_tight_batch_is_train_gnn(cuda):
    from repro_torch.graph.train import train_gnn, train_gnn_batched

    g, cfg, model = _small_batched_setup(8)
    full = train_gnn(g, cfg, n_epochs=3, params=model)
    one = train_gnn_batched(g, cfg, 1, n_epochs=3, params=model,
                            node_multiple=1, edge_multiple=1)
    assert [h[1] for h in one["history"]] == [h[1] for h in full["history"]]
    assert all(torch.equal(p, q) for p, q in
               zip(full["model"].parameters(), one["model"].parameters()))


# --------------------------------------------------- stash arena, offload
def _busy(n: int = 4096, reps: int = 8) -> None:
    """Queue a few ms of matmuls on the compute stream, so that whatever
    the side stream does next overlaps them."""
    a = torch.randn(n, n, device="cuda")
    for _ in range(reps):
        a = a @ a
        a = a / a.norm()


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["device", "host", "pinned-paged"])
def test_cuda_stash_round_trip_with_work_in_flight(cuda, policy):
    """Each layer's stash goes through the writer while matmuls are in
    flight on the compute stream; the source tensors are dropped and their
    memory asked for again at once and overwritten (the side stream's
    copies must still read the old bytes); the reader brings every field
    back one layer ahead with more work in flight: every byte as it was,
    every packed view 16-byte aligned, the host store full after the
    forward and empty after the walk, at most two layers on the card."""
    from repro_torch.core.compressor import CompressionConfig, compress
    from repro_torch.offload import engine as oe
    from repro_torch.offload.arena import plan_stashes

    n = 300_001          # odd: the segments after the first start unaligned
    cfgs = (CompressionConfig(2, 256, 0), None, CompressionConfig(4, 64, 8))
    shapes = ((n, 64), (n, 16), (n, 64))
    masks = (n * 8, n * 3, 0)
    plan = plan_stashes(shapes, cfgs, masks)
    store = oe.ArenaStore(plan, policy, "cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    writer, want = oe.make_writer(store, 3), []
    for li, (shape, cfg) in enumerate(zip(shapes, cfgs)):
        _busy()
        x = torch.randn(shape, device="cuda", generator=gen)
        words = torch.randint(-2**31, 2**31 - 1, (1, plan.layers[li].mask.size)
                              if masks[li] else (1, 1), device="cuda",
                              dtype=torch.int32, generator=gen)
        if cfg is None:
            want.append({"raw": x.clone()})
            writer.put_raw(li, x)
        else:
            ct = compress(x, cfg, 77 + li)
            want.append({"packed": ct.packed.clone(), "zero": ct.zero.clone(),
                         "rng": ct.rng.clone(), "seed": ct.seed})
            writer.put_ct(li, ct)
            del ct
        if masks[li]:
            want[li]["mask"] = words.clone()
            writer.put_mask(li, words)
        del x, words
        # the freed blocks, asked for again and overwritten right away
        junk = [torch.full(shape, 7.0, device="cuda") for _ in range(2)]
        del junk
    residual = writer.residual()
    del writer
    torch.cuda.synchronize()
    planned = plan.total_bytes if policy != "device" else 0
    assert oe.host_store_bytes() == planned
    if policy == "pinned-paged":
        assert all(a.is_pinned() for a in residual.host.arenas)
    reader = oe.make_reader(residual)
    del residual
    reader.prefetch(2)
    for li in reversed(range(3)):
        if li > 0:
            reader.prefetch(li - 1)
        _busy()
        if masks[li]:
            assert torch.equal(reader.get_mask(li), want[li]["mask"])
        if cfgs[li] is None:
            assert torch.equal(reader.get_raw(li), want[li]["raw"])
        else:
            ct = reader.get_ct(li)
            assert ct.packed.data_ptr() % 16 == 0
            assert ct.seed == want[li]["seed"]
            for f in ("packed", "zero", "rng"):
                assert torch.equal(getattr(ct, f), want[li][f]), (li, f)
    torch.cuda.synchronize()
    assert oe.host_store_bytes() == 0
    assert store.misaligned_views == 0 and store.packed_views == 2
    assert 0 < store.resident_peak <= oe.device_resident_stash_bytes(
        plan, policy)


@pytest.mark.gpu
@pytest.mark.parametrize("fused,rp", [("auto", 8), ("auto", 0)])
def test_cuda_offload_placements_bit_identical(cuda, fused, rp):
    """train_gnn and train_gnn_batched under every placement on the card:
    losses and params bit-identical to the per-tensor stash (rp_ratio 0
    runs the fused backward on the packed words the reader hands back),
    no misaligned packed view."""
    from repro_torch.graph.train import train_gnn, train_gnn_batched

    g, cfg, model = _small_batched_setup(rp)
    for fn, kw in ((train_gnn, {}),
                   (train_gnn_batched, dict(n_parts=2, shuffle=False))):
        runs = {p: fn(g, cfg, n_epochs=2, params=model, fused=fused,
                      offload=p, **kw)
                for p in (None, "device", "host", "pinned-paged")}
        for p in ("device", "host", "pinned-paged"):
            assert [h[1] for h in runs[p]["history"]] == \
                [h[1] for h in runs[None]["history"]], p
            assert all(torch.equal(a, b) for a, b in zip(
                runs[p]["model"].parameters(),
                runs[None]["model"].parameters())), p
            assert runs[p]["arena"]["misaligned_views"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["host", "pinned-paged"])
def test_cuda_kv_host_policies_bit_equal_to_device(cuda, policy):
    from repro_torch.launch import serve

    argv = ["--arch", "qwen1.5-4b", "--smoke", "--requests", "3",
            "--max-batch", "2", "--prompt-len", "40", "--gen-len", "6",
            "--kv-bits", "4"]
    outs = {}
    for p in ("device", policy):
        eng, reqs = serve.build_engine(
            serve.parser().parse_args(argv + ["--kv-policy", p]),
            collect_logits=True)
        outs[p] = eng.run(reqs)
        if p == "pinned-paged":
            assert all(t.is_pinned() for t in eng.pool.host.values())
    for a, b in zip(outs["device"]["results"], outs[policy]["results"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(outs["device"]["logits"][a.rid],
                                      outs[policy]["logits"][b.rid])


# ------------------------------------------------------------ mesh engine
@pytest.mark.gpu
def test_cuda_pager_pinned_round_trip_with_work_in_flight(cuda):
    """The feature pager's pages are page-locked; each round's copies run
    on the side stream while matmuls are in flight, and the compute stream
    waits for their event: every fetched round bit-equal to its rows."""
    from repro_torch.offload.pager import FeaturePager

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(4, 2, 5000, 128)).astype(np.float32)
    pager = FeaturePager(feats, "cuda", rank=1)
    assert all(p.is_pinned() for pages in pager._pages for p in pages)
    pager.prefetch(0)
    for r in range(4):
        _busy()
        got = pager.fetch(r)
        pager.prefetch((r + 1) % 4)
        assert torch.equal(got.cpu(), torch.from_numpy(feats[r, 1]))
    st = pager.stats()
    assert st["fetches"] == st["prefetch_hits"] == 4
    assert st["host_kind"] == "pinned" and st["n_pages"] == 20
    assert 0.0 <= st["overlap_frac"] <= 1.0 and st["span_s"] > 0


@pytest.mark.gpu
def test_cuda_pager_freed_with_a_prefetch_in_flight(cuda):
    """A pager dropped right after a prefetch, as a mesh run ends (its last
    round queued the next epoch's first): its device block is not handed
    to the compute stream while the side stream still writes it, so a
    block of the same size allocated and filled at once keeps its
    values."""
    from repro_torch.offload.pager import FeaturePager

    rows = 1 << 16
    feats = np.ones((1, 1, rows, 256), np.float32)      # 64 MiB a round
    for _ in range(4):
        pager = FeaturePager(feats, "cuda", page_rows=rows)
        _busy()                 # the copy starts after this work
        pager.prefetch(0)
        del pager
        t = torch.empty((rows, 256), device="cuda").fill_(2.0)
        torch.cuda.synchronize()
        assert bool((t == 2.0).all())


@pytest.mark.gpu
def test_cuda_exchange_backward_bit_identical(cuda, tmp_path):
    """The exchange Function on the card in a one-rank gloo group: the
    strip is the gathered rows, and the backward (the CSR of ones summed
    by spmm, no atomic scatter) is the dense transpose and bit-identical
    from call to call."""
    import torch.distributed as dist

    from repro_torch.parallel import halo

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        rng = np.random.default_rng(0)
        n, H, f = 4000, 700, 64
        send = rng.integers(0, n, (1, H))
        back = halo.send_csr(send, np.array([H - 9]), n, "cuda")
        h = torch.tensor(rng.normal(size=(n, f)).astype(np.float32),
                         device="cuda")
        g = torch.tensor(rng.normal(size=(n + H, f)).astype(np.float32),
                         device="cuda")
        grads = []
        for _ in range(2):
            x = h.clone().requires_grad_()
            y = halo._HaloExchange.apply(x, torch.from_numpy(send).cuda(),
                                         back, dist.group.WORLD)
            assert torch.equal(y[n:], h[torch.from_numpy(send[0]).cuda()])
            y.backward(g)
            grads.append(x.grad)
        assert torch.equal(grads[0], grads[1])
        want = g[:n].double().cpu()
        want.index_add_(0, torch.from_numpy(send[0, :H - 9]),
                        g[n:n + H - 9].double().cpu())
        np.testing.assert_allclose(grads[0].cpu().numpy(), want.numpy(),
                                   atol=1e-5)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_cuda_two_ranks_share_the_card(cuda):
    """Two ranks on the one card over gloo: the exchange and its backward
    as on the CPU, and n_parts = m = 2 uncompressed within rtol 2e-4 /
    atol 2e-5 of train_gnn on the card, both ranks bit-equal."""
    import torch_mesh_ranks as ranks

    from repro_torch.graph.train import train_gnn
    from repro_torch.parallel import run_ranks

    n, H, f = 64, 9, 16
    got = run_ranks(ranks.exchange, 2, (n, H, f, "cuda"), timeout=120)
    h, send, _, _ = ranks.exchange_case(2, n, H, f)
    for j in range(2):
        for i in range(2):
            np.testing.assert_array_equal(
                got[j]["out"][0][n + i * H:n + (i + 1) * H], h[i][send[i, j]])
        np.testing.assert_array_equal(got[j]["grad"][0], got[j]["grad"][1])
    runs = run_ranks(ranks.train, 2, ("mesh", "sage", False,
                                      dict(n_parts=2, n_epochs=2), "cuda"),
                     timeout=120)
    cfg = ranks.config("sage", False)
    ref = train_gnn(ranks.graph(), cfg, n_epochs=2, params=ranks.model(cfg))
    for pa, pb, pr in zip(runs[0]["params"], runs[1]["params"],
                          ref["model"].parameters()):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_allclose(pa, pr.detach().cpu().numpy(), rtol=2e-4,
                                   atol=2e-5)


# ---------------------------------------------------------- observability
@pytest.mark.gpu
@pytest.mark.parametrize("rp", [8, 0])
def test_cuda_quant_probe_through_the_kernels(cuda, rp):
    """The quant-health probe on the card launches one ``rp_project`` per
    RP layer and one ``quant_pack`` and ``dequant_unpack`` per compressed
    layer, and agrees with ``impl="torch"`` on the same inputs: without RP
    the codes are bit-equal (``measured_var`` within rtol 1e-6,
    ``sat_rate`` equal), with RP 8 within rtol 1e-3 and atol 1e-3."""
    from repro_torch.graph.models import device_graph
    from repro_torch.obs.quantstats import measure_quant_health

    g, cfg, model = _small_batched_setup(rp)
    model = model.cuda()
    dg = device_graph(g, "sage", "cuda")
    wrappers = (t_qk.quant_pack, t_qk.dequant_unpack, t_rk.rp_project)
    for w in wrappers:
        w.launches = 0
    got = measure_quant_health(model, dg, cfg)
    n = cfg.n_layers
    assert [w.launches for w in wrappers] == [n, n, n if rp else 0]
    want = measure_quant_health(model, dg, cfg.with_impl("torch"))
    assert [w.launches for w in wrappers] == [n, n, n if rp else 0]
    for a, b in zip(got, want):
        assert a["n_elements"] == b["n_elements"]
        assert a["n_blocks"] == b["n_blocks"]
        if rp:
            np.testing.assert_allclose(a["measured_var"], b["measured_var"],
                                       rtol=1e-3)
            assert abs(a["sat_rate"] - b["sat_rate"]) <= 1e-3
        else:
            np.testing.assert_allclose(a["measured_var"], b["measured_var"],
                                       rtol=1e-6)
            assert a["sat_rate"] == b["sat_rate"]
        np.testing.assert_allclose(a["rng_sq_mean"], b["rng_sq_mean"],
                                   rtol=1e-3 if rp else 1e-5)


@pytest.mark.gpu
def test_cuda_pager_registry_without_a_sync_per_fetch(cuda, monkeypatch):
    """With a registry, the pager's overlap histogram gets one observation
    a fetch, read from the CUDA events when ``stats()`` is called: the
    fetch loop itself waits on nothing."""
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.offload.pager import FeaturePager

    feats = np.random.default_rng(0).normal(
        size=(3, 1, 5000, 128)).astype(np.float32)
    reg = MetricsRegistry()
    pager = FeaturePager(feats, "cuda", metrics=reg)
    waits = []
    real_event_sync = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: waits.append("device"))
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: waits.append("event"))
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        lambda self: waits.append("stream"))
    pager.prefetch(0)
    for r in range(6):
        _busy(1024, 2)
        pager.fetch(r % 3)
        pager.prefetch((r + 1) % 3)
    assert waits == []
    monkeypatch.setattr(torch.cuda.Event, "synchronize", real_event_sync)
    st = pager.stats()
    snap = reg.snapshot()
    assert snap["pager/fetches"] == st["fetches"] == 6
    assert snap["pager/overlap_frac"]["count"] == 6
    assert 0.0 <= st["overlap_frac_window"] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["full", "partition", "mesh"])
def test_cuda_obs_on_is_bit_identical(cuda, kind):
    """Spans, metrics and the quant probe every 2 epochs move no bit of a
    run on the card: losses, parameters and the live stash."""
    import dataclasses

    from repro_torch.engine.plan import (ExecutionPlan, ObsPolicy,
                                         SamplingPolicy)
    from repro_torch.engine.runner import run

    g, cfg, model = _small_batched_setup(8)
    sampling = {"full": SamplingPolicy(),
                "partition": SamplingPolicy(kind="partition", n_parts=2),
                "mesh": SamplingPolicy(kind="mesh", n_parts=2)}[kind]
    plan = ExecutionPlan(sampling=sampling)
    obs = ObsPolicy(enabled=True, quant_stats=True, quant_stats_every=2)
    off = run(g, cfg, plan, n_epochs=3, params=model)
    on = run(g, cfg, dataclasses.replace(plan, obs=obs), n_epochs=3,
             params=model)
    assert [h[1] for h in off["history"]] == [h[1] for h in on["history"]]
    assert all(torch.equal(p, q) for p, q in
               zip(off["model"].parameters(), on["model"].parameters()))
    assert off["stash_bytes"] == on["stash_bytes"]
    rows = on["obs"].quant_rows()
    assert len(rows) == cfg.n_layers and rows[0]["epoch"] == 2


@pytest.mark.gpu
def test_cuda_step_spans_nest_across_autograd_thread(cuda, tmp_path):
    """On the card the backward runs on autograd's device thread: its
    ``gnn/*`` spans still nest under ``step/backward`` in a tracer, and under
    a profiler every span of the step is a ``cpu_op`` range, the backward's
    on that other thread."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.compile import compile_plan
    from repro_torch.engine.plan import ExecutionPlan
    from repro_torch.obs.trace import Tracer, set_tracer
    from repro_torch.optim import AdamWConfig

    g, cfg, model = _small_batched_setup(8)
    compiled = compile_plan(g, cfg, ExecutionPlan(), model.cuda(),
                            AdamWConfig(lr=5e-3), "cuda")
    compiled.step(0)
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            compiled.step(1)
            torch.cuda.synchronize()
    finally:
        set_tracer(prev)
    spans = tracer.spans
    [bwd] = [i for i, s in enumerate(spans) if s.name == "step/backward"]
    assert sorted(s.name for s in spans if s.parent == bwd) == \
        ["gnn/linear"] * 3 + ["gnn/spmm"] * 2
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = [(e["name"], e.get("tid")) for e in events
              if e.get("cat") == "cpu_op" and e.get("name") in
              {s.name for s in spans}]
    assert sorted(n for n, _ in ranges) == sorted(s.name for s in spans)
    [main] = {t for n, t in ranges if n == "step"}
    assert sum(t != main for _, t in ranges) == 5


# --------------------------------------------- LM training and the decode
def _block_params(d: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {"w1": (torch.randn(d, 2 * d, generator=gen) / d ** 0.5).to(
                torch.bfloat16).cuda().requires_grad_(),
            "w2": (torch.randn(2 * d, d, generator=gen) / d ** 0.5).to(
                torch.bfloat16).cuda().requires_grad_()}


def _block(x, p):
    return x + torch.nn.functional.silu(x @ p["w1"]) @ p["w2"]


@pytest.mark.gpu
@pytest.mark.parametrize("offload", [None, "pinned-paged"])
def test_cuda_compressed_block_kernels_against_plain(cuda, offload):
    """compressed_block on bf16 activations with the quant kernels and
    with their plain versions on the card: the stash bit-equal (packed
    words, zero, range), so the output and the gradients of x and of the
    parameters are too; the pinned-paged stash gives the same bits."""
    from repro_torch.core import backend
    from repro_torch.core.act_compress import compressed_block
    from repro_torch.core.compressor import CompressionConfig, compress

    cfg = CompressionConfig(bits=2, group_size=256)
    x0 = (torch.randn(2, 96, 256, generator=torch.Generator().manual_seed(1))
          .to(torch.bfloat16).cuda())
    g = torch.randn(2, 96, 256, device="cuda").to(torch.bfloat16)
    stash = [compress(x0, cfg, 99)]
    with backend.use_impl("torch"):
        stash.append(compress(x0, cfg, 99))
    for f in ("packed", "zero", "rng"):
        assert torch.equal(getattr(stash[0], f), getattr(stash[1], f))
    runs = []
    for impl in ("auto", "torch"):
        p = _block_params(256, 2)
        x = x0.clone().requires_grad_()
        with backend.use_impl(impl):
            y = compressed_block(_block, cfg, offload)(x, p, 99)
            y.backward(g)
        runs.append((y.detach(), x.grad, p["w1"].grad, p["w2"].grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _smoke_lm(device):
    import dataclasses

    from repro_torch.configs import get, reduce_for_smoke
    from repro_torch.core.compressor import CompressionConfig
    from repro_torch.models import Model

    cfg = dataclasses.replace(
        reduce_for_smoke(get("qwen1.5-4b")), act_mode="act",
        act_dtype="float32",
        act_compression=CompressionConfig(bits=2, group_size=64))
    return Model(cfg, device=device,
                 generator=torch.Generator(device).manual_seed(0))


@pytest.mark.gpu
def test_cuda_lm_train_step_matches_cpu(cuda):
    """One act-mode train step of the smoke LM (float32 activations) on the
    card against the CPU's from the same weights: the loss within 1e-5
    relative; of every updated parameter at least 99 % of the elements
    within one bf16 ulp (2**-7 relative, 1e-6 absolute: the matmuls sum in
    other orders) and all within 2 * lr (AdamW moves an element whose
    gradient is rounding noise by about +-lr either way)."""
    from repro_torch.data import batch_for_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cpu = _smoke_lm("cpu")
    card = _smoke_lm("cpu").cuda()
    opt = AdamWConfig(lr=3e-3, weight_decay=0.01, grad_clip=1.0)
    tokens = torch.as_tensor(batch_for_step(512, 4, 64, 0))
    losses = []
    for model, dev in ((cpu, "cpu"), (card, "cuda")):
        state = adamw_init(list(model.parameters()), opt)
        step = make_train_step(model, opt)
        losses.append(float(step(state, {"tokens": tokens.to(dev)})["loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[0])
    for a, b in zip(cpu.parameters(), card.parameters()):
        a, b = a.detach().float(), b.detach().cpu().float()
        close = torch.isclose(b, a, rtol=2.0 ** -7, atol=1e-6)
        assert close.float().mean() >= 0.99
        torch.testing.assert_close(b, a, rtol=0.0, atol=2 * opt.lr)


@pytest.mark.gpu
def test_cuda_page_fetch_kernel_bit_equal_to_plain(cuda):
    """make_page_fetch on the card: each page (null pages included) read
    through the dequant_unpack kernel bit-equal to the plain version."""
    from repro_torch.core import backend
    from repro_torch.serving import kvcache

    layout = kvcache.plan_kv_layout(
        kvcache.KVCacheConfig(bits=4, group_size=64, page_tokens=16,
                              n_pages=12), n_layers=1, n_kv_heads=4,
        d_head=32)
    pool = kvcache.init_kv_pool(layout, "cuda")
    gen = torch.Generator("cuda").manual_seed(3)
    k, v = (torch.randn((1, 2, 64, 4, 32), device="cuda", generator=gen)
            for _ in range(2))
    kvcache.write_prompt(pool, layout, k, v,
                         np.asarray([[0, 1, 2, 3], [4, 5, 6, 12]]), [0, 1])
    table = torch.tensor([[0, 1, 2, 3, 12], [4, 5, 6, 12, 12]],
                         dtype=torch.int32, device="cuda")
    fetch = kvcache.make_page_fetch(kvcache.layer_view(pool, 0), layout,
                                    table)
    for j in range(table.shape[1]):
        got = fetch(j)
        with backend.use_impl("torch"):
            want = fetch(j)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert not bool(fetch(4)[0].any())      # null pages read as zeros


@pytest.mark.gpu
def test_cuda_lm_resume_bit_identical(cuda, tmp_path):
    """The launcher at the smoke width on the card: 4 steps checkpointed
    every 2, then 6 in the same directory, equal to 6 uninterrupted steps
    bit for bit (losses and parameters)."""
    from repro_torch.launch import train

    base = ["--arch", "qwen1.5-4b", "--smoke", "--batch", "2", "--seq", "64",
            "--act-mode", "act"]
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    run = lambda argv: train.lm_main(train.parser().parse_args(base + argv))
    whole = run(["--steps", "6"])
    run(["--steps", "4"] + ck)
    resumed = run(["--steps", "6"] + ck)
    assert [h["step"] for h in resumed["history"]] == [4, 5]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in whole["history"][4:]]
    assert all(torch.equal(p, q) for p, q in zip(
        resumed["model"].parameters(), whole["model"].parameters()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_and_mamba2_decode_match_cpu(cuda, dtype):
    """``ssd_chunked`` (chunk 16, from an initial state) and three
    ``mamba2_decode`` steps of the smoke mamba2 layer on the card against
    the CPU from the same inputs: y and the state within 1e-4 (float32
    products summed in other orders); decode in bf16 within 2**-5 + 2**-6
    relative (each device rounds the bf16 conv and products its own
    way)."""
    import types

    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.models import ssm
    from repro_torch.models.transformer import init_params

    rng = np.random.default_rng(14)
    b, s, h, p, n = 2, 64, 4, 16, 16
    ins = [rng.normal(size=(b, s, h, p)),
           np.log1p(np.exp(rng.normal(size=(b, s, h)))),
           -np.exp(rng.normal(size=h) * 0.5), rng.normal(size=(b, s, n)),
           rng.normal(size=(b, s, n)), rng.normal(size=(b, h, p, n))]
    ins = [torch.from_numpy(a.astype(np.float32)) for a in ins]
    out = {dev: ssm.ssd_chunked(*(t.to(dev) for t in ins[:5]), chunk=16,
                                initial_state=ins[5].to(dev),
                                return_state=True) for dev in ("cpu", "cuda")}
    for a, c in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a.cpu(), c, atol=1e-4, rtol=1e-4)

    cfg = reduce_for_smoke(ARCHS["mamba2-780m"])
    mixer = init_params(cfg, torch.Generator().manual_seed(3))["layers"][0][
        "mixer"]
    d_inner, n_heads = ssm.ssm_dims(cfg)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(2, 3, cfg.d_model)).astype(
        np.float32)).to(dt)
    conv = torch.from_numpy(rng.normal(size=(
        2, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state)).astype(
            np.float32)).to(dt)
    state = torch.from_numpy(rng.normal(size=(
        2, n_heads, cfg.ssm_headdim, cfg.ssm_state)).astype(np.float32))
    res = {}
    for dev in ("cpu", "cuda"):
        pm = types.SimpleNamespace(**{k: v.to(dev) for k, v in mixer.items()})
        c, st, ys = conv.to(dev), state.to(dev), []
        for t in range(3):
            y, c, st = ssm.mamba2_decode(x[:, t:t + 1].to(dev), pm, cfg, c,
                                         st)
            ys.append(y)
        res[dev] = [torch.cat(ys, 1).float().cpu(), c.float().cpu(),
                    st.cpu()]
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(
        atol=2.0 ** -5, rtol=2.0 ** -6)
    for a, c in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, c, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (3e-5, 3e-5)),
                                       (torch.bfloat16, (1e-3, 2.0 ** -7))])
def test_cuda_flash_noncausal_and_single_query(cuda, dtype, tol):
    """The enc-dec's flash calls against the plain version: the encoder's
    non-causal self-attention, and a decode step's cross-attention (Sq =
    1 over Skv keys, non-causal), each one launch."""
    from repro_torch.kernels import flash_attention as t_fa

    for bh, sq, skv, dh in ((16, 256, 256, 64), (16, 1, 300, 64),
                            (8, 1, 1024, 64), (4, 3, 77, 128)):
        q, k, v = _qkv(bh, sq, skv, dh, dtype, seed=sq + skv)
        before = t_fa.flash_attention.launches
        got = t_fa.flash_attention(q, k, v, causal=False, scale_q=True)
        assert t_fa.flash_attention.launches == before + 1
        want = t_ref.flash_attention(q, k, v, causal=False, scale_q=True)
        torch.testing.assert_close(got.float(), want.float(), atol=tol[0],
                                   rtol=tol[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["zamba2-1.2b", "seamless-m4t-large-v2"])
def test_cuda_legacy_loop_matches_cpu(cuda, name):
    """The serve launcher's legacy loop on the smoke hybrid and enc-dec
    (float32 activations, the same weights) on the card against the CPU:
    the same tokens, with the flash kernel launched on the card only (the
    hybrid's shared block once a batch; the enc-dec's encoder layers a
    batch and its cross-attention a layer and decode step)."""
    import copy
    import dataclasses

    from repro_torch.configs import ARCHS, reduce_for_smoke
    from repro_torch.kernels import flash_attention as t_fa
    from repro_torch.launch import serve
    from repro_torch.models import Model

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[name]),
                              act_mode="none", act_dtype="float32")
    model = Model(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    argv = ["--arch", name, "--smoke", "--requests", "3", "--max-batch",
            "2", "--prompt-len", "32", "--gen-len", "6"]
    outs = {}
    for dev in ("cuda", "cpu"):
        args = serve.parser().parse_args(argv + ["--device", dev])
        before = t_fa.flash_attention.launches
        outs[dev] = serve._legacy_loop(copy.deepcopy(model).to(dev), args)
        launched = t_fa.flash_attention.launches - before
        want = (2 if name == "zamba2-1.2b"
                else 2 * cfg.encoder_layers + 2 * 5 * cfg.n_layers)
        assert launched == (want if dev == "cuda" else 0)
    for a, b in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_cuda_saved_audit_matches_cpu(cuda):
    """The saved-tensor audit of the plan matrix on the card (the kernels,
    page-locked host arenas) gives the CPU's ledgers and findings: none."""
    from repro_torch.staticcheck import saved_audit

    on_card = saved_audit.run(device="cuda")
    on_cpu = saved_audit.run(device="cpu")
    assert len(on_card) == 34
    for a, b in zip(on_card, on_cpu):
        assert a.key == b.key
        assert a.findings == b.findings == []
        assert (a.ledger_bytes, a.n_saved) == (b.ledger_bytes, b.n_saved)
        assert a.ledger_bytes == a.report_bytes


@pytest.mark.gpu
@pytest.mark.parametrize("d,n,g,bits", [(256, 256, 256, 2), (512, 256, 256, 2),
                                        (512, 40, 256, 2), (64, 64, 64, 2),
                                        (128, 8, 64, 4), (128, 8, 64, 1),
                                        (96, 48, 32, 2), (512, 520, 256, 2)])
def test_cuda_contract_smem_is_the_kernels(cuda, d, n, g, bits):
    """The kernel contracts' shared memory for the fused pair is what the
    kernel library computes for its launches (matmul_quant_smem, and
    dequant_matmul_smem beside dequant_matmul_tile's tile), for every
    compiled configuration, packed words aligned or not."""
    import ctypes

    from repro_torch.kernels import fused_matmul as t_fk
    from repro_torch.staticcheck import kernel_contracts as kc

    lib = t_fk._lib()
    for config in range(len(t_fk.FWD_CONFIGS)):
        assert lib.matmul_quant_smem(d, n, g, config) == \
            kc.fwd_launch(d, n, g, config).smem
    assert lib.matmul_quant_smem(d, n, g, t_fk.fwd_index(n)) == \
        kc.fwd_launch(d, n, g).smem
    tile = (ctypes.c_int * 3)()
    got = (ctypes.c_longlong * 2)()
    for config in range(len(t_fk.TILES)):
        lib.dequant_matmul_tile(config, tile)
        for aligned in (True, False):
            lib.dequant_matmul_smem(d, n, g, bits, int(aligned), config, got)
            b = kc.bwd_launch(4096, d, n, g, bits, aligned, config)
            assert tuple(tile) == b.tile
            assert (got[0], got[1]) == (b.smem, b.max_smem)
    assert lib.matmul_quant_smem(d, n, g, 3) == -1
