"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they skip without a CUDA device (as on a CPU-only host) and
import nothing of JAX, so the card's host runs them with
``python -m pytest -q -m gpu tests/test_torch_cuda.py``.  Quantize and
dequantize must be bit-equal; RP/IRP agree to rtol/atol 2e-4 (the kernel and
cuBLAS sum the same float32 products in another order)."""
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


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,r", [(677, 256, 32), (130, 512, 64),
                                   (33, 40, 5)])
def test_cuda_rp_kernels_match_plain(cuda, m, d, r):
    x = torch.from_numpy(_x(m, d)).cuda()
    y = t_rk.rp_project(x, 7, r)
    torch.testing.assert_close(y, t_ref.rp_project(x, 7, r), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(t_rk.irp_project(y, 7, d),
                               t_ref.irp_project(y, 7, d), rtol=2e-4,
                               atol=2e-4)


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
