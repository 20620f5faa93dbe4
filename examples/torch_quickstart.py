"""Quickstart (PyTorch/CUDA port): compress/decompress an activation map
with block-wise INT2 stochastic-rounding quantization + random projection
(the paper's core), and see the unbiasedness + memory properties.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card (the default) the quant and RP kernels run; ``--device cpu``
runs their plain PyTorch versions.  The input is drawn from a seeded
``torch.Generator`` (the reference's draws from ``jax.random``, so the two
scripts print different numbers for the same recipe).
"""
import argparse

import torch

from repro_torch.core.compressor import (CompressionConfig, compress,
                                         decompress)
from repro_torch.core.device import resolve_device
from repro_torch.core.variance import (expected_sr_variance,
                                       expected_sr_variance_uniform,
                                       optimize_levels)

CONFIGS = (
    ("per-row INT2 (EXACT)", CompressionConfig(bits=2, group_size=32,
                                               rp_ratio=8)),
    ("block-wise INT2 G=256 (i-EXACT)", CompressionConfig(
        bits=2, group_size=256, rp_ratio=8)),
    ("block-wise + variance-minimized levels", CompressionConfig(
        bits=2, group_size=256, rp_ratio=8, vm=True)),
)


def main(argv=None, *, x: torch.Tensor | None = None) -> dict:
    """Run the quickstart; ``x`` replaces the drawn activation map (tests
    hand in the reference's input).  Returns each config's stored bytes,
    errors and first reconstruction, the VM levels and the variances."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=20,
                    help="seeds averaged to show the estimator unbiased")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if x is None:
        gen = torch.Generator(device).manual_seed(0)
        x = torch.randn((1024, 256), generator=gen, device=device) * 2.0 + 0.5
    x = x.to(device)
    x_bytes = x.numel() * x.element_size()
    print(f"activation map: {tuple(x.shape)}, {x_bytes / 1e6:.2f} MB fp32")

    rows = []
    for desc, cfg in CONFIGS:
        ct = compress(x, cfg, seed=0)
        xh = decompress(ct)
        single = float((xh - x).abs().mean())
        # SR (+RP) is unbiased: the mean over seeds converges to x as
        # 1/sqrt(n)
        mean = sum(decompress(compress(x, cfg, s))
                   for s in range(args.seeds)) / float(args.seeds)
        bias = float((mean - x).abs().mean())
        print(f"{desc:42s} stored {ct.nbytes / 1e6:6.3f} MB "
              f"({100 * (1 - ct.nbytes / x_bytes):.1f}% smaller); "
              f"|err| 1 seed = {single:.3f}, mean of {args.seeds} = "
              f"{bias:.3f} (-> 0 as 1/sqrt n: unbiased)")
        rows.append({"desc": desc, "cfg": cfg, "stored_bytes": ct.nbytes,
                     "err_one_seed": single, "err_mean": bias, "xhat": xh})

    lv = optimize_levels(256, bits=2)
    var_u = expected_sr_variance_uniform(256)
    var_o = expected_sr_variance(lv, 256)
    print(f"\nVM levels for D=256: α*={lv[1]:.4f}, β*={lv[2]:.4f} "
          f"(uniform would be 1, 2)")
    print(f"expected SR variance: uniform={var_u:.5f} optimized={var_o:.5f}")
    return {"x_bytes": x_bytes, "rows": rows, "levels": lv,
            "var_uniform": var_u, "var_optimized": var_o}


if __name__ == "__main__":
    main()
