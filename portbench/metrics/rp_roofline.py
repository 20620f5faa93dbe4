"""``rp_roofline``: the random-projection kernel (``csrc/rp_matmul.cu``,
projection and recovery) against its bound, in percent: for each launch
the larger of its bytes at the memory bandwidth (the float32 input read
once, the output written once; the matrix is regenerated, never read) and
its operations at the TF32 tensor-core peak, over the profiled time.
"""
from portbench.bench import peaks

KERNELS = r"(?<![A-Za-z0-9_])rp_kernel"


def bound_s(shapes) -> float:
    r = shapes.recipe
    if r is None or r["rp_ratio"] <= 1:
        return 0.0
    n, total = shapes.n_nodes, 0.0
    for ly in shapes.quant_layers():
        d, p = ly.lin_in, shapes.projected(ly)
        nbytes, flops = 4 * n * (d + p), 2.0 * n * d * p
        total += 2 * peaks.bound_s(nbytes, flops, peaks.TF32_FLOPS)
    return total


def read(ctx):
    return peaks.roofline_share(ctx, KERNELS, bound_s)
