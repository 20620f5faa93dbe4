"""``fused_roofline``: the fused matmul-quantize pair
(``csrc/fused_matmul.cu``: ``matmul_quant`` in the forward,
``dequant_matmul`` and its tree sum in the backward) against its bound, in
percent: for each launch the larger of its bytes at the memory bandwidth
and its operations at the TF32 tensor-core peak, over the profiled time.
The forward reads x and w and writes y, the code words and a (min, range)
pair a block; the backward reads those codes and the output gradient and
writes dW.
"""
from portbench.bench import peaks

KERNELS = (r"(?<![A-Za-z0-9_])(matmul_quant_kernel|dequant_matmul_kernel|"
           r"tree_sum_kernel)")


def bound_s(shapes) -> float:
    n, total = shapes.n_nodes, 0.0
    for ly in shapes.fused_layers():
        d, o = ly.lin_in, ly.d_out
        nb = shapes.n_blocks(ly)
        codes = 4 * nb * shapes.words_per_block() + 8 * nb
        flops = 2.0 * n * d * o
        fwd = 4 * (n * d + d * o + n * o) + codes
        bwd = codes + 4 * (n * o + d * o)
        total += peaks.bound_s(fwd, flops, peaks.TF32_FLOPS)
        total += peaks.bound_s(bwd, flops, peaks.TF32_FLOPS)
    return total


def read(ctx):
    return peaks.roofline_share(ctx, KERNELS, bound_s)
