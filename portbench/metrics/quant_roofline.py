"""``quant_roofline``: the quantize-and-pack and unpack-and-dequantize
kernels (``csrc/quant_blockwise.cu``, vector and scalar paths) against
their bound, in percent: the least time for the bytes a step's launches
must move at the card's memory bandwidth, over their profiled device time.
A launch reads each input once and writes each output once: quantizing
reads the padded float32 blocks and writes the code words and a float32
(min, range) pair a block; dequantizing the reverse.
"""
from portbench.bench import peaks

#: The kernels timed, by the names the profiler gives them.
KERNELS = r"(?<![A-Za-z0-9_])(de)?quant_(vec|scalar)_kernel"


def bound_s(shapes) -> float:
    """One step's least time for its quantizer launches."""
    total = 0.0
    for ly in shapes.quant_layers():
        nb = shapes.n_blocks(ly)
        floats = 4 * nb * shapes.recipe["group_size"]
        codes = 4 * nb * shapes.words_per_block() + 8 * nb
        total += 2 * (floats + codes) / peaks.HBM_BYTES_S
    return total


def read(ctx):
    return peaks.roofline_share(ctx, KERNELS, bound_s)
