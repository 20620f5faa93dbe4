"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full power limit of 700 W).  A card set below that limit
runs slower under load: the harness prints the card's limit beside every
run."""

#: HBM3 bandwidth, bytes/s.
HBM_BYTES_S = 3.35e12
#: float32 outside the tensor cores (the port turns TF32 off for its
#: products), FLOP/s.
FP32_FLOPS = 67e12
#: TF32 on the tensor cores, FLOP/s.
TF32_FLOPS = 495e12
#: Device memory, bytes.
MEMORY_BYTES = 80e9


def bound_s(nbytes: float, flops: float, flops_peak: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory bandwidth and the operations at ``flops_peak``."""
    return max(nbytes / HBM_BYTES_S, flops / flops_peak)


def roofline_share(ctx, kernels: str, bound_s) -> float | None:
    """A kernel family's share of its bound, in percent: ``bound_s(shapes)``
    (one step's least time for its launches) times the traced steps, over
    the profiled time of the kernels whose names match ``kernels``.  None
    where the cell launches none of them or the trace holds none."""
    tr = ctx.trace
    t = tr.kernel_s(kernels) if tr is not None else None
    b = bound_s(ctx.shapes)
    if not t or not b:
        return None
    return 100.0 * b * tr.steps / t
