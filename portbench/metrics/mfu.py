"""``mfu``: the whole step's model FLOPs a second as a share of the card's
float32 peak, in percent.  The FLOPs are the forward and backward of the
GraphSAGE products and aggregations, counted from the cell's shapes
(:meth:`portbench.bench.work.GNNStep.model_flops`; nothing recomputed,
the projection and the quantizer not counted); the time is the untraced
window's ``step_ms``.  The peak is float32's 67 TFLOP/s: the program runs
its products with TF32 off.
"""
from portbench.bench import peaks


def read(ctx):
    step_ms = ctx.e2e.get("step_ms")
    if not step_ms:
        return None
    return 100.0 * ctx.shapes.model_flops() / (step_ms * 1e-3) \
        / peaks.FP32_FLOPS
