"""``linear_ms``: device milliseconds a step launched inside the program's
``gnn/linear`` spans: each layer's product with its compression in
``engine/forward._StashGNN`` (forward: the projection, the quantizer or the
fused pair beside the product, or the plain product of an uncompressed
layer; backward: the weight gradient from the stash and the input
gradient).  None where the program has no such span.
"""
from portbench.bench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, "gnn/linear")
