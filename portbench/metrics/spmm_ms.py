"""``spmm_ms``: device milliseconds a step launched inside the program's
``gnn/spmm`` spans, one around each call of ``graph/models.spmm`` (the
gather of neighbour rows, the edge weights and the segment sum, forward and
transposed): the kernels ``aggregate_ms`` reads from a Python frame, here
from the program's span over the 30 traced steps.  None where the program
has no such span.
"""
from portbench.bench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, "gnn/spmm")
