"""``aggregate_ms``: device milliseconds a step in the aggregation, the
program's ``graph/models.spmm`` (the gather of neighbour rows, the edge
weights and the segment sum, forward and transposed).  A kernel counts when
it was launched inside that Python frame, read from the window traced with
Python frames.  A rename of the function leaves this metric empty until
the benchmark points it at the new name.
"""

#: The Python frame of the aggregation, as the profiler names it.
FRAME = r"graph/models\.py\(\d+\): spmm$"


def read(ctx):
    st = ctx.stack
    if st is None:
        return None
    s = st.launched_under_s(FRAME)
    if not s:
        return None
    return s / st.steps * 1e3
