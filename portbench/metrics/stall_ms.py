"""``stall_ms``: device idle milliseconds a step spent waiting on the
program's own host code inside its ``step`` spans.  Each idle gap of the
card ends at the launch of the kernel that ends it, and the part of it
that the host spent inside a ``step`` span counts
(:func:`portbench.bench.spans.idle_ms`: gap lengths from the device's
clock, launches and spans from the host's; the profiler's two clocks drift
apart on the card's machine, so they are not compared).  The rest of the
idle time lies between steps (the read-back and the harness).  None where
the program has no such span.
"""
from portbench.bench import spans


def read(ctx):
    return spans.idle_ms(ctx.trace, "step")
