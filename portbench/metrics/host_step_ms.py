"""``host_step_ms``: host milliseconds a step inside the program's ``step``
span around ``engine/compile.CompiledFull.step``: the time to enqueue the
forward, the backward and AdamW, read under the profiler.  ``step_ms``
less this is, roughly, the wait on the loss read-back.  None where the
program has no such span.
"""
from portbench.bench import spans


def read(ctx):
    return spans.host_ms(ctx.trace, "step")
