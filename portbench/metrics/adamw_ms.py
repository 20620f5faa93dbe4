"""``adamw_ms``: device milliseconds a step launched inside the program's
``optim/adamw`` span, around each ``optim/adamw.adamw_update``.  None where
the program has no such span.
"""
from portbench.bench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, "optim/adamw")
