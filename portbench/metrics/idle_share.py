"""``idle_share``: the share of the traced window in which nothing ran on
the card (no kernel, copy or fill), in percent.  The window runs from the
first traced step's start to the last's end, each step through its loss
read-back.  Layer: the device, under ``engine/compile.CompiledFull.step``.
"""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
