"""``stash_mb``: megabytes (1e6 bytes) the step keeps for its backward,
summed over the layers: the program's own counter
(``CompiledFull.stash_bytes``, read after a step).  The benchmark's own
reckoning from the cell's shapes (:meth:`portbench.bench.work.GNNStep.
stash_bytes`) is printed beside it on standard error.
"""


def read(ctx):
    b = ctx.counters.get("stash_bytes")
    return sum(b) / 1e6 if b else None
