"""The program's own spans in a traced window.

While a ``torch.profiler`` records, the program enters a profiler range at
each of its layer boundaries (``repro_torch.obs.trace``: ``step``,
``step/forward``, ``step/loss``, ``step/backward``, ``optim/adamw``,
``gnn/spmm``, ``gnn/linear``).  Each is a ``cpu_op`` event on the host's
clock, the clock of the kernel launches inside it, which
:func:`portbench.bench.trace.read_profile` keeps among the host operators
(``Trace.ops``).  The readers here compare ranges with launches, and take
only lengths from the device's timestamps.  A program without those ranges
(an older commit) leaves every reading here None.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import re

from portbench.bench.trace import _merge


def ranges(tr, name: str) -> list:
    """The ``(start_us, end_us)`` of each range named ``name`` that starts
    inside the traced window, by start."""
    w0, w1 = tr.window
    return [(s, e) for s, e, n in tr.ops if n == name and w0 <= s <= w1]


def launched_ms(tr, name: str) -> float | None:
    """Device milliseconds a step launched while a range named ``name`` was
    open (on any host thread: autograd's runs the backward while the
    caller waits); None when the trace holds no such range."""
    if tr is None:
        return None
    rs = ranges(tr, name)
    if not rs:
        return None
    frames = [(s, e, name) for s, e in rs]
    s = dataclasses.replace(tr, frames=frames).launched_under_s(
        f"^{re.escape(name)}$")
    return s / tr.steps * 1e3


def host_ms(tr, name: str) -> float | None:
    """Host milliseconds a step inside the ranges named ``name``."""
    if tr is None:
        return None
    rs = ranges(tr, name)
    if not rs:
        return None
    return sum(e - s for s, e in rs) * 1e-3 / tr.steps


def idle_ms(tr, name: str) -> float | None:
    """Device idle milliseconds a step spent waiting on a launch from inside
    the ranges named ``name``.

    Each idle gap of the card ends with a kernel or copy that the host had
    not launched yet.  The gap is placed on the host's clock as the span of
    its own length that ends at that launch, and the part of it inside the
    ranges counts; the first gap of the trace runs from the ranges' start.
    The gap's length is read on the device's clock and the launch on the
    host's, so the profiler's two clocks are never compared: on the card's
    machine they can drift apart by several percent of a step.  None when
    the trace holds no such range."""
    if tr is None:
        return None
    rs = _merge(ranges(tr, name))
    if not rs:
        return None
    starts = [s for s, _ in rs]
    idle, prev_end = 0.0, -math.inf
    for s, e, _, corr in tr.device:
        t = tr.launches.get(corr)
        if s > prev_end and t is not None:
            a = t - (s - prev_end)
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(rs) and rs[i][0] < t:
                idle += max(0.0, min(t, rs[i][1]) - max(a, rs[i][0]))
                i += 1
        prev_end = max(prev_end, e)
    return idle * 1e-3 / tr.steps

