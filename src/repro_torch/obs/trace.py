"""Host-side span tracer: nested wall-clock spans, exported as JSONL and
Chrome ``trace_event`` JSON (the reference's ``repro.obs.trace``; a trace
from either package loads alike at https://ui.perfetto.dev, and beside a
``torch.profiler`` device trace in the same timeline format).

**Spans are host time.**  Everything here is ``time.perf_counter``
bookkeeping on the host.  On the card a span measures the host's enqueueing
of the work up to the span's end, not the device's execution of it: PyTorch
returns before the device finishes.  Only a span whose body reads a result
back waits for the device: the engine's ``epoch`` span (the loss), its
``obs/quant_probe`` span (the probe's one copy to the host) and serving's
``serve/prefill``.  No span calls ``torch.cuda.synchronize``: that would
stall the side streams' copies (the feature pager's, the stash arena's) and
change what is measured.

The module keeps one *active* tracer (:func:`set_tracer` /
:func:`get_tracer`): producers call the module-level :func:`span` /
:func:`stopwatch` and emit spans only when a tracer is installed; with none
installed both are shared no-op objects, so instrumented code costs an
attribute check when observability is off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import time


@dataclasses.dataclass
class Span:
    """One closed (or still open) span; times are seconds relative to the
    tracer's origin."""

    name: str
    t0: float
    dur: float
    depth: int
    parent: int  # index into Tracer.spans, -1 for roots
    args: dict


class Tracer:
    """Nested-span recorder.  Single-threaded by design: spans nest on one
    stack, matching the engine's single-process epoch loop (each rank of a
    mesh has its own process, and so its own tracer)."""

    def __init__(self):
        self._origin = time.perf_counter()
        #: wall-clock epoch of the origin, for aligning with external traces
        self.origin_unix_s = time.time()
        self.spans: list[Span] = []
        self._stack: list[int] = []

    @contextlib.contextmanager
    def span(self, name: str, **args):
        idx = len(self.spans)
        s = Span(name, time.perf_counter() - self._origin, 0.0,
                 depth=len(self._stack),
                 parent=self._stack[-1] if self._stack else -1,
                 args=args)
        self.spans.append(s)
        self._stack.append(idx)
        try:
            yield s
        finally:
            self._stack.pop()
            s.dur = time.perf_counter() - self._origin - s.t0

    # ------------------------------------------------------------- export
    def jsonl_events(self) -> list[dict]:
        return [{"name": s.name, "ts_s": s.t0, "dur_s": s.dur,
                 "depth": s.depth, "parent": s.parent, "args": s.args}
                for s in self.spans]

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` dict: complete ("X") events in µs."""
        events = [{"name": s.name, "cat": "repro", "ph": "X",
                   "ts": s.t0 * 1e6, "dur": s.dur * 1e6,
                   "pid": 0, "tid": 0, "args": s.args}
                  for s in self.spans]
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_jsonl(self, path) -> None:
        lines = [json.dumps(e) for e in self.jsonl_events()]
        pathlib.Path(path).write_text("\n".join(lines) + "\n")

    def export_chrome(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps(self.chrome_trace()))


_ACTIVE: Tracer | None = None
_NULL_CM = contextlib.nullcontext()


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install ``tracer`` as the process-wide active tracer; returns the
    previous one (restore it when the session ends)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


def get_tracer() -> Tracer | None:
    return _ACTIVE


def span(name: str, **args):
    """Span on the active tracer; a shared no-op when none is installed."""
    return _ACTIVE.span(name, **args) if _ACTIVE is not None else _NULL_CM


class stopwatch:
    """The one timing idiom of the package: always measures ``elapsed_s``
    (host time); when given a name *and* a tracer is active, the measured
    interval is also emitted as a span.

    >>> with stopwatch("epoch", epoch=3) as sw:
    ...     work()
    >>> sw.elapsed_s
    """

    def __init__(self, name: str | None = None, **args):
        self._name, self._args = name, args
        self.elapsed_s = 0.0

    def __enter__(self) -> "stopwatch":
        self._cm = span(self._name, **self._args) if self._name else None
        if self._cm is not None:
            self._cm.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self._t0
        if self._cm is not None:
            self._cm.__exit__(*exc)
        return False
