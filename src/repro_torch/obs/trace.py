"""Host-side span tracer: nested wall-clock spans, exported as JSONL and
Chrome ``trace_event`` JSON (the reference's ``repro.obs.trace``; a trace
from either package loads alike at https://ui.perfetto.dev).

**Spans are host time.**  A :class:`Tracer` records ``time.perf_counter``
bookkeeping on the host, on its own clock from 0.  On the card a span
measures the host's enqueueing of the work up to the span's end, not the
device's execution of it: PyTorch returns before the device finishes.  Only
a span whose body reads a result back waits for the device: the engine's
``epoch`` span (the loss), its ``obs/quant_probe`` span (the probe's one
copy to the host) and serving's ``serve/prefill``.  No span calls
``torch.cuda.synchronize``: that would stall the side streams' copies (the
feature pager's, the stash arena's) and change what is measured.

**Spans on the profiler's clock.**  While a ``torch.profiler`` records,
every span is also a profiler range of the same name (a ``cpu_op`` event
in its chrome trace, on the clock of the kernel launches inside it),
whether or not a tracer is installed; the profiler is the only switch.
Ranges carry the name alone, a tracer also the arguments.  The training
step's spans: ``step`` around
:meth:`~repro_torch.engine.compile.CompiledFull.step`, holding
``step/forward``, ``step/loss`` and ``step/backward``; ``optim/adamw``
around each AdamW update; ``gnn/spmm`` around each aggregation;
``gnn/linear`` around each layer's product with its compression, forward
and backward (``layer``, ``dir``).  The backward's spans open on
autograd's thread while the caller waits in ``torch.autograd.grad``, so
they nest under ``step/backward``.

The module keeps one *active* tracer (:func:`set_tracer` /
:func:`get_tracer`): producers call the module-level :func:`span` /
:func:`stopwatch` and emit spans only when a tracer is installed or a
profiler records; with neither, :func:`span` returns one shared no-op
object after a flag check, so instrumented code costs well under a
microsecond a span when observability is off.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import time

import torch


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
#: ``_is_profiler_enabled`` is read on each span: a module attribute that
#: every ``torch.profiler`` sets while it records
_PROFILER = torch.autograd.profiler
_RANGE = torch._C._profiler._RecordFunctionFast


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install ``tracer`` as the process-wide active tracer; returns the
    previous one (restore it when the session ends)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, tracer
    return prev


def get_tracer() -> Tracer | None:
    return _ACTIVE


class _ProfiledSpan:
    """A span while a profiler records: a profiler range named ``name``
    around the tracer's span, when there is a tracer."""

    __slots__ = ("_range", "_span")

    def __init__(self, tracer: Tracer | None, name: str, args: dict):
        self._range = _RANGE(name)
        self._span = None if tracer is None else tracer.span(name, **args)

    def __enter__(self):
        self._range.__enter__()
        return None if self._span is None else self._span.__enter__()

    def __exit__(self, *exc):
        try:
            if self._span is not None:
                self._span.__exit__(*exc)
        finally:
            self._range.__exit__(*exc)
        return False


def open_span(tracer: Tracer | None, name: str, args: dict):
    """Span ``name`` with ``args`` on ``tracer`` (when not None) and, while
    a profiler records, a profiler range of that name; with neither, the
    shared no-op context."""
    if _PROFILER._is_profiler_enabled:
        return _ProfiledSpan(tracer, name, args)
    return _NULL_CM if tracer is None else tracer.span(name, **args)


def span(name: str, **args):
    """:func:`open_span` on the active tracer."""
    return open_span(_ACTIVE, name, args)


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
