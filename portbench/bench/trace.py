"""Reading a ``torch.profiler`` trace of the card (CUPTI): the device's busy
intervals, kernel time by name, the idle gaps named by what the host was
doing, and which host frames launched which kernels.

The method is that of the port's bring-up profiling (``chip_smoke.
profile_call``): device activity is every kernel, copy and fill on the
card; busy time is the union of their intervals over the traced window,
and idle time the rest of the window.  Timestamps come from the profiler's
exported chrome trace, in microseconds on one clock for host and device.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import re
import tempfile

#: Trace categories of activity on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The harness's own host spans (``torch.profiler.record_function``).
SPAN_PREFIX = "portbench/"


@dataclasses.dataclass
class Trace:
    """One traced window of ``steps`` timed steps."""

    device: list        # (start_us, end_us, name, correlation), by start
    launches: dict      # correlation -> host time of the launch call (us)
    spans: list         # (start_us, end_us, name): the harness's spans
    ops: list           # (start_us, end_us, name): host operators
    frames: list        # (start_us, end_us, name): Python frames (with_stack)
    steps: int
    window: tuple       # (start_us, end_us): first step's start, last's end

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self) -> list:
        """The union of the device intervals, clipped to the window."""
        w0, w1 = self.window
        merged: list[list[float]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def kernel_s(self, pattern: str) -> float | None:
        """Seconds of device activity whose name matches ``pattern`` (a
        regular expression, searched); None when nothing matches."""
        rx = re.compile(pattern)
        hits = [e - s for s, e, name, _ in self.device if rx.search(name)]
        return sum(hits) * 1e-6 if hits else None

    def launched_under_s(self, frame_pattern: str) -> float | None:
        """Seconds of device activity launched while a host frame whose
        name matches ``frame_pattern`` was open (needs a trace taken with
        ``with_stack``); None when no such frame was seen."""
        rx = re.compile(frame_pattern)
        spans = _merge([(s, e) for s, e, name in self.frames
                        if rx.search(name)])
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0.0
        for s, e, _, corr in self.device:
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total * 1e-6

    def top_ops(self, n: int = 10) -> list:
        """The ``n`` device operations that took most time: [name, s]."""
        tot: dict[str, float] = {}
        for s, e, name, _ in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time of the window grouped by what the host was doing:
        each gap is named by the harness span and the host operator inside
        which the kernel that ends the gap was launched (the work the
        device waited for); [name, s], the ``n`` largest."""
        busy = self.busy()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        starts = [s for s, _, _, _ in self.device]
        span_starts = [s for s, _, _ in self.spans]
        op_starts = [s for s, _, _ in self.ops]
        tot: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            i = bisect.bisect_left(starts, b)
            corr = self.device[i][3] if i < len(self.device) else None
            t = self.launches.get(corr, b)
            name = (f"{_innermost(self.spans, span_starts, t)}|"
                    f"{_innermost(self.ops, op_starts, t)}")
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                [:n]]


def _merge(intervals):
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(intervals, starts, t: float, look: int = 256) -> str:
    """The name of the latest-started interval that holds ``t`` (for
    nested intervals, the innermost), looking back over the ``look``
    intervals that started last before it; "-" for none."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        s, e, name = intervals[j]
        if e >= t:
            return name
    return "-"


def read_profile(prof, steps: int, step_span: str) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``: its
    chrome trace is written to a temporary file, read and deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    device, launches, spans, ops, frames = [], {}, [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((s, e, name, args.get("correlation")))
        elif cat in ("cuda_runtime", "cuda_driver"):
            if "correlation" in args:
                launches[args["correlation"]] = s
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((s, e, name))
        elif cat == "cpu_op":
            ops.append((s, e, name))
        elif cat == "python_function":
            frames.append((s, e, name))
    for lst in (device, spans, ops, frames):
        lst.sort(key=lambda iv: iv[0])
    step_spans = sorted((s, e) for s, e, name in spans if name == step_span)
    if not step_spans:
        raise RuntimeError(f"the trace holds no {step_span!r} span")
    return Trace(device, launches, spans, ops, frames, steps,
                 (step_spans[0][0], step_spans[-1][1]))
