"""Counters, gauges and windowed histograms with near-zero cost when
disabled (the reference's ``repro.obs.metrics``).

A disabled :class:`MetricsRegistry` hands out shared null singletons whose
methods are empty: producers instrument unconditionally
(``registry.counter("engine/recompiles").inc()``) and pay one no-op method
call when observability is off.  Like the tracer, the module keeps one
*active* registry (:func:`set_metrics` / :func:`get_metrics`, disabled by
default) for producers that have no session at hand (the compiled steps'
build counter).

:class:`Histogram` keeps cumulative moments **and** a bounded window of the
most recent observations: the feature pager's ``pager/overlap_frac`` as one
end-of-run scalar would hide early stalls behind a steady-state average.
"""
from __future__ import annotations

from collections import deque


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def max(self, v: float) -> None:
        if v > self.value:
            self.value = v


class Histogram:
    """Cumulative count/total/min/max plus a sliding window of the last
    ``window`` observations (recent behavior vs lifetime average)."""

    __slots__ = ("count", "total", "vmin", "vmax", "_window")

    def __init__(self, window: int = 64):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self._window: deque = deque(maxlen=max(1, int(window)))

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self._window.append(v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def window_size(self) -> int:
        return len(self._window)

    @property
    def window_mean(self) -> float:
        return sum(self._window) / len(self._window) if self._window else 0.0

    @property
    def window_min(self) -> float:
        return min(self._window) if self._window else 0.0

    @property
    def window_max(self) -> float:
        return max(self._window) if self._window else 0.0

    def snapshot(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "min": self.vmin if self.count else 0.0,
                "max": self.vmax if self.count else 0.0,
                "window_mean": self.window_mean,
                "window_min": self.window_min,
                "window_max": self.window_max,
                "window_size": self.window_size}


class _NullCounter:
    __slots__ = ()
    value = 0

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = 0.0

    def set(self, v: float) -> None:
        pass

    def max(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    count = 0
    mean = 0.0
    window_size = 0
    window_mean = 0.0
    window_min = 0.0
    window_max = 0.0

    def observe(self, v: float) -> None:
        pass

    def snapshot(self) -> dict:
        return {}


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Name → metric map.  Disabled registries never allocate: every
    accessor returns the shared null singleton."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, window: int = 64) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(window=window)
        return h

    def snapshot(self) -> dict:
        out: dict = {}
        out.update({k: c.value for k, c in self._counters.items()})
        out.update({k: g.value for k, g in self._gauges.items()})
        out.update({k: h.snapshot() for k, h in self._hists.items()})
        return out


#: Process-wide registry for producers without a session handle; disabled
#: until an :class:`~repro_torch.obs.session.ObsSession` activates its own.
_ACTIVE = MetricsRegistry(enabled=False)


def set_metrics(registry: MetricsRegistry) -> MetricsRegistry:
    """Install the active registry; returns the previous one."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, registry
    return prev


def get_metrics() -> MetricsRegistry:
    return _ACTIVE
