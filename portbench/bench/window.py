"""The measured window of a training cell, shared by the drivers whose
timed call is one optimizer step.

A driver owns its window (``Driver.window(seconds)``) and returns its
end-to-end readings by name; a training driver hands its ``step`` to
:func:`train_window`, which reads ``step_ms``, ``step_p95_ms`` and
``peak_mem_gb``.  A driver of another kind (a serving loop) measures its
own window and names its own readings.
"""
from __future__ import annotations

import math
import time


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank: the value below which 95 % of
    the steps lie."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def train_window(step, seconds: float, on_card: bool) -> dict:
    """Run ``step()`` (one optimizer step through its loss read-back, which
    returns the loss) back to back until ``seconds`` have passed.

    Returns ``{"metrics": {...}, "attempted": steps, "failed": steps whose
    loss is not finite, "log": a line for standard error}``.  ``step_ms``
    is the window's wall time over its steps, ``step_p95_ms`` the tail of
    every step's time, ``peak_mem_gb`` the allocator's peak over the window
    (its count is reset when the window opens).
    """
    import torch

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        losses.append(step())
        te = time.perf_counter()
        times.append(te - ts)
        if te - t0 >= seconds:
            break
    window_s = te - t0
    step_ms = window_s / len(times) * 1e3
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    return {"metrics": {"step_ms": step_ms, "step_p95_ms": p95(times) * 1e3,
                        "peak_mem_gb": peak / 1e9},
            "attempted": len(times),
            "failed": sum(not math.isfinite(v) for v in losses),
            "log": f"window: {len(times)} steps in {window_s!r} s, "
                   f"step_ms {step_ms!r}"}
