"""One run of one cell: set-up, the measured window, the traced windows,
the per-layer metrics and the check, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own that :class:`Registry` finds by the
name ``BENCHMARK.json`` gives it:

* ``configs/<name>.json``: the sizes, the step driver that runs them
  (``drivers/<driver>.py``) and the source;
* ``traffic/<name>.json``: the training recipe the cell runs;
* ``metrics/<name>.py``: a reader, ``read(ctx) -> float | None``;
* ``limits/<workload>.json``: the limits of the cell's check.

A driver (``drivers/<name>.py``) has a ``Driver(config, traffic, seed,
device, limits, span)`` with ``setup(warmup)`` (which leaves the seconds of
each set-up phase in ``phases``), ``window(seconds)`` (the measured window:
its end-to-end readings by name, as :func:`portbench.bench.window.
train_window` returns them), ``step()`` (the unit of work of the traced
windows), ``shapes()``, ``counters()``, ``describe()``, ``release()`` and
``check()``.  The harness times set-up itself (``setup_s``) and takes
every other end-to-end metric by its name from the driver's window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

from portbench.bench import trace as tracemod
from portbench.reference import compare

#: Top-level modules that may not be loaded in a run (the JAX package and
#: JAX itself), compared by whole top-level name.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Steps run after the check's steps, before the window: every shape the
#: window uses is then warm.
WARMUP_STEPS = 2
#: Steps of the traced window that device metrics read.
TRACE_STEPS = 30
#: Steps of the window traced with Python frames (kernel attribution).
STACK_STEPS = 3
#: Host span names in the trace carry this prefix.
SPAN = tracemod.SPAN_PREFIX


class Registry:
    """Finds a cell's files by name under ``base`` (the ``portbench``
    directory, or another laid out alike)."""

    def __init__(self, base: Path):
        self.base = Path(base)

    def _json(self, kind: str, name: str) -> dict:
        path = self.base / kind / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file named {name!r}: {path}")
        with open(path) as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def _module(self, kind: str, name: str):
        path = self.base / kind / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind} file named {name!r}: {path}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metric(self, name: str):
        return self._module("metrics", name)

    def driver(self, name: str):
        return self._module("drivers", name)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads."""

    workload: str
    config: dict
    traffic: dict
    shapes: object          # the driver's shapes (bench/work.GNNStep)
    e2e: dict               # the untraced window's end-to-end readings
    trace: tracemod.Trace | None
    stack: tracemod.Trace | None
    counters: dict


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return (out.stdout or out.stderr).strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read: {exc}"


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules loaded in this process)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.partition(".")[0] for n in names} & set(FORBIDDEN))


class _Spans:
    """The harness's host spans: free outside the traced windows."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(SPAN + name)


def _traced(drv, spans, steps: int, with_stack: bool) -> tracemod.Trace:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    spans.on = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=with_stack) as prof:
            for _ in range(steps):
                drv.step()
            torch.cuda.synchronize()
    finally:
        spans.on = False
    return tracemod.read_profile(prof, steps, SPAN + "step")


def run_cell(bench: dict, registry: Registry, workload: str, seed: int,
             seconds: float, trace: bool, t_start: float,
             device: str = "cuda", log=None) -> dict:
    """One run; returns the result object (the last line's contents).
    ``device="cpu"`` runs the program's plain path with no device metric
    (the CPU tests' drive of the rest of a run)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    spans = _Spans()
    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t_inputs = time.perf_counter()
    drv = registry.driver(config["driver"]).Driver(
        config, traffic, seed, device, registry.limits(workload), spans)
    t_setup = time.perf_counter()
    drv.setup(WARMUP_STEPS)
    sync()
    log(f"set-up: start to inputs {t_inputs - t_start!r} s, inputs "
        f"{t_setup - t_inputs!r} s, program {time.perf_counter() - t_setup!r}"
        f" s ({drv.phases})")
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    setup_s = time.perf_counter() - t_start

    win = drv.window(seconds)
    e2e = dict(win["metrics"], setup_s=setup_s)
    log(f"{win['log']}, set-up {setup_s!r} s")
    if on_card:
        log(f"card: {card()}; torch {torch.__version__}")

    result = {"correct": False, "attempted": win["attempted"],
              "failed": win["failed"]}
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        tr = _traced(drv, spans, TRACE_STEPS, with_stack=False)
        st = _traced(drv, spans, STACK_STEPS, with_stack=True)
        ctx = Context(workload, config, traffic, drv.shapes(), e2e, tr,
                      st, drv.counters())
        for m in bench["per_layer"]:
            if not applies(m, workload):
                continue
            value = registry.metric(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        for m in bench["end_to_end"]:
            if not applies(m, workload):
                continue
            if m["name"] not in e2e:
                raise KeyError(f"the {config['driver']} driver's window "
                               f"reads no {m['name']!r}; it reads "
                               f"{sorted(e2e)}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if on_card \
        else 0
    log(drv.describe())
    drv.release()
    nums = drv.check()
    result["correct"] = compare.passed(nums) and result["failed"] == 0
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": peak, **dev_extra}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n["name"]: {"value": n["value"], "limit": n["limit"]}
                       for n in nums}
    for n in nums:
        log(f"check {n['name']} {n['value']!r} limit {n['limit']!r}")
    return result
