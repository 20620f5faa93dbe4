"""The five readers of the program's spans on a hand-made chrome trace:
device time launched inside ``gnn/spmm``, ``gnn/linear`` and
``optim/adamw``, host time inside ``step`` and the device's idle time
inside it; None where the program has no such span (an older commit).
Then the ranges of a real step, profiled on the CPU, as the reader keeps
them."""
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.bench import spans
from portbench.bench import trace as tracemod
from portbench.bench.harness import Context, Registry

BASE = Path(__file__).resolve().parents[1]
METRICS = ("spmm_ms", "linear_ms", "adamw_ms", "host_step_ms", "stall_ms")


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def _launch(corr, at, start, dur, cat="kernel", name="k"):
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 1, correlation=corr),
            _x(cat, name, start, dur, correlation=corr)]


HARNESS = [
    _x("user_annotation", "portbench/step", 0, 100),
    _x("user_annotation", "portbench/readback", 85, 15),
    _x("user_annotation", "portbench/step", 100, 100),
]
#: Two steps of program ranges (the backward's on autograd's thread, 2),
#: and a range of a warm-up step before the window.
PROGRAM = [
    _x("cpu_op", "step", 2, 58),
    _x("cpu_op", "step/forward", 3, 17),
    _x("cpu_op", "gnn/spmm", 4, 6),
    _x("cpu_op", "gnn/linear", 11, 7),
    _x("cpu_op", "step/loss", 20, 5),
    _x("cpu_op", "step/backward", 25, 25),
    _x("cpu_op", "gnn/linear", 26, 9, tid=2),
    _x("cpu_op", "gnn/spmm", 36, 9, tid=2),
    _x("cpu_op", "optim/adamw", 50, 8),
    _x("cpu_op", "step", 102, 48),
    _x("cpu_op", "step/forward", 103, 12),
    _x("cpu_op", "gnn/spmm", 104, 7),
    _x("cpu_op", "step/backward", 115, 25),
    _x("cpu_op", "optim/adamw", 140, 8),
    _x("cpu_op", "gnn/spmm", -50, 10),
]
DEVICE = [
    *_launch(1, 5, 10, 20),          # gnn/spmm
    *_launch(2, 12, 30, 10),         # gnn/linear
    *_launch(3, 22, 45, 2),          # step/loss, in no layer's span
    *_launch(4, 27, 47, 10),         # gnn/linear, backward
    *_launch(5, 40, 57, 10),         # gnn/spmm, backward
    *_launch(6, 52, 70, 5),          # optim/adamw
    *_launch(7, 78, 80, 5, "gpu_memcpy", "Memcpy DtoH"),   # the read-back
    *_launch(8, 105, 120, 20),       # gnn/spmm
    *_launch(9, 145, 150, 5),        # optim/adamw
    *_launch(10, -45, -40, 5),       # before the window
]


def _trace(events):
    return tracemod.read_profile(_Prof(events), 2, "portbench/step")


def _ctx(tr):
    return Context("sage-arxiv.iexact", {}, {}, None, {}, tr, None, {})


#: ms a step: spmm (20 + 10 + 20) / 2 µs, linear (10 + 10) / 2, AdamW
#: (5 + 5) / 2; the step ranges (58 + 48) / 2 µs on the host.  Stall: each
#: idle gap of the card, as long as it is, ends at the launch of the kernel
#: that ends it; inside the step ranges lie 2-5 (the 45 µs gap before
#: kernel 1), 17-22, 49-52, 102-105 and 135-145: (3 + 5 + 3 + 3 + 10) / 2.
WANT = {"spmm_ms": 0.025, "linear_ms": 0.010, "adamw_ms": 0.005,
        "host_step_ms": 0.053, "stall_ms": 0.012}


def _shifted(events, us):
    """``events`` with the device's clock ``us`` ahead of the host's."""
    return [dict(e, ts=e["ts"] + us)
            if e["cat"] in ("kernel", "gpu_memcpy") else e for e in events]


@pytest.mark.parametrize("name", METRICS)
def test_metric_on_a_known_trace(name):
    value = Registry(BASE).metric(name).read(_ctx(_trace(
        HARNESS + PROGRAM + DEVICE)))
    assert value == pytest.approx(WANT[name], abs=1e-12)


@pytest.mark.parametrize("name", METRICS)
def test_metric_is_none_without_the_program_spans(name):
    metric = Registry(BASE).metric(name)
    others = [_x("cpu_op", "aten::mm", 5, 3), _x("cpu_op", "stepper", 2, 58)]
    assert metric.read(_ctx(_trace(HARNESS + others + DEVICE))) is None
    assert metric.read(_ctx(None)) is None


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_alike_on_an_offset_device_clock(name):
    """The profiler's host and device clocks need not agree: the readers
    compare launches with host ranges, and take only lengths from the
    device."""
    value = Registry(BASE).metric(name).read(_ctx(_trace(
        HARNESS + PROGRAM + _shifted(DEVICE, 5000.0))))
    assert value == pytest.approx(WANT[name], abs=1e-12)


def test_ranges_keep_the_window():
    tr = _trace(HARNESS + PROGRAM + DEVICE)
    assert spans.ranges(tr, "step") == [(2.0, 60.0), (102.0, 150.0)]
    assert len(spans.ranges(tr, "gnn/spmm")) == 3


def test_ranges_of_a_profiled_step():
    """A CPU step of the program under the profiler: its ranges reach the
    reader as host operators, nested inside the harness's step span."""
    from repro_torch.engine.compile import compile_plan
    from repro_torch.engine.plan import ExecutionPlan
    from repro_torch.graph import GNNConfig, cora_like
    from repro_torch.graph.models import GNN
    from repro_torch.optim import AdamWConfig

    g = cora_like(scale=0.2, seed=0)
    cfg = GNNConfig(arch="sage", hidden=(16, 16), n_classes=g.num_classes)
    model = GNN(cfg, g.n_feats, generator=torch.Generator().manual_seed(0))
    compiled = compile_plan(g, cfg, ExecutionPlan(), model,
                            AdamWConfig(lr=5e-3), "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for epoch in range(2):
            with record_function("portbench/step"):
                float(compiled.step(epoch))
    tr = tracemod.read_profile(prof, 2, "portbench/step")
    count = {n: len(spans.ranges(tr, n)) for n in
             ("step", "step/forward", "step/loss", "step/backward",
              "optim/adamw", "gnn/spmm", "gnn/linear")}
    assert count == {"step": 2, "step/forward": 2, "step/loss": 2,
                     "step/backward": 2, "optim/adamw": 2, "gnn/spmm": 10,
                     "gnn/linear": 12}
    assert spans.host_ms(tr, "step") > 0
    # no device on the CPU: nothing launched, nothing idle to attribute
    assert spans.launched_ms(tr, "gnn/spmm") == 0.0
