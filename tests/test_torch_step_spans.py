"""The training step's spans on the profiler's clock
(``repro_torch.obs.trace``), on the CPU.

Under a ``torch.profiler.profile``, one ``CompiledFull`` step of a 3-layer
SAGE holds ``step`` with ``step/forward``, ``step/loss``, ``step/backward``
and ``optim/adamw`` inside it, in that order, five ``gnn/spmm`` ranges
(three in the forward, two in the backward) and six ``gnn/linear`` ranges
(three in each), all as ``cpu_op`` events: what a reader of the profiler's
chrome trace keeps.  A tracer installed beside the profiler records the same
spans with their arguments.  Neither the profiler nor a session moves a bit
of training, and with neither on, ``span`` hands out one shared no-op
object.  A torch that renamed the fast range entry point would fail here
rather than silently drop the ranges.
"""
import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.compressor import CompressionConfig
from repro_torch.engine.compile import compile_plan
from repro_torch.engine.plan import ExecutionPlan, KernelPolicy, ObsPolicy
from repro_torch.engine.runner import run
from repro_torch.graph import GNNConfig
from repro_torch.graph import cora_like
from repro_torch.graph.models import GNN
from repro_torch.obs.session import NULL_SESSION
from repro_torch.obs.trace import Tracer, set_tracer, span, stopwatch
from repro_torch.optim import AdamWConfig
from torch_threads import one_thread  # noqa: F401

#: The step's span names.
STEP_NAMES = ("step", "step/forward", "step/loss", "step/backward",
              "optim/adamw", "gnn/spmm", "gnn/linear")
#: Compressed (RP 8, INT2, the quantizer's plain path) and uncompressed
#: layers: the two spellings of a layer's product.
COMPS = {"rp8": CompressionConfig(bits=2, group_size=64, rp_ratio=8),
         "fp32": None}
PLAN = ExecutionPlan(kernel=KernelPolicy(impl="torch"))


@pytest.fixture(scope="module")
def g():
    return cora_like(scale=0.2, seed=0)


def _cfg(g, comp, hidden=(32, 32)):
    return PLAN.kernel.apply(GNNConfig(arch="sage", hidden=hidden,
                                       n_classes=g.num_classes,
                                       compression=comp))


def _compiled(g, comp):
    cfg = _cfg(g, comp)
    model = GNN(cfg, g.n_feats, generator=torch.Generator().manual_seed(0))
    return compile_plan(g, cfg, PLAN, model, AdamWConfig(lr=5e-3), "cpu")


def _cpu_ops(prof, tmp_path, names=STEP_NAMES):
    """The step's ranges in the profiler's chrome trace: (start, end, name)
    of each ``cpu_op`` event named in ``names``, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                  and e.get("name") in names)


def _inside(ranges, outer, name):
    s0, e0, _ = outer
    return [r for r in ranges if r[2] == name and s0 <= r[0] and r[1] <= e0]


@pytest.mark.parametrize("comp", sorted(COMPS))
def test_step_ranges_in_the_profiler_trace(g, comp, tmp_path):
    compiled = _compiled(g, COMPS[comp])
    compiled.step(0)                      # warm: the ranges of one step
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            compiled.step(1)
    finally:
        set_tracer(prev)
    ranges = _cpu_ops(prof, tmp_path)
    count = {n: sum(r[2] == n for r in ranges) for n in STEP_NAMES}
    assert count == {"step": 1, "step/forward": 1, "step/loss": 1,
                     "step/backward": 1, "optim/adamw": 1, "gnn/spmm": 5,
                     "gnn/linear": 6}
    [step] = [r for r in ranges if r[2] == "step"]
    parts = [_inside(ranges, step, n)
             for n in ("step/forward", "step/loss", "step/backward",
                       "optim/adamw")]
    assert all(len(p) == 1 for p in parts)
    fwd, loss, bwd, adamw = (p[0] for p in parts)
    assert fwd[1] <= loss[0] and loss[1] <= bwd[0] and bwd[1] <= adamw[0]
    assert len(_inside(ranges, fwd, "gnn/spmm")) == 3
    assert len(_inside(ranges, bwd, "gnn/spmm")) == 2
    assert len(_inside(ranges, fwd, "gnn/linear")) == 3
    assert len(_inside(ranges, bwd, "gnn/linear")) == 3
    # the tracer beside the profiler: the same spans, in the same order,
    # with their arguments
    assert [s.name for s in tracer.spans] == [r[2] for r in ranges]
    assert tracer.spans[0].args == {"epoch": 1}
    linear = [s.args for s in tracer.spans if s.name == "gnn/linear"]
    assert linear == [{"layer": li, "dir": d} for li, d in
                      ((0, "fwd"), (1, "fwd"), (2, "fwd"),
                       (2, "bwd"), (1, "bwd"), (0, "bwd"))]


def _trained(g, plan, profiled: bool):
    ctx = (profile(activities=[ProfilerActivity.CPU]) if profiled
           else contextlib.nullcontext())
    with ctx:
        r = run(g, _cfg(g, COMPS["rp8"]), plan, n_epochs=3, seed=0,
                device="cpu")
    return ([h[1] for h in r["history"]],
            [p.detach().clone() for p in r["model"].parameters()])


@pytest.mark.parametrize("on", ["profiler", "session", "both"])
def test_spans_move_no_bit(g, on):
    """Losses and parameters equal bit for bit with the profiler recording
    and with an obs session tracing, alone and together."""
    obs = ObsPolicy(enabled=True, trace=True)
    plan_on = (dataclasses.replace(PLAN, obs=obs) if on != "profiler"
               else PLAN)
    losses, params = _trained(g, PLAN, profiled=False)
    losses_on, params_on = _trained(g, plan_on, profiled=on != "session")
    assert losses == losses_on
    assert all(torch.equal(p, q) for p, q in zip(params, params_on))


def test_span_without_tracer_or_profiler_is_the_shared_null(tmp_path):
    prev = set_tracer(None)
    try:
        null = span("step")
        assert isinstance(null, contextlib.nullcontext)
        assert span("gnn/linear", layer=0, dir="fwd") is null
        assert NULL_SESSION.span("mesh/round", round=0) is null
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = span("step")
            with on:
                with stopwatch("epoch"):
                    pass
        assert on is not null
        assert span("step") is null       # off again once the profiler ends
    finally:
        set_tracer(prev)
    # stopwatch's span takes the same path
    assert [r[2] for r in _cpu_ops(prof, tmp_path, ("step", "epoch"))] \
        == ["step", "epoch"]
