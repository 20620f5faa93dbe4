"""The check fails what it exists to catch: a run driven on the CPU at a
tiny size (the harness's look for a chip skipped) with the timed path
broken underneath comes out not correct, a sound one correct; and the
control, the reference computed in TF32 in the program's place, fails the
cell's limits."""
import time

import pytest

from portbench.bench.faults import FAULTS, planted
from portbench.bench.harness import Registry, run_cell
from portbench.reference import compare

WORKLOADS = ["sage-arxiv.iexact", "sage-flickr.iexact", "sage-arxiv.rp0",
             "sage-arxiv.fp32"]


def _run(tiny, workload, seed):
    bench, base = tiny
    return run_cell(bench, Registry(base), workload, seed, 0.05, False,
                    time.perf_counter(), device="cpu", log=lambda m: None)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(tiny, workload):
    res = _run(tiny, workload, 2**31 + 3)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    assert set(res["metrics"]) == {"step_ms", "step_p95_ms", "peak_mem_gb",
                                   "setup_s"}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", ["sage-arxiv.iexact", "sage-arxiv.fp32"])
def test_fault_is_not_correct(tiny, workload, fault):
    with planted(fault):
        res = _run(tiny, workload, 5)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(tiny, workload):
    bench, base = tiny
    reg = Registry(base)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = reg.config(cell["config"])
    drv = reg.driver(config["driver"]).Driver(
        config, reg.traffic(cell["traffic"]), 9, "cpu", reg.limits(workload))
    nums = compare.numbers(drv.reference(tf32=True), drv.reference(),
                           drv.limits)
    assert not compare.passed(nums), nums
