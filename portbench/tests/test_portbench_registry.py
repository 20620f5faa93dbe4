"""A configuration, a traffic mix, a per-layer metric, a driver and a
cell's limits added as new files are found by name, with no file of the
harness edited."""
import json
import shutil
import time

import pytest

from portbench.bench.harness import Context, Registry, applies, run_cell


def test_new_files_are_found(tiny, tmp_path):
    bench, base = tiny
    new = tmp_path / "portbench"
    shutil.copytree(base, new)
    cfg = json.loads((new / "configs" / "sage-arxiv.json").read_text())
    cfg.update(name="sage-wide")
    cfg["model"]["hidden"] = [64, 64, 64]
    (new / "configs" / "sage-wide.json").write_text(json.dumps(cfg))
    (new / "traffic" / "int4-g64.json").write_text(json.dumps({
        "compression": {"bits": 4, "group_size": 64, "rp_ratio": 0,
                        "vm": False}, "fused": "off"}))
    (new / "metrics" / "layers_n.py").write_text(
        "def read(ctx):\n    return float(len(ctx.shapes.layers()))\n")
    (new / "limits" / "sage-wide.int4.json").write_text(json.dumps(
        {"limits": {"loss.0": 1e-6, "grad": 1e-6}}))
    bench = dict(bench, workloads=bench["workloads"] + [
        {"name": "sage-wide.int4", "config": "sage-wide",
         "traffic": "int4-g64", "chips": 1, "why": "test"}],
        per_layer=bench["per_layer"] + [
            {"name": "layers_n", "unit": "n", "better": "higher",
             "source": "program_counter", "layer": "test",
             "moves": "step_ms", "workloads": ["sage-wide.int4"]}])
    reg = Registry(new)
    res = run_cell(bench, reg, "sage-wide.int4", 1, 0.05, False,
                   time.perf_counter(), device="cpu", log=lambda m: None)
    assert res["correct"], res["check"]
    assert set(res["check"]) == {"loss.0", "grad"}
    metric = next(m for m in bench["per_layer"] if m["name"] == "layers_n")
    assert applies(metric, "sage-wide.int4")
    assert not applies(metric, "sage-arxiv.iexact")
    drv = reg.driver("gnn_full").Driver(cfg, reg.traffic("int4-g64"), 1,
                                        "cpu", {})
    ctx = Context("sage-wide.int4", cfg, {}, drv.shapes(), {"step_ms": 1.0},
                  None, None, {})
    assert reg.metric("layers_n").read(ctx) == 4.0


DRIVER = """
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "gnn_full_base", Path(__file__).with_name("gnn_full.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)


class Driver(_base.Driver):
    def window(self, seconds):
        win = super().window(seconds)
        win["metrics"] = {"lat_ms": 2.5}
        return win
"""


def test_a_driver_names_its_own_window(tiny, tmp_path):
    """A new driver file whose window reads other end-to-end metrics runs
    under the harness unchanged; a metric that no window reads is an
    error, not a silent gap."""
    bench, base = tiny
    new = tmp_path / "portbench"
    shutil.copytree(base, new)
    (new / "drivers" / "lat.py").write_text(DRIVER)
    cfg = json.loads((new / "configs" / "sage-arxiv.json").read_text())
    cfg.update(name="sage-lat", driver="lat")
    (new / "configs" / "sage-lat.json").write_text(json.dumps(cfg))
    shutil.copy(new / "limits" / "sage-arxiv.fp32.json",
                new / "limits" / "sage-lat.fp32.json")
    cell = {"name": "sage-lat.fp32", "config": "sage-lat", "traffic": "fp32",
            "chips": 1, "why": "test"}
    lat = {"name": "lat_ms", "unit": "ms", "better": "lower", "bound": 0.05,
           "source": "host_clock", "workloads": ["sage-lat.fp32"]}
    others = [dict(m, workloads=[w["name"] for w in bench["workloads"]])
              for m in bench["end_to_end"] if m["name"] != "setup_s"]
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    mine = dict(bench, workloads=bench["workloads"] + [cell],
                end_to_end=others + setup + [lat])
    res = run_cell(mine, Registry(new), "sage-lat.fp32", 4, 0.05, False,
                   time.perf_counter(), device="cpu", log=lambda m: None)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"lat_ms", "setup_s"}
    assert res["metrics"]["lat_ms"] == {"value": 2.5, "unit": "ms"}
    unread = dict(mine, end_to_end=bench["end_to_end"] + [lat])
    with pytest.raises(KeyError, match="step_ms"):
        run_cell(unread, Registry(new), "sage-lat.fp32", 4, 0.05, False,
                 time.perf_counter(), device="cpu", log=lambda m: None)


def test_every_named_file_exists():
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    bench = json.loads((root / "BENCHMARK.json").read_text())
    reg = Registry(root / "portbench")
    for c in bench["configs"]:
        assert (root / c["file"]).is_file()
        assert reg.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        reg.traffic(w["traffic"])
        assert reg.limits(w["name"])["limits"]
        reg.driver(reg.config(w["config"])["driver"])
    for m in bench["per_layer"]:
        assert callable(reg.metric(m["name"]).read)
