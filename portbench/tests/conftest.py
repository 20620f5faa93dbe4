"""The benchmark's CPU tests: one torch thread a test module (the suite
runs several workers at once, and these shapes are tiny), and a tiny copy
of the benchmark's tree that the tests drive."""
import json
import shutil
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
#: Rows and drawn edges of the tiny graphs the tests run (about arxiv's
#: size at scale 0.004).
TINY = {"n_nodes": 677, "n_edges": 4664}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``(bench, base)``: BENCHMARK.json and a copy of ``portbench/`` whose
    configurations hold tiny graphs."""
    base = tmp_path_factory.mktemp("bench") / "portbench"
    shutil.copytree(ROOT / "portbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for path in (base / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["graph"].update(TINY)
        path.write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return bench, base
