"""The trace reader on a hand-made chrome trace: busy and idle time over
the window, kernel time by name, the idle gaps named by the host, and
kernels launched under a Python frame."""
import json

from portbench.bench import trace as tracemod


class _Prof:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


EVENTS = [
    _x("user_annotation", "portbench/step", 0, 100),
    _x("user_annotation", "portbench/step", 100, 100),
    _x("user_annotation", "portbench/readback", 90, 10),
    _x("python_function", "src/repro_torch/graph/models.py(97): spmm", 5, 20),
    _x("cpu_op", "aten::index_select", 6, 4),
    _x("cpu_op", "aten::mm", 120, 5),
    _x("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 1, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 121, 1, correlation=3),
    _x("kernel", "void indexSelectLargeIndex<float>", 10, 30, correlation=1),
    _x("kernel", "void quant_vec_kernel<2, 256, true>", 40, 20,
       correlation=2),
    _x("kernel", "void dequant_vec_kernel<2>", 150, 10, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH", 55, 10, correlation=4),
]


def _trace():
    return tracemod.read_profile(_Prof(EVENTS), 2, "portbench/step")


def test_window_and_busy():
    tr = _trace()
    assert tr.window == (0.0, 200.0)
    assert tr.busy() == [[10.0, 65.0], [150.0, 160.0]]
    assert abs(tr.busy_s() - 65e-6) < 1e-12
    assert abs(tr.window_s - 200e-6) < 1e-12


def test_kernel_names():
    tr = _trace()
    assert abs(tr.kernel_s(r"(?<![A-Za-z0-9_])(de)?quant_(vec|scalar)"
                           r"_kernel") - 30e-6) < 1e-12
    assert tr.kernel_s("no_such_kernel") is None
    [[name, s]] = tr.top_ops(1)
    assert name == "void indexSelectLargeIndex<float>"
    assert abs(s - 30e-6) < 1e-12


def test_launched_under_frame():
    tr = _trace()
    assert abs(tr.launched_under_s(r"graph/models\.py\(\d+\): spmm$")
               - 30e-6) < 1e-12
    assert tr.launched_under_s("nothing") is None


def test_idle_gaps_named_by_the_host():
    gaps = dict(_trace().idle_gaps())
    # 0-10 waits for the gather launched in index_select; 65-150 for the
    # kernel launched at 121 in aten::mm; 160-200 ends the window
    assert abs(gaps["portbench/step|aten::index_select"] - 10e-6) < 1e-12
    assert abs(gaps["portbench/step|aten::mm"] - 85e-6) < 1e-12
    assert abs(sum(gaps.values()) - 135e-6) < 1e-12
