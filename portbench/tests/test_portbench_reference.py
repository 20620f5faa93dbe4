"""The plain reference against the port on the CPU at a tiny size (the
port's plain route), and the frozen graph generator against the port's."""
import numpy as np
import pytest
import torch

from portbench.bench.graphgen import synthetic_graph
from portbench.bench.harness import Registry
from portbench.reference import compare
from repro_torch.graph.data import arxiv_like, flickr_like


@pytest.mark.parametrize("maker,args", [
    (arxiv_like, ("arxiv-like", 128, 40, 0.5, 2.0, 169_343, 1_166_243)),
    (flickr_like, ("flickr-like", 500, 7, 0.4, 3.0, 89_250, 899_756))])
@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_generator_is_the_ports(maker, args, seed):
    name, f, c, hom, noise, n_full, e_full = args
    scale = 0.004
    n = max(512, int(n_full * scale))
    e = max(4 * n, int(e_full * scale))
    want = maker(scale, seed)
    got = synthetic_graph(name, n, e, f, c, hom, noise, seed)
    for key in ("features", "labels", "edge_src", "edge_dst", "gcn_weight",
                "mean_weight", "train_mask", "val_mask", "test_mask"):
        assert np.array_equal(getattr(want, key).numpy(), getattr(got, key))


WORKLOADS = ["sage-arxiv.iexact", "sage-flickr.iexact", "sage-arxiv.rp0",
             "sage-arxiv.fp32"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_follows_the_port(tiny, workload):
    bench, base = tiny
    reg = Registry(base)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = reg.config(cell["config"])
    drv = reg.driver(config["driver"]).Driver(
        config, reg.traffic(cell["traffic"]), 7, "cpu", {})
    drv.setup(0)
    assert drv.compiled.cfg.layer_compression()[0] is None or \
        drv.compiled.cfg.layer_compression()[0].impl == "auto"
    prog = drv.readings
    drv.release()
    gaps = compare.readings_gaps(prog, drv.reference())
    # the same arithmetic on the same device: equal up to the first
    # moment's division by (1 - b1)
    assert max(gaps.values()) < 1e-6, gaps
    assert all(np.isfinite(prog["losses"]))


def test_tf32_rounding_of_the_control():
    from portbench.reference.sage import _tf32
    one_ulp = 2.0 ** -10        # TF32 keeps 10 mantissa bits
    x = torch.tensor([1.0, 1.0 + one_ulp / 4, 1.0 + 3 * one_ulp / 4,
                      -(1.0 + 3 * one_ulp / 4), 3.0e-3])
    got = _tf32(x)
    assert got[:4].tolist() == [1.0, 1.0, 1.0 + one_ulp, -(1.0 + one_ulp)]
    # every result has its 13 low mantissa bits clear
    assert not (got.view(torch.int32) & 0x1FFF).any()
    assert abs(got[4].item() / 3.0e-3 - 1) < 2.0 ** -11
