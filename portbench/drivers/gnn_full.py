"""Full-graph GNN training through the port's engine: the driver of the
``sage-*`` configurations.

Set-up builds the graph and the weights from the seed, lowers the plan
with ``engine.compile.compile_plan`` (one ``CompiledFull`` for the whole
run) and drives it through its first steps, which are also the warm-up of
every shape the window uses.  The timed call is one optimizer step (one
epoch of the full graph): ``CompiledFull.step(epoch)`` and its loss read
back to the host; the window repeats it (:func:`portbench.bench.window.
train_window`).  The check reads the first three steps' losses, the
first gradient (from AdamW's first moment after one step) and each
parameter's change after three steps, and holds them against the plain
reference, which runs once the program's state is freed.
"""
from __future__ import annotations

import contextlib
import gc
import math
import time

import numpy as np
import torch

from portbench.bench.graphgen import make_graph
from portbench.bench.window import train_window
from portbench.bench.work import step_shapes
from portbench.reference import compare, sage

#: Steps the check follows; they are the run's first.
CHECK_STEPS = 3


def initial_params(dims, seed: int) -> list[np.ndarray]:
    """Weights ``N(0, 1/fan_in)`` and zero biases from ``seed``, in the
    engine's order ``[w0, b0, w1, ...]`` (``w`` is ``(2 d_in, d_out)``)."""
    rng = np.random.default_rng([int(seed) % (1 << 64), 0x5A6E])
    out = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        fan_in = 2 * d_in
        out.append((rng.standard_normal((fan_in, d_out), np.float32)
                    / np.float32(math.sqrt(fan_in))).astype(np.float32))
        out.append(np.zeros(d_out, np.float32))
    return out


def _recipe(traffic: dict) -> sage.Recipe | None:
    c = traffic.get("compression")
    return None if c is None else sage.Recipe(int(c["bits"]),
                                              int(c["group_size"]),
                                              int(c["rp_ratio"]),
                                              bool(c["vm"]))


class Driver:
    """One cell's program under test.  ``span(name)`` is the harness's
    host span around each call into the program."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 limits: dict, span=lambda name: contextlib.nullcontext()):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device, self.limits, self.span = device, limits, span
        self.graph = make_graph(config["graph"], self.seed % (1 << 64))
        m = config["model"]
        self.dims = (self.graph.n_feats, *[int(h) for h in m["hidden"]],
                     int(m["n_classes"]))
        self.params0 = initial_params(self.dims, self.seed)
        self.opt = dict(config["optimizer"])
        self.epoch = 0
        self.readings: dict = {}
        #: seconds each phase of the last set-up took (printed by the
        #: harness)
        self.phases: dict = {}

    def shapes(self):
        return step_shapes(self.config, self.traffic, self.graph.n_edges)

    # -------------------------------------------------------------- program
    def setup(self, warmup: int) -> None:
        """Compile the plan from the initial weights and run the check's
        steps and ``warmup`` more."""
        from repro_torch.core.compressor import CompressionConfig
        from repro_torch.engine.compile import compile_plan
        from repro_torch.engine.plan import ExecutionPlan
        from repro_torch.graph.data import Graph
        from repro_torch.graph.models import GNNConfig, params_from_numpy
        from repro_torch.optim import AdamWConfig

        m, c = self.config["model"], self.traffic.get("compression")
        comp = None if c is None else CompressionConfig(
            bits=int(c["bits"]), group_size=int(c["group_size"]),
            rp_ratio=int(c["rp_ratio"]), vm=bool(c["vm"]))
        cfg = GNNConfig(arch=m["arch"], hidden=tuple(m["hidden"]),
                        n_classes=int(m["n_classes"]), compression=comp)
        plan = ExecutionPlan.from_legacy(fused=self.traffic["fused"])
        cfg = plan.kernel.apply(cfg)
        h = self.graph
        g = Graph(h.name, *(torch.from_numpy(a) for a in (
            h.features, h.labels, h.edge_src, h.edge_dst, h.gcn_weight,
            h.mean_weight, h.train_mask, h.val_mask, h.test_mask)),
            num_classes=h.num_classes)
        model = params_from_numpy(
            [{"w": w, "b": b} for w, b in zip(self.params0[0::2],
                                              self.params0[1::2])],
            cfg, self.device)
        opt = AdamWConfig(lr=float(self.opt["lr"]), b1=float(self.opt["b1"]),
                          b2=float(self.opt["b2"]),
                          eps=float(self.opt["eps"]),
                          weight_decay=float(self.opt["weight_decay"]))
        self.epoch, self.readings = 0, {}
        t = time.perf_counter()
        with self.span("compile_plan"):
            self.compiled = compile_plan(g, cfg, plan, model, opt,
                                         self.device, seed=self.seed)
        self.phases = {"compile_plan": time.perf_counter() - t}
        start = [p.detach().clone() for p in model.flat_params()]
        losses = []
        for i in range(CHECK_STEPS):
            t = time.perf_counter()
            losses.append(self.step())
            self.phases[f"step{i}"] = time.perf_counter() - t
            if i == 0:
                # AdamW's first moment after one step is (1 - b1) g
                b1 = float(self.opt["b1"])
                grads = [(mo / (1 - b1)).cpu()
                         for mo in self.compiled.state["m"]]
                self.readings["grads"] = grads
                self.readings["grad_norms"] = [
                    float(torch.linalg.vector_norm(g.double())) for g in grads]
        self.readings["losses"] = losses
        self.readings["delta_norms"] = [
            float(torch.linalg.vector_norm((p.detach() - s).double()))
            for p, s in zip(model.flat_params(), start)]
        del start
        for _ in range(warmup):
            self.step()

    def step(self) -> float:
        """One timed step: an optimizer update of the full graph, through
        its loss read back to the host."""
        with self.span("step"):
            loss = self.compiled.step(self.epoch)
            with self.span("readback"):
                value = float(loss)
        self.epoch += 1
        return value

    def window(self, seconds: float) -> dict:
        """The measured window: timed steps back to back for ``seconds``."""
        return train_window(self.step, seconds, self.device != "cpu")

    def counters(self) -> dict:
        return {"stash_bytes": list(self.compiled.stash_bytes)}

    def describe(self) -> str:
        """The program's counters beside the benchmark's own reckoning."""
        return (f"stash bytes a layer {self.counters()['stash_bytes']}, "
                f"reckoned {self.shapes().stash_bytes()}")

    def release(self) -> None:
        """Free the program's state on the device."""
        self.compiled = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------- check
    def reference(self, tf32: bool = False) -> dict:
        """The plain reference's readings of the check's steps."""
        return sage.train(self.graph, self.params0, _recipe(self.traffic),
                          self.opt, CHECK_STEPS, self.device, tf32=tf32)

    def check(self) -> list[dict]:
        """The compared numbers, each with its limit."""
        return compare.numbers(self.readings, self.reference(), self.limits)
