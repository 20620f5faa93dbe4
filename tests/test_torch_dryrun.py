"""The production dry run (``repro_torch.launch.dryrun``) and its counter
(``repro_torch.launch.comm_analysis``) on the CPU, against the reference's
``repro.launch.dryrun`` and ``repro.launch.hlo_analysis``.

* ``model_flops`` equals the reference's for all ten archs x four shapes.
* Each arch's parameters on the production (16, 16) mesh, as the port lays
  them out (``distribute_model`` of the meta model, in a ``"fake"`` world
  of 256 ranks), take the bytes a device that the reference's
  ``param_pspecs`` over ``jax.eval_shape(model.init)`` imply.
* A smoke-size train, prefill and decode cell on a (2, 2) fake world ends
  ``ok`` with the collectives each step issues, FLOPs counted on the local
  shards, and the reference's record keys.
* The ring model's wire bytes: for each collective kind, a synthetic
  program like ``tests/test_hlo_analysis.py``'s ``LOOPED`` (one collective
  in a loop of 12 trips) through the reference's ``analyze`` equals the
  port's bytes for the same kind, result bytes, group and trips.
* The counter sees a sharded product's local FLOPs and its collective, not
  the global product's FLOPs.
"""
import dataclasses
import math
import os
import textwrap

import jax
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.launch.hlo_analysis import analyze as j_analyze
from repro.models import Model as JModel
from repro.parallel import sharding as j_sharding
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, reduce_for_smoke
from repro_torch.launch import comm_analysis, dryrun
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import Model
from repro_torch.models.transformer import init_params
from repro_torch.parallel import sharding
from torch_threads import one_thread  # noqa: F401


class FakeMesh:
    """The reference tests' mesh stand-in: axis sizes alone."""

    def __init__(self, shape):
        self.shape = dict(shape)


def test_model_flops_are_the_references(monkeypatch):
    """Imported under the test's own ``XLA_FLAGS`` (the reference's module
    sets them at import), restored after."""
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as j_dryrun

    assert dryrun.ALL_ARCHS == j_dryrun.ALL_ARCHS
    assert dryrun.ALL_SHAPES == j_dryrun.ALL_SHAPES
    for arch in dryrun.ALL_ARCHS:
        for shape in dryrun.ALL_SHAPES:
            assert dryrun.model_flops(ARCHS[arch], SHAPES[shape]) == \
                j_dryrun.model_flops(J_ARCHS[arch], J_SHAPES[shape])


def _j_param_bytes(arch: str, sizes: dict) -> int:
    shapes = jax.eval_shape(
        lambda: JModel(J_ARCHS[arch]).init(jax.random.PRNGKey(0)))
    specs = j_sharding.param_pspecs(J_ARCHS[arch], shapes, FakeMesh(sizes))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes),
                          jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))):
        n = 1
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * (
                len(leaf.shape) - len(spec))):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_device_parameter_bytes_are_the_references(arch):
    cfg = ARCHS[arch]
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device="cpu")
        model = Model(cfg, init_params(cfg, torch.device("meta")),
                      device="meta")
        sharding.distribute_model(model, mesh)
        got = dryrun._local_bytes(model)
    assert got == _j_param_bytes(arch, {"data": 16, "model": 16})


#: The smoke cells: (shape, the collective kinds its step must issue).
SMOKE = {"train": (ShapeSpec("train_s", "train", 64, 8),
                   ("all-gather", "all-reduce", "reduce-scatter")),
         "prefill": (ShapeSpec("prefill_s", "prefill", 64, 8),
                     ("all-gather", "all-reduce")),
         "decode": (ShapeSpec("decode_s", "decode", 64, 8),
                    ("all-gather", "all-reduce"))}


@pytest.mark.parametrize("kind", sorted(SMOKE))
def test_smoke_cell_on_a_fake_world_ends_ok(kind):
    shape, kinds = SMOKE[kind]
    cfg = reduce_for_smoke(ARCHS["qwen3-moe-235b-a22b"])
    rec = dryrun.run_cell("qwen3-moe-235b-a22b", shape.name, "single",
                          cfg=dataclasses.replace(cfg, grad_accum=2),
                          shape=shape, mesh_shape=(2, 2))
    assert rec["status"] == "ok", rec
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes"}
    hlo = rec["hlo"]
    assert {k for k, n in hlo["collective_counts"].items() if n} == \
        set(kinds)
    assert hlo["collective_total_bytes"] == pytest.approx(
        sum(hlo["collective_wire_bytes_per_device"].values()))
    assert hlo["dot_flops_per_device"] > 0 and \
        hlo["hbm_bytes_per_device"] > 0
    assert rec["n_devices"] == 4
    assert rec["model_flops_global"] == dryrun.model_flops(cfg, shape)
    assert rec["memory"]["argument_bytes"] > 0 and \
        rec["memory"]["temp_bytes"] > 0


#: Each kind's instruction in the synthetic program: its HLO op, and the
#: result's shape (an all-gather's result is g times its operand, a
#: reduce-scatter's 1/g).
HLO_KINDS = {"all-gather": ("all-gather", "f32[128,16]", ", dimensions={0}"),
             "all-reduce": ("all-reduce", "f32[8,16]", ", to_apply=%add"),
             "reduce-scatter": ("reduce-scatter", "f32[1,16]",
                                ", dimensions={0}, to_apply=%add"),
             "all-to-all": ("all-to-all", "f32[8,16]", ", dimensions={0}"),
             "collective-permute": ("collective-permute", "f32[8,16]",
                                    ", source_target_pairs={{0,1}}")}


def _looped(op: str, shape: str, attrs: str, trips: int) -> str:
    groups = "" if op == "collective-permute" else \
        ", replica_groups=[16,16]<=[256]"
    return textwrap.dedent(f"""\
        HloModule looped

        %cond (param: (s32[], f32[8,16])) -> pred[] {{
          %param = (s32[], f32[8,16]) parameter(0)
          %gte = s32[] get-tuple-element(%param), index=0
          %constant.5 = s32[] constant({trips})
          ROOT %lt = pred[] compare(%gte, %constant.5), direction=LT
        }}

        %body (param.1: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {{
          %param.1 = (s32[], f32[8,16]) parameter(0)
          %gte.1 = s32[] get-tuple-element(%param.1), index=0
          %gte.2 = f32[8,16]{{1,0}} get-tuple-element(%param.1), index=1
          %coll = {shape}{{1,0}} {op}(%gte.2){groups}{attrs}
          %one = s32[] constant(1)
          %next = s32[] add(%gte.1, %one)
          ROOT %tup = (s32[], f32[8,16]) tuple(%next, %gte.2)
        }}

        %add (a: f32[], b: f32[]) -> f32[] {{
          %a = f32[] parameter(0)
          %b = f32[] parameter(1)
          ROOT %s = f32[] add(%a, %b)
        }}

        ENTRY %main (init: (s32[], f32[8,16])) -> (s32[], f32[8,16]) {{
          %init = (s32[], f32[8,16]) parameter(0)
          ROOT %while.1 = (s32[], f32[8,16]) while(%init), condition=%cond, body=%body
        }}
        """)


@pytest.mark.parametrize("kind", comm_analysis.KINDS)
def test_wire_bytes_are_the_references(kind):
    op, shape, attrs = HLO_KINDS[kind]
    trips = 12
    ref = j_analyze(_looped(op, shape, attrs, trips), n_devices=256)
    dims = [int(d) for d in shape[4:-1].split(",")]
    result = 4 * math.prod(dims)
    group = 2 if kind == "collective-permute" else 16
    got = trips * comm_analysis.wire_bytes(kind, result, group)
    assert ref["coll"][kind] == pytest.approx(got)
    assert ref["coll_total"] == pytest.approx(got)


def test_counter_sees_the_local_product_and_its_collective():
    """A (32, 5120) batch-sharded input times a (5120, 25600) weight split
    over both axes of (16, 16), on ``meta``: the counter charges rank 0's
    local product (2 * 32 * 1600 * 320), not the global one, and sees the
    all-gather DTensor issues."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with dryrun.fake_world(256):
        mesh = make_mesh((16, 16), ("data", "model"), "cpu")
        w = distribute_tensor(torch.empty(5120, 25600, device="meta"), mesh,
                              (Shard(0), Shard(1)), src_data_rank=None)
        x = distribute_tensor(torch.empty(32, 5120, device="meta"), mesh,
                              (Shard(0), Replicate()), src_data_rank=None)
        counter = comm_analysis.StepCounter()
        with counter:
            y = x @ w
        rep = counter.report()
    assert tuple(y.to_local().shape) == (32, 1600)
    assert rep["flops"] == 2 * 32 * 1600 * 320
    assert rep["counts"]["all-gather"] == 1
    assert rep["coll"]["all-gather"] == pytest.approx(
        comm_analysis.wire_bytes("all-gather", 32 * 5120 * 4, 16))
