"""The production dry run: trace each (arch x shape) step once on the
single-pod (16, 16) and multi-pod (2, 16, 16) production meshes, shapes
alone, and record per-device memory, FLOPs, memory traffic and collective
bytes into ``results/dryrun_torch/*.json`` (the counterpart of the
reference's ``repro.launch.dryrun``; it needs no card).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all            # subprocess per cell

A cell runs the production world in one process: a ``"fake"`` process
group of 256 (or 512) ranks, this process its rank 0, and
:func:`repro_torch.launch.mesh.make_production_mesh` over it.  The
parameters, the optimizer state and the inputs live on ``meta`` (shapes
and dtypes, nothing allocated), laid out by ``distribute_model``,
``distribute_batch`` and ``distribute_cache``; the train, prefill or
decode step runs once under :class:`~repro_torch.launch.comm_analysis.
StepCounter`, whose collectives send nothing.  More than 6e10 parameters
take bf16 moments (and bf16 gradient sums), as the reference's giants do.

The record has the reference's keys.  Where a key's meaning differs from
XLA's:

* ``trace_s`` (in place of ``lower_s`` / ``compile_s``): the seconds of
  the one eager step on ``meta``, layout set-up included;
* ``memory.argument_bytes``: the local bytes of the step's inputs on rank
  0 (parameters, moments, batch; the cache at decode);
  ``memory.output_bytes``: of what the step returns or updates in place
  (the port updates parameters, moments and cache where the reference
  returns new ones; ``alias_bytes`` is that in-place part);
  ``memory.temp_bytes``: the peak of the bytes the step's ops held alive
  at once (eager lifetimes, no buffer reuse by a compiler);
* ``hlo.dot_flops_per_device``: the matrix products' FLOPs on rank 0's
  local shards (FLOP counting around DTensor ops would count the global
  products); ``hlo.hbm_bytes_per_device``: the sum of every local op's
  operand and result bytes (no fusion: an upper bound, as the
  reference's); ``hlo.collective_wire_bytes_per_device``: the ring
  model's bytes by kind, of every collective rank 0 issues;
  ``hlo.n_computations`` is the number of ops counted;
* ``stash``: under ``--act-mode act`` the INT2 stash ran through its
  plain version (``impl="auto"`` off the card), shape-only;
* ``moment8_straddle``: the parameters (layer index as ``*``) whose shard
  on this mesh straddles 8-bit moment blocks of 256, which 8-bit AdamW
  refuses (the step itself keeps float moments, as the reference's).
"""
import argparse
import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train (N = active params), 2·N·D fwd."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.batch  # decode: one token per sequence


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a ``"fake"`` process group of ``n`` ranks
    (collectives send nothing), torn down after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    """Rank 0's bytes of every tensor in ``tree`` (a DTensor's shard)."""
    import torch

    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


_LAYER = re.compile(r"\.\d+\.")


def straddlers(model, group: int = 256) -> list:
    """``name (shape)`` of each parameter (layer index as ``*``) whose
    shard straddles 8-bit moment blocks of ``group``."""
    from repro_torch.optim.adamw import shard_offset

    out = []
    for name, p in model.named_parameters():
        try:
            shard_offset(p, group)
        except ValueError:
            key = f"{_LAYER.sub('.*.', name)} {tuple(p.shape)}"
            if key not in out:
                out.append(key)
    return out


def build_cell(cfg, shape, mesh):
    """(step thunk, its arguments, what it updates in place) of one cell
    on ``mesh``, every tensor on ``meta``."""
    import torch

    from repro_torch.configs import input_specs
    from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import Model
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import annotate, sharding

    annotate.set_rules(**annotate.rules_for(
        cfg, mesh, shape.batch, is_train=shape.kind == "train"))
    model = Model(cfg, init_params(cfg, torch.device("meta")),
                  device="meta")
    sharding.distribute_model(model, mesh)
    specs = input_specs(cfg, shape)
    big = cfg.param_count() > 6e10   # bf16 optimizer moments for the giants
    if shape.kind == "train":
        opt = AdamWConfig(lr=1e-4, weight_decay=0.1, grad_clip=1.0,
                          state_dtype="bfloat16" if big else "float32")
        step = make_train_step(
            model, opt,
            accum_dtype=torch.bfloat16 if big else torch.float32)
        state = adamw_init(list(model.parameters()), opt)
        batch = sharding.distribute_batch(cfg, specs, mesh)
        return (lambda: step(state, batch)), (model, state, batch), \
            (model, state)
    if shape.kind == "prefill":
        step = make_prefill_step(model, max_seq=None)
        batch = sharding.distribute_batch(cfg, specs, mesh)
        return (lambda: step(batch)), (model, batch), ()
    step = make_serve_step(model)
    cache = sharding.distribute_cache(cfg, specs["cache"], mesh,
                                      shape.batch, shape.seq)
    dp = sharding.dp_axes(mesh)
    tok_spec = sharding.spec(
        dp if shape.batch % sharding.dp_size(mesh) == 0 else None, None)
    tokens = sharding.distribute(specs["tokens"], tok_spec, mesh)
    return (lambda: step(cache, tokens)), (model, cache, tokens), (cache,)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             act_mode: str | None = None, *, cfg=None, shape=None,
             mesh_shape: tuple | None = None) -> dict:
    """One cell's record.  ``cfg``, ``shape`` and ``mesh_shape`` (a
    (data, model) shape) replace the production ones (the tests' small
    cells); the process must have no process group of its own."""
    from repro_torch.configs import SHAPES, cell_applicable, get
    from repro_torch.launch.comm_analysis import StepCounter
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.parallel import annotate

    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "act_mode": act_mode, "status": "?", "ts": time.strftime("%F %T")}
    cfg = cfg or get(arch)
    if act_mode:
        from repro_torch.core.compressor import CompressionConfig

        cfg = dataclasses.replace(
            cfg, act_mode=act_mode,
            act_compression=CompressionConfig(bits=2, group_size=256))
    shape = shape or SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    multi = mesh_kind == "multi"
    n = math.prod(mesh_shape) if mesh_shape else (512 if multi else 256)
    with fake_world(n):
        mesh = (make_mesh(mesh_shape, ("data", "model"), "cpu") if mesh_shape
                else make_production_mesh(multi_pod=multi, device="cpu"))
        try:
            fn, args, updated = build_cell(cfg, shape, mesh)
            arg_bytes = _local_bytes(args)
            counter = StepCounter()
            with counter:
                out = fn()
            trace_s = time.time() - t0
            rep = counter.report()
            alias = _local_bytes(updated)
            out_bytes = _local_bytes(out) + alias
            strad = straddlers(args[0])
        finally:
            annotate.set_rules()
    rec.update(
        status="ok",
        trace_s=round(trace_s, 1),
        memory={"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                "temp_bytes": rep["peak"], "alias_bytes": alias},
        hlo={"dot_flops_per_device": rep["flops"],
             "hbm_bytes_per_device": rep["hbm"],
             "collective_wire_bytes_per_device": rep["coll"],
             "collective_total_bytes": rep["coll_total"],
             "collective_counts": rep["counts"],
             "n_computations": rep["ops"]},
        model_flops_global=model_flops(cfg, shape),
        param_count=cfg.param_count(),
        active_param_count=cfg.active_param_count(),
        n_devices=n,
        moment8_straddle=strad,
    )
    if cfg.act_mode == "act":
        rec["stash"] = ("INT2 stash counted through its plain version "
                        "(impl='auto' off the card), shape-only on meta")
    return rec


ALL_ARCHS = [
    "seamless-m4t-large-v2", "qwen3-moe-235b-a22b", "arctic-480b",
    "qwen1.5-4b", "qwen1.5-32b", "mistral-nemo-12b", "qwen3-32b",
    "internvl2-2b", "mamba2-780m", "zamba2-1.2b",
]
ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _summary(rec: dict) -> str:
    h = rec["hlo"]
    ratio = rec["model_flops_global"] / max(
        h["dot_flops_per_device"] * rec["n_devices"], 1)
    return (f"  trace {rec['trace_s']}s "
            f"dot_flops/dev={h['dot_flops_per_device']:.3e} "
            f"model/dot={ratio:.3f} "
            f"coll/dev={h['collective_total_bytes']:.3e}B "
            f"hbm/dev={h['hbm_bytes_per_device']:.3e}B "
            f"args/dev={rec['memory']['argument_bytes']:.3e}B "
            f"temp/dev={rec['memory']['temp_bytes']:.3e}B")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default=None, choices=["single", "multi"],
                    help="a cell's mesh (default single); with --all, only "
                         "this mesh's cells (default both)")
    ap.add_argument("--act-mode", default=None,
                    choices=[None, "none", "remat", "act"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)
    RESULTS.mkdir(parents=True, exist_ok=True)

    if not args.all:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        mesh_kind = args.mesh or "single"
        suffix = f"__{args.act_mode}" if args.act_mode else ""
        out = RESULTS / f"{args.arch}__{args.shape}__{mesh_kind}{suffix}.json"
        try:
            rec = run_cell(args.arch, args.shape, mesh_kind, args.act_mode)
        except Exception as exc:        # the record says why the cell failed
            rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_kind,
                   "act_mode": args.act_mode, "status": "error",
                   "reason": f"{type(exc).__name__}: {exc}"[:2000]}
        out.write_text(json.dumps(rec, indent=1))
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "status")}, indent=None),
              flush=True)
        if rec["status"] == "ok":
            print(_summary(rec), flush=True)
        elif rec["status"] == "error":
            print(f"  {rec['reason']}", flush=True)
        return 0 if rec["status"] in ("ok", "skipped") else 1

    # --all: one subprocess per cell (isolates each trace, survives a
    # crashed cell)
    meshes = ("single", "multi") if args.mesh is None else (args.mesh,)
    failures = []
    for mesh_kind in meshes:
        for arch in ALL_ARCHS:
            for shape in ALL_SHAPES:
                out = RESULTS / f"{arch}__{shape}__{mesh_kind}.json"
                if args.skip_done and out.exists():
                    st = json.loads(out.read_text()).get("status")
                    if st in ("ok", "skipped"):
                        continue
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--mesh", mesh_kind]
                print(f"=== {arch} × {shape} × {mesh_kind}", flush=True)
                try:
                    r = subprocess.run(cmd, timeout=args.timeout)
                    if r.returncode != 0:
                        failures.append((arch, shape, mesh_kind, r.returncode))
                        if not out.exists() or json.loads(
                                out.read_text()).get("status") != "error":
                            out.write_text(json.dumps(
                                {"arch": arch, "shape": shape,
                                 "mesh": mesh_kind, "status": "error",
                                 "rc": r.returncode}))
                except subprocess.TimeoutExpired:
                    failures.append((arch, shape, mesh_kind, "timeout"))
                    out.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "mesh": mesh_kind,
                         "status": "timeout"}))
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
