"""End-to-end training launcher (the reference's ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --batch 2 --seq 1024 --steps 5 --act-mode act
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
      --smoke --steps 4 --act-mode act --ckpt-dir /tmp/run1 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --graph-batches 8 \\
      --graph-scale 1.0 --steps 3

Runs on the card (``--device cuda``, the default) unless the CPU is asked
for; without a card the default raises.  Two halves:

* **LM** (``--arch``): every family: dense (``dense``, ``vlm``), MoE
  (``qwen3-moe-235b-a22b``, ``arctic-480b``), SSM (``mamba2-780m``),
  hybrid (``zamba2-1.2b``) and enc-dec (``seamless-m4t-large-v2``, its
  audio frontend's stub output ``enc_embeds`` drawn a step from a
  generator seeded with the step, as the vlm's ``prefix_embeds``) trained
  with
  ``--act-mode none|remat|act`` (``act``: each layer's input stored
  block-quantized, ``--act-bits`` / ``--act-group``, and the layer
  recomputed from it in the backward), ``--offload host|pinned-paged``
  parking those stashes in host memory, AdamW (``--opt-bits 8`` for 8-bit
  moments), tokens from ``data.batch_for_step`` and random weights from
  seed 0.  ``--ckpt-dir`` checkpoints every ``--ckpt-every`` steps and at
  the end and resumes from the latest checkpoint there
  (:class:`repro_torch.runtime.TrainRunner`); ``--fail-at`` injects a
  failure.  The config's ``grad_accum`` splits ``--batch`` into that many
  micro-batches (qwen3-moe 8, arctic 4; ``--smoke`` configs 1), so the
  batch must divide by it.  An MoE layer runs under ``act`` as under
  ``none`` (the reference stashes no MoE layer compressed) and
  ``remat`` checkpoints it; the enc-dec checkpoints every layer under
  both ``remat`` and ``act``.  A Mamba-2 layer is stashed under ``act``
  as a dense one is; its ``--seq`` must be a multiple of the config's
  ``ssm_chunk`` (128, 16 for ``--smoke``).  Prints ``steps=N loss a ->
  b``; ``main`` returns one ``{"step", "loss", "dt"}`` a step.
  The model trains on a (data, model) device mesh, as the reference's
  does: ``--production-mesh`` builds the reference's (16, 16) mesh over
  the default process group's ranks (it raises, naming the 256 ranks,
  on any other world), else a (1, 1) mesh of this rank.  The launcher
  installs :func:`~repro_torch.parallel.annotate.rules_for`'s rules,
  lays the parameters out by
  :func:`~repro_torch.parallel.sharding.param_pspecs` and each batch by
  ``batch_pspecs`` (as DTensors; nothing changes on one rank) and reads
  the loss with ``full_tensor()``.  Every family runs sharded (the SSM's
  heads and the MoE's experts over ``model`` on their local shards), and
  so do 8-bit moments, each shard's blocks at their global offset; a
  parameter whose shard would straddle the moment blocks raises, naming
  it.
* **Graph** (``--graph-batches N`` or ``--mesh-parts N``): the GNN
  engines on an arxiv/flickr/papers100m-like graph.  The flags lower onto
  one :class:`~repro_torch.engine.plan.ExecutionPlan`; ``engine.runner.run``
  and ``activation_memory_report`` read that same plan.  ``--mesh-parts``
  trains on the ranks of the default ``torch.distributed`` process group
  when one is initialized, else on one rank.  With ``--production-mesh``
  the mini-batch engine spreads its batches over the production mesh's
  data axes (this rank's ("pod", "data") process group, ``dp_size``
  ranks), as the reference shards them.  ``main`` returns the run's
  history: the port records ``(epoch, loss, ms)`` every epoch (the host
  time through the loss read-back), where the reference prints
  ``(epoch, loss, val_acc)`` every ``eval_every`` epochs.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get, reduce_for_smoke
from repro_torch.core.compressor import CompressionConfig
from repro_torch.core.device import resolve_device
from repro_torch.data import batch_for_step
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.models.transformer import check_family
from repro_torch.obs import ObsPolicy, stopwatch
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import annotate, sharding
from repro_torch.runtime import StragglerMonitor, TrainRunner


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="LM config name (required unless --graph-batches "
                         "or --mesh-parts)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None,
                    help="defaults to 3e-4 (LM) / 5e-3 (graph engines)")
    ap.add_argument("--act-mode", default=None,
                    choices=[None, "none", "remat", "act"])
    ap.add_argument("--act-bits", type=int, default=2)
    ap.add_argument("--act-group", type=int, default=256)
    ap.add_argument("--act-impl", default="auto",
                    choices=["auto", "torch", "cuda"],
                    help="kernel backend of the compression stack "
                         "(core.backend): 'auto' is the CUDA kernels for "
                         "tensors on the card, the plain versions on the "
                         "CPU")
    ap.add_argument("--act-fused", default="auto",
                    choices=["auto", "on", "off"],
                    help="fused quantize-in-epilogue matmul pair for the "
                         "graph engines (KernelPolicy.fused)")
    ap.add_argument("--offload", default="none",
                    choices=["none", "device", "host", "pinned-paged"],
                    help="where saved-for-backward stashes live: 'device' "
                         "pools a GNN's in one arena; 'host' / "
                         "'pinned-paged' park them in pageable / "
                         "page-locked host memory between forward and "
                         "backward (the LM's per-layer stash too)")
    ap.add_argument("--opt-bits", type=int, default=0, choices=[0, 8])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure before this step")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) (data, model) mesh over "
                         "the default process group's 256 ranks")
    ap.add_argument("--graph-batches", type=int, default=0, metavar="N_PARTS",
                    help="train the GNN with the partition-sampled "
                         "mini-batch engine (--steps counts epochs)")
    ap.add_argument("--mesh-parts", type=int, default=0, metavar="N_PARTS",
                    help="train the GNN with the mesh engine: N_PARTS "
                         "partitions over the process group's ranks with "
                         "a halo exchange a layer and host-resident "
                         "features (--steps counts epochs)")
    ap.add_argument("--graph-dataset", default="arxiv",
                    choices=["arxiv", "flickr", "papers100m"])
    ap.add_argument("--graph-scale", type=float, default=0.02)
    ap.add_argument("--graph-arch", default="sage", choices=["sage", "gcn"])
    ap.add_argument("--graph-halo", type=int, default=0,
                    help="hops of in-neighborhood halo around each partition")
    ap.add_argument("--bit-budget", type=float, default=None,
                    help="adaptive precision: average stash bits per "
                         "element, per-layer widths solved by core.autoprec")
    ap.add_argument("--autoprec-refresh", type=int, default=0,
                    help="re-solve the allocation every N epochs (0: once)")
    ap.add_argument("--obs", action="store_true",
                    help="spans, metrics and, with compression, the "
                         "quant-health probe (bit-identical to obs-off)")
    ap.add_argument("--trace-out", default=None, metavar="BASE",
                    help="with --obs: write BASE.jsonl and BASE.trace.json")
    ap.add_argument("--obs-quant-every", type=int, default=10, metavar="N",
                    help="with --obs: run the quant-health probe every N "
                         "epochs")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda, or cpu for the "
                         "plain versions)")
    return ap


# ------------------------------------------------------------------ graph
def graph_plan(args):
    """The ExecutionPlan the graph flags lower to."""
    from repro_torch.engine.plan import (ExecutionPlan, KernelPolicy,
                                         SamplingPolicy)

    obs_policy = ObsPolicy()
    if args.obs:
        obs_policy = ObsPolicy(enabled=True,
                               quant_stats=args.act_mode == "act",
                               quant_stats_every=args.obs_quant_every)
    if args.mesh_parts:
        # the mesh engine on the default process group (one rank without
        # one); stash and precision knobs belong to the other engines
        return ExecutionPlan(
            sampling=SamplingPolicy(kind="mesh", n_parts=args.mesh_parts,
                                    shuffle=False),
            kernel=KernelPolicy(fused=args.act_fused), obs=obs_policy)
    return ExecutionPlan.from_legacy(
        n_parts=args.graph_batches, fused=args.act_fused,
        offload=None if args.offload == "none" else args.offload,
        bit_budget=args.bit_budget, autoprec_refresh=args.autoprec_refresh,
        halo=args.graph_halo, obs=obs_policy)


def graph_main(args) -> dict:
    """Train the graph flags' plan through ``engine.runner.run``, print
    the reference's report, and return the run's result with the memory
    report (``report``) and the graph (``graph``) added."""
    from repro_torch.engine import run as engine_run
    from repro_torch.graph import (GNNConfig, activation_memory_report,
                                   arxiv_like, flickr_like, papers100m_like)

    device = resolve_device(args.device)
    maker = {"arxiv": arxiv_like, "flickr": flickr_like,
             "papers100m": papers100m_like}[args.graph_dataset]
    g = maker(scale=args.graph_scale)
    comp = None
    if args.act_mode == "act":
        comp = CompressionConfig(bits=args.act_bits, group_size=args.act_group,
                                 rp_ratio=8, impl=args.act_impl)
    cfg = GNNConfig(arch=args.graph_arch, hidden=(256, 256),
                    n_classes=g.num_classes, compression=comp)
    lr = args.lr if args.lr is not None else 5e-3   # GNN engines' default
    plan = graph_plan(args)
    group = None
    if args.production_mesh and not args.mesh_parts:
        group = data_group(make_production_mesh(device=device))
    print(f"plan: {plan.describe()}")
    r = engine_run(g, cfg, plan, AdamWConfig(lr=lr, weight_decay=0.0),
                   n_epochs=args.steps, seed=0, device=device, mesh=group)
    if args.mesh_parts:
        pg = r["pager"]
        print(f"mesh: {r['mesh_devices']} devices x "
              f"{r['updates_per_epoch']} rounds, halo width "
              f"{r['halo_width']} rows, {r['dropped_edges']} cross-round "
              f"edges dropped, {r['halo_bytes_per_epoch'] / 1e6:.2f} MB "
              f"halo traffic/epoch")
        print(f"feature pager: {pg['host_bytes'] / 1e6:.2f} MB host-resident "
              f"in {pg['n_pages']} pages/round, overlap "
              f"{pg['overlap_frac']:.2f} (last {pg['overlap_window_size']} "
              f"fetches: {pg['overlap_frac_window']:.2f})")
    quant_rows = []
    obs = r.get("obs")
    if obs is not None:
        quant_rows = obs.quant_rows()
        if quant_rows:
            print(f"quant health (epoch {quant_rows[0]['epoch']}): layer "
                  "bits measured predicted ratio sat%")
            for row in quant_rows:
                print(f"  L{row['layer']} {row['bits']}b "
                      f"{row['measured_var']:.3e} "
                      f"{row['predicted_var']:.3e} "
                      f"{row['ratio']:.2f} {100 * row['sat_rate']:.1f}%")
        if args.trace_out:
            paths = obs.export(args.trace_out)
            print(f"obs trace: {paths['jsonl']} (spans) + "
                  f"{paths['chrome']} (load at ui.perfetto.dev)")
    cfg = r.get("cfg", cfg)   # autoprec may have re-allocated the widths
    rep = activation_memory_report(g, cfg, batch_nodes=r["batch_nodes"],
                                   plan=plan,
                                   quant_health=quant_rows or None)
    if "arena" in rep:
        a = rep["arena"]
        print(f"stash arena[{a['policy']}]: {a['planned_bytes'] / 1e6:.2f} MB "
              f"pooled ({a['u32_bytes'] / 1e6:.2f} u32 + "
              f"{a['f32_bytes'] / 1e6:.2f} f32), "
              f"device-resident {a['device_resident_bytes'] / 1e6:.2f} MB")
    if "bits_per_layer" in r:
        print(f"autoprec: budget={args.bit_budget} avg bits "
              f"({r['bit_budget_bytes']} stash bytes) -> per-layer bits "
              f"{r['bits_per_layer']}")
    print(f"{g.name}: {g.n_nodes} nodes -> {r['n_parts']} batches of "
          f"{r['batch_nodes']} padded nodes, "
          f"{r['updates_per_epoch']} updates/epoch")
    print(f"epochs={args.steps} val_acc={r['val_acc']:.4f} "
          f"test_acc={r['test_acc']:.4f} S={r['epochs_per_sec']:.2f} e/s")
    if "mesh" in rep:
        print(f"per-device peak saved-activation bytes: "
              f"{rep['mesh']['per_device_saved_bytes'] / 1e6:.2f} MB "
              f"({rep['mesh']['peak_reduction_vs_full']:.1f}x below "
              f"full-graph)")
    elif "batched" in rep:
        print(f"peak saved-activation bytes/batch: "
              f"{rep['batched']['peak_saved_bytes'] / 1e6:.2f} MB "
              f"({rep['batched']['peak_reduction_vs_full']:.1f}x below "
              f"full-graph)")
    else:
        full = rep.get("compressed_bytes", rep["fp32_bytes"])
        print(f"full-graph saved-activation bytes: {full / 1e6:.2f} MB")
    return {**r, "report": rep, "graph": g}


# --------------------------------------------------------------------- LM
def data_group(mesh):
    """This rank's process group over ``mesh``'s data axes (("pod",
    "data") or ("data",)): the ranks it shares a batch split with."""
    axes = sharding.dp_axes(mesh)
    sub = mesh[axes] if len(axes) > 1 else mesh[axes[0]]
    return (sub._flatten() if len(axes) > 1 else sub).get_group()


def lm_config(args):
    """The ArchConfig the LM flags name."""
    cfg = get(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    check_family(cfg)
    if args.batch % cfg.grad_accum:
        raise ValueError(f"--batch {args.batch} does not split into "
                         f"{cfg.name}'s grad_accum={cfg.grad_accum} "
                         "micro-batches")
    if args.act_mode:
        comp = CompressionConfig(bits=args.act_bits, group_size=args.act_group,
                                 impl=args.act_impl)
        cfg = dataclasses.replace(cfg, act_mode=args.act_mode,
                                  act_compression=comp)
    if args.offload in ("host", "pinned-paged"):
        # "device" is the per-layer stash where it was made already
        cfg = dataclasses.replace(cfg, act_offload=args.offload)
    return cfg


def lm_main(args) -> dict:
    """Train the LM flags' model; returns ``history`` (one ``{"step",
    "loss", "dt"}`` a step), ``model``, ``opt_state``, ``step_fn`` and
    ``make_batch`` (so a caller can run and inspect further steps)."""
    device = resolve_device(args.device)
    cfg = lm_config(args)
    mesh = (make_production_mesh(device=device) if args.production_mesh
            else make_local_mesh(device))
    annotate.set_rules(**annotate.rules_for(cfg, mesh, args.batch))
    model = Model(cfg, device=device,
                  generator=torch.Generator(device).manual_seed(0))
    sharding.distribute_model(model, mesh)
    lr = args.lr if args.lr is not None else 3e-4
    opt = AdamWConfig(lr=lr, weight_decay=0.01, grad_clip=1.0,
                      warmup_steps=min(20, args.steps // 5),
                      state_bits=args.opt_bits)
    act_impl = None if args.act_impl == "auto" else args.act_impl
    train_step = make_train_step(model, opt, act_impl=act_impl)
    names, params = zip(*model.named_parameters())
    opt_state = adamw_init(params, opt, names=names)

    def step_fn(state, batch):
        return state, train_step(state[1], batch)

    def make_batch(step):
        toks = batch_for_step(cfg.vocab, args.batch, args.seq, step)
        b = {"tokens": torch.as_tensor(toks, device=device)}
        if cfg.frontend == "vision":
            gen = torch.Generator(device).manual_seed(step)
            b["prefix_embeds"] = torch.randn(
                (args.batch, cfg.frontend_len, cfg.d_model), generator=gen,
                device=device).to(torch.bfloat16)
        if cfg.family == "encdec":
            gen = torch.Generator(device).manual_seed(step)
            b["enc_embeds"] = torch.randn(
                (args.batch, args.seq, cfg.d_model), generator=gen,
                device=device).to(torch.bfloat16)
        return sharding.distribute_batch(cfg, b, mesh)

    state = (model, opt_state)
    if args.ckpt_dir:
        runner = TrainRunner(step_fn, make_batch, args.ckpt_dir,
                             ckpt_every=args.ckpt_every,
                             fail_at_step=args.fail_at,
                             monitor=StragglerMonitor())
        state, hist = runner.run(state, args.steps)
        print(f"straggler events: {len(runner.monitor.events)}")
    else:
        hist = []
        for step in range(args.steps):
            with stopwatch("lm/step", step=step) as sw:
                loss = float(step_fn(state, make_batch(step))[1]["loss"])
            hist.append({"step": step, "loss": loss, "dt": sw.elapsed_s})
    if hist:
        print(f"steps={len(hist)} loss {hist[0]['loss']:.4f} -> "
              f"{hist[-1]['loss']:.4f}")
    return {"history": hist, "model": state[0], "opt_state": state[1],
            "step_fn": step_fn, "make_batch": make_batch, "mesh": mesh}


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.graph_batches and args.mesh_parts:
        ap.error("--graph-batches and --mesh-parts are different engines; "
                 "pick one")
    if args.graph_batches or args.mesh_parts:
        return graph_main(args)["history"]
    if args.arch is None:
        ap.error("--arch is required unless --graph-batches or "
                 "--mesh-parts is set")
    return lm_main(args)["history"]


if __name__ == "__main__":
    main()
