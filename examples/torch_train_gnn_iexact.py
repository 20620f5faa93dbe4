"""End-to-end driver (PyTorch/CUDA port): train GraphSAGE on the
arxiv-like graph under FP32 / EXACT-INT2 / i-EXACT block-wise INT2(+VM) and
reproduce the paper's Table-1 trends (accuracy parity, memory reduction).

  PYTHONPATH=src python examples/torch_train_gnn_iexact.py [--epochs 150] [--scale 0.02] [--device cpu]

``--batches N`` additionally runs the partition-sampled mini-batch engine
(Cluster-GCN flavor) on the block+VM config and reports the per-batch peak
saved-activation bytes against the full-graph run.  Weights are drawn from
a seeded ``torch.Generator`` (the reference's from ``jax.random``), so
accuracies differ from the reference script's; the M column is the same
model (``activation_memory_report``).
"""
import argparse

from repro_torch.core.compressor import CompressionConfig
from repro_torch.graph.data import arxiv_like
from repro_torch.graph.models import GNNConfig
from repro_torch.graph.train import (activation_memory_report, train_gnn,
                                     train_gnn_batched)

ROWS = (
    ("FP32 baseline", None),
    ("EXACT INT2 (per-row, D/R=8)", CompressionConfig(2, 32, 8)),
    ("i-EXACT block G/R=8", CompressionConfig(2, 256, 8)),
    ("i-EXACT block G/R=64", CompressionConfig(2, 2048, 8)),
    ("i-EXACT block + VM", CompressionConfig(2, 256, 8, vm=True)),
)


def main(argv=None) -> dict:
    """Train every row; returns the graph's size, each row's config,
    accuracy, speed, M bytes, live stash bytes and losses, and the
    mini-batch row under ``batched`` when ``--batches`` is given."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--batches", type=int, default=0,
                    help="also run the mini-batch engine with this many "
                         "subgraph partitions")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = arxiv_like(scale=args.scale)
    print(f"arxiv-like stand-in: {g.n_nodes} nodes, {g.n_edges} edges, "
          f"{g.n_feats} feats, {g.num_classes} classes\n")

    rows = []
    for name, comp in ROWS:
        cfg = GNNConfig(arch="sage", hidden=(256, 256),
                        n_classes=g.num_classes, compression=comp)
        r = train_gnn(g, cfg, n_epochs=args.epochs, seed=0,
                      device=args.device)
        mem = activation_memory_report(g, cfg)
        m_bytes = mem.get("compressed_bytes", mem["fp32_bytes"])
        rows.append({"name": name, "cfg": cfg, "test_acc": r["test_acc"],
                     "epochs_per_sec": r["epochs_per_sec"],
                     "m_bytes": m_bytes, "stash_bytes": r["stash_bytes"],
                     "losses": [h[1] for h in r["history"]]})
        print(f"{name:32s} acc={r['test_acc']:.4f} "
              f"S={r['epochs_per_sec']:5.2f} e/s  M={m_bytes / 1e6:8.2f} MB")

    fp32, best = rows[0], rows[3]
    print(f"\nblock-wise G/R=64 vs FP32: "
          f"Δacc={best['test_acc'] - fp32['test_acc']:+.4f}, "
          f"memory -{100 * (1 - best['m_bytes'] / fp32['m_bytes']):.1f}%")
    out = {"n_nodes": g.n_nodes, "n_feats": g.n_feats, "rows": rows}

    if args.batches:
        comp = CompressionConfig(2, 256, 8, vm=True)
        cfg = GNNConfig(arch="sage", hidden=(256, 256),
                        n_classes=g.num_classes, compression=comp)
        r = train_gnn_batched(g, cfg, n_parts=args.batches,
                              n_epochs=args.epochs, seed=0,
                              device=args.device)
        rep = activation_memory_report(g, cfg, n_parts=args.batches,
                                       batch_nodes=r["batch_nodes"])
        print(f"\nmini-batch engine ({args.batches} partitions of "
              f"{r['batch_nodes']} padded nodes):")
        if "batched" in rep:
            b = rep["batched"]
            peak_bytes = b["peak_saved_bytes"]
            peak = (f"peak M={peak_bytes / 1e6:8.2f} MB "
                    f"({b['peak_reduction_vs_full']:.1f}x below full-graph)")
        else:  # --batches 1: the peak IS the full graph
            peak_bytes = rep["compressed_bytes"]
            peak = f"peak M={peak_bytes / 1e6:8.2f} MB (full graph)"
        print(f"  block+VM batched acc={r['test_acc']:.4f} "
              f"S={r['epochs_per_sec']:5.2f} e/s  {peak}")
        out["batched"] = {"cfg": cfg, "batch_nodes": r["batch_nodes"],
                          "test_acc": r["test_acc"],
                          "epochs_per_sec": r["epochs_per_sec"],
                          "peak_bytes": peak_bytes,
                          "stash_bytes": r["stash_bytes"],
                          "losses": [h[1] for h in r["history"]]}
    return out


if __name__ == "__main__":
    main()
