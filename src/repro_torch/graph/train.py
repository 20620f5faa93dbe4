"""GNN training entry point: full-graph training (the paper's Table 1 loop)
over the engine (:mod:`repro_torch.engine.runner`), and the Table-1 "M"
column (:func:`activation_memory_report`)."""
from __future__ import annotations

from repro_torch.engine.runner import run
from repro_torch.graph.analysis import saved_bytes_per_layer
from repro_torch.graph.data import Graph
from repro_torch.graph.models import GNN, GNNConfig
from repro_torch.optim import AdamWConfig


def train_gnn(g: Graph, cfg: GNNConfig, opt: AdamWConfig | None = None,
              n_epochs: int = 100, seed: int = 0, params: GNN | None = None,
              impl: str = "auto", fused: str = "auto",
              bit_budget: float | None = None, autoprec_refresh: int = 0,
              offload: str | None = None, device="cuda") -> dict:
    """Full-graph training; returns dict(test_acc, val_acc, history,
    epochs_per_sec, model, stash_bytes, cfg) (see
    :func:`repro_torch.engine.runner.run`).

    Runs on the card unless ``device="cpu"``; with no CUDA device and no
    explicit ``"cpu"`` it raises.  ``impl`` routes the compression stack:
    ``"cuda"`` (the kernels), ``"torch"`` (the plain versions) or ``"auto"``
    (``"cuda"`` on a CUDA device, ``"torch"`` on the CPU).  ``params`` (a
    :class:`GNN`, e.g. from :func:`repro_torch.graph.models.params_from_numpy`)
    sets the initial weights; by default they are drawn from ``seed``.

    ``fused`` ("auto" | "on" | "off") governs the fused matmul-quant pair
    (the reference's ``train_gnn(fused=)``): "auto" fuses every eligible
    layer on the card when ``rp_ratio <= 1`` (2-D operand, blocks aligned to
    rows, whole blocks and words, at most 16 levels) and runs the two-pass
    spelling elsewhere, "on" forces the pair (the plain composition on the
    CPU, the same bits) and raises on an ineligible layer, "off" never
    fuses.

    ``bit_budget`` turns on variance-guided adaptive precision
    (:mod:`repro_torch.core.autoprec`): the average stash bits per element
    (2.0 = the fixed-INT2 footprint), converted once to a byte ceiling and
    split across layers (widths in ``BIT_CHOICES``) by minimizing the
    total expected SR variance, from range moments and a two-seed gradient
    probe.  ``autoprec_refresh=k`` re-solves every k epochs (0 = allocate
    once); a changed allocation recompiles the step.  The result then
    carries ``bits_per_layer`` and ``bit_budget_bytes``.

    ``offload`` (the pooled stash arena) belongs to queue A.8 and raises.
    """
    if offload is not None:
        raise NotImplementedError(
            f"offload={offload!r}: the stash arena and offload engine are "
            "not ported yet (ROADMAP A.8)")
    return run(g, cfg.with_impl(impl), opt, n_epochs=n_epochs, seed=seed,
               params=params, device=device, fused=fused,
               bit_budget=bit_budget, autoprec_refresh=autoprec_refresh)


def activation_memory_report(g: Graph, cfg: GNNConfig, n_parts: int = 1,
                             offload: str | None = None,
                             quant_health: list | None = None) -> dict:
    """Bytes of saved-for-backward activations: the paper's Table-1 "M"
    column model, per layer, full graph (the reference's full-graph keys):

    * ``fp32_bytes``: the f32 input of every linear plus the f32 ReLU
      context;
    * ``per_layer``: one dict per layer (``layer``, ``fp32_bytes``[,
      ``compressed_bytes``, ``bits``]);
    * when any layer is compressed, ``compressed_bytes`` (packed codes, one
      (zero, range) f32 pair a block, the RP seed and the word-aligned
      1-bit ReLU masks, each layer at its own width; an uncompressed layer
      counts its ``fp32_bytes``), ``reduction`` (1 - compressed / fp32)
      and ``bits_per_layer``.

    The mini-batch section (``n_parts > 1``), the arena section
    (``offload=``) and ``quant_health`` belong to queues A.7, A.8 and A.10
    and raise."""
    for given, what, item in ((n_parts > 1, f"n_parts={n_parts}", "A.7"),
                              (offload is not None, f"offload={offload!r}",
                               "A.8"),
                              (quant_health is not None, "quant_health=",
                               "A.10")):
        if given:
            raise NotImplementedError(f"activation_memory_report({what}) "
                                      f"is not ported yet (ROADMAP {item})")
    per_layer = saved_bytes_per_layer(cfg, g.n_feats, g.n_nodes)
    total_fp32 = sum(r["fp32_bytes"] for r in per_layer)
    out = {"fp32_bytes": total_fp32, "per_layer": per_layer}
    if any("compressed_bytes" in r for r in per_layer):
        # mixed precision: a layer without compression counts its fp32 bytes
        total_c = sum(r.get("compressed_bytes", r["fp32_bytes"])
                      for r in per_layer)
        out["compressed_bytes"] = total_c
        out["reduction"] = 1.0 - total_c / total_fp32
        out["bits_per_layer"] = [r.get("bits") for r in per_layer]
    return out
