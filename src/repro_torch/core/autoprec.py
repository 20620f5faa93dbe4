"""Variance-guided adaptive per-layer bit allocation (ActNN/GACT-style).

The paper's improved variance model (§3.2, Eq. 7-10) prices the expected
stochastic-rounding error of *one* level table; this module spends that
model across a whole network.  Given cheap per-layer sensitivity statistics
(:class:`LayerStats`: stash shape + second moment of the per-block ranges,
collected from a single forward pass) and a total activation-memory budget,
it solves for per-layer ``bits ∈ {1, 2, 4, 8}`` minimizing the total
expected dequantization variance

    Σ_layers  n_blocks · G · E[range²] · E[Var(⌊h⌉)] / B²     (B = 2^bits−1)

where ``E[Var(⌊h⌉)]`` is :func:`repro_torch.core.variance.expected_sr_variance`
under the CN_[1/D] model with the layer's own level table (uniform or VM)
and ``E[range²]`` rescales the normalized variance back to activation units.
When a layer carries a calibrated ``grad_sens`` (two-seed gradient probe,
see :class:`LayerStats`), the objective prices the *gradient* noise the
stash actually induces in ``dw = x̂ᵀg`` instead of the raw moment product —
same bit-scaling curve, empirically weighted per layer.

Everything here runs at configuration time in numpy/python — the output is
a tuple of ints that becomes a per-layer ``CompressionConfig`` tuple on
``GNNConfig`` (see :meth:`repro_torch.graph.models.GNNConfig.with_layer_bits`).
The training-time lifecycle — budget freezing, the two-seed gradient
probe, refresh cadence, and the recompile hook — is owned by
:class:`repro_torch.engine.precision.AutoprecController`, behind
``train_gnn(bit_budget=...)``.

The solver is a greedy marginal-gain ascent (start every layer at the
cheapest width, repeatedly buy the upgrade with the best Δvariance/Δbyte
that still fits), backstopped by an exhaustive sweep of the uniform
allocations: the returned allocation never costs more bytes than the budget
and never has higher modeled variance than any uniform bit-width that fits
the same budget — so "allocated mixed" dominates "fixed INT-b at equal
bytes" by construction.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.compressor import CompressionConfig
from repro_torch.core.pack import packed_nbytes
from repro_torch.core.variance import expected_sr_variance, expected_sr_variance_uniform

#: Bit-widths the packer supports densely (32 % bits == 0, <= 8).
BIT_CHOICES = (1, 2, 4, 8)


@dataclasses.dataclass(frozen=True)
class LayerStats:
    """Per-layer sensitivity statistics for the allocator.

    shape        post-RP stash shape (what actually gets quantized+packed)
    n_blocks     quantization blocks at the layer's group_size
    rng_sq_mean  E[range²] over blocks — the layer's sensitivity scale:
                 dequantization variance is proportional to it (Eq. 3 scales
                 codes by range/B, so SR noise re-enters squared).
    grad_sens    optional calibrated dequantization-*gradient* sensitivity:
                 the layer's realized SR noise in ``dw = x̂ᵀg`` divided by
                 :func:`normalized_sr_variance` at the width it was measured
                 at (a two-seed gradient probe isolates it exactly — ``dx``
                 and the ReLU mask are SR-noise-free, so only the layer's
                 own stash contributes).  When present it replaces the pure
                 range-moment scale, folding E[g²] into the objective.
    """

    shape: tuple[int, ...]
    n_blocks: int
    rng_sq_mean: float
    grad_sens: float | None = None

    @property
    def n_elements(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def normalized_sr_variance(cfg: CompressionConfig) -> float:
    """E[Var(⌊h⌉)]/B² under CN_[1/D] with ``cfg``'s level table.

    The per-unit-range² bit-scaling curve: dequantization multiplies the
    normalized SR noise by range/B, so dividing Eq. 10 by B² prices a
    width/table change independent of the activation scale (≈ 4^-bits for
    uniform tables; VM tables sit below their uniform counterpart).
    """
    B = 2**cfg.bits - 1
    lv = cfg.levels()
    d = cfg.cn_dim()
    evar = (expected_sr_variance(lv, d, cfg.bits) if lv is not None
            else expected_sr_variance_uniform(d, cfg.bits))
    return evar / B**2


def expected_layer_variance(stat: LayerStats, cfg: CompressionConfig) -> float:
    """Total expected dequantization(-gradient) SR variance of one layer."""
    e = normalized_sr_variance(cfg)
    if stat.grad_sens is not None:
        return stat.grad_sens * e
    return stat.n_blocks * cfg.group_size * stat.rng_sq_mean * e


def layer_stash_bytes(stat: LayerStats, cfg: CompressionConfig) -> int:
    """Packed bytes of one layer's quantized stash (codes + block stats)."""
    return packed_nbytes(stat.shape, cfg.bits, cfg.group_size)


def total_expected_variance(stats, cfgs) -> float:
    """Σ expected layer variance over (stats, per-layer config) pairs;
    ``None`` entries (uncompressed layers) contribute zero."""
    return sum(expected_layer_variance(s, c)
               for s, c in zip(stats, cfgs)
               if s is not None and c is not None)


def total_stash_bytes(stats, cfgs) -> int:
    return sum(layer_stash_bytes(s, c)
               for s, c in zip(stats, cfgs)
               if s is not None and c is not None)


def budget_bytes_for(stats, templates, avg_bits: float) -> int:
    """Byte budget equivalent to ``avg_bits`` bits per stashed element.

    Word-aligned per layer exactly like the packer, plus the 8-byte
    per-block (zero, range) overhead — so an integer ``avg_bits`` in
    :data:`BIT_CHOICES` reproduces the fixed-width footprint bit for bit
    (``budget_bytes_for(stats, t, 2) == Σ packed_nbytes(..., 2, G)`` when
    G is a pack-width multiple).
    """
    total = 0
    for s, t in zip(stats, templates):
        if s is None or t is None:
            continue
        words_per_block = int(-(-(t.group_size * float(avg_bits)) // 32))
        total += (4 * words_per_block + 8) * s.n_blocks
    return total


def allocate_bits(stats, templates, budget_bytes: int,
                  choices=BIT_CHOICES) -> tuple[int, ...]:
    """Solve per-layer bit-widths under a total byte budget.

    stats        list of :class:`LayerStats` (or ``None`` for layers with no
                 compression) — one entry per network layer
    templates    matching list of ``CompressionConfig`` (or ``None``); each
                 layer keeps its own group_size / rp_ratio / vm settings and
                 only ``bits`` is reassigned
    budget_bytes ceiling on the summed packed stash bytes of all compressed
                 layers (block-stat overhead included; it is width-invariant)

    Returns one ``int`` per layer (0 for uncompressed layers).  If even the
    cheapest width exceeds the budget, the all-minimum allocation is
    returned — the closest feasible point, never an exception (a too-tight
    budget should degrade, not kill a training run).
    """
    choices = tuple(sorted(choices))
    live = [i for i, (s, t) in enumerate(zip(stats, templates))
            if s is not None and t is not None]
    if not live:
        return tuple(0 for _ in stats)

    bytes_tab = {}
    var_tab = {}
    for i in live:
        for b in choices:
            c = dataclasses.replace(templates[i], bits=b)
            bytes_tab[i, b] = layer_stash_bytes(stats[i], c)
            var_tab[i, b] = expected_layer_variance(stats[i], c)

    level = {i: 0 for i in live}  # index into choices
    cur_bytes = sum(bytes_tab[i, choices[0]] for i in live)

    def alloc_of(level):
        return {i: choices[level[i]] for i in live}

    # greedy: buy the best Δvariance per Δbyte upgrade that still fits
    while True:
        best, best_gain = None, 0.0
        for i in live:
            if level[i] + 1 >= len(choices):
                continue
            b0, b1 = choices[level[i]], choices[level[i] + 1]
            dbytes = bytes_tab[i, b1] - bytes_tab[i, b0]
            if cur_bytes + dbytes > budget_bytes:
                continue
            dvar = var_tab[i, b0] - var_tab[i, b1]
            if dvar <= 0.0:
                continue
            # word-padding can make an upgrade byte-free — always take it
            gain = dvar / max(dbytes, 1e-9) if dbytes > 0 else float("inf")
            if best is None or gain > best_gain:
                best, best_gain = i, gain
        if best is None:
            break
        cur_bytes += bytes_tab[best, choices[level[best] + 1]] \
            - bytes_tab[best, choices[level[best]]]
        level[best] += 1

    cand = alloc_of(level)
    cand_var = sum(var_tab[i, cand[i]] for i in live)

    # backstop: never worse than any *uniform* width that fits the budget
    for b in choices:
        ub = sum(bytes_tab[i, b] for i in live)
        if ub > budget_bytes:
            continue
        uv = sum(var_tab[i, b] for i in live)
        if uv < cand_var:
            cand = {i: b for i in live}
            cand_var = uv

    return tuple(cand.get(i, 0) for i in range(len(stats)))
