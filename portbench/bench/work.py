"""The work of one full-graph GNN training step, counted from the shapes
the benchmark made (the graph it generated and the configuration it
read), never from anything the program reports.

A layer ``l`` of GraphSAGE aggregates its ``d_in``-wide input over the
edges, multiplies the ``lin_in = 2 d_in``-wide concatenation by a
``(lin_in, d_out)`` weight, and stashes that concatenation for the
backward: raw (float32), or projected to ``lin_in / rp_ratio`` columns and
block-quantized.  Hidden layers also stash a packed 1-bit ReLU mask.
"""
from __future__ import annotations

import dataclasses


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Layer:
    index: int
    d_in: int          # aggregated width
    lin_in: int        # the linear's input width
    d_out: int
    hidden: bool       # a ReLU follows


@dataclasses.dataclass(frozen=True)
class GNNStep:
    """Shapes of one step: ``n_nodes`` rows, ``n_edges`` aggregation edges
    (self loops and both directions), layer widths ``dims``, and the stash
    recipe (``None``: float32) with the fused-pair mode."""

    n_nodes: int
    n_edges: int
    dims: tuple
    recipe: dict | None
    fused: str = "auto"

    def layers(self) -> list[Layer]:
        d = self.dims
        return [Layer(i, d[i], 2 * d[i], d[i + 1], i < len(d) - 2)
                for i in range(len(d) - 1)]

    # ------------------------------------------------------------ FLOPs
    def model_flops(self) -> float:
        """Forward and backward of the linears and the aggregations: a
        multiply-add is 2 operations; the features take no gradient, so
        layer 0 has no input gradient and no transposed aggregation.  The
        projection, the quantizer and the elementwise work are not
        counted."""
        n, e = self.n_nodes, self.n_edges
        total = 0.0
        for ly in self.layers():
            total += 2 * e * ly.d_in + 2 * n * ly.lin_in * ly.d_out  # forward
            total += 2 * n * ly.lin_in * ly.d_out                   # dW
            if ly.index > 0:
                total += 2 * n * ly.d_out * ly.lin_in + 2 * e * ly.d_in
        return total

    # ------------------------------------------------------------ stash
    def projected(self, ly: Layer) -> int:
        """Columns the quantizer sees for layer ``ly``."""
        rp = self.recipe["rp_ratio"]
        return ly.lin_in // rp if rp > 1 else ly.lin_in

    def n_blocks(self, ly: Layer) -> int:
        return _ceil(self.n_nodes * self.projected(ly),
                     self.recipe["group_size"])

    def words_per_block(self) -> int:
        return _ceil(self.recipe["group_size"], 32 // self.recipe["bits"])

    def stash_bytes(self) -> list[int]:
        """Bytes each layer keeps for the backward: the packed codes, a
        float32 (min, range) pair a block and the 4-byte projection seed,
        or the float32 input; plus the ReLU mask in 32-bit words."""
        out = []
        for ly in self.layers():
            if self.recipe is None:
                b = 4 * self.n_nodes * ly.lin_in
            else:
                nb = self.n_blocks(ly)
                b = 4 * nb * self.words_per_block() + 8 * nb + 4
            if ly.hidden:
                b += 4 * _ceil(self.n_nodes * ly.d_out, 32)
            out.append(b)
        return out

    def fused_layers(self) -> list[Layer]:
        """Layers whose product and quantizer are one fused pair: a
        compressed recipe without projection under ``fused`` "auto" or
        "on", where blocks align to rows and the codes fill whole words."""
        r = self.recipe
        if r is None or r["rp_ratio"] > 1 or self.fused == "off":
            return []
        g = r["group_size"]
        return [ly for ly in self.layers()
                if (ly.lin_in % g == 0 or g % ly.lin_in == 0)
                and (self.n_nodes * ly.lin_in) % g == 0
                and (g * r["bits"]) % 32 == 0]

    def quant_layers(self) -> list[Layer]:
        """Layers whose stash goes through the quantize and dequantize
        kernels on their own (every compressed layer not fused)."""
        if self.recipe is None:
            return []
        fused = {ly.index for ly in self.fused_layers()}
        return [ly for ly in self.layers() if ly.index not in fused]


def step_shapes(config: dict, traffic: dict, n_edges: int) -> GNNStep:
    """The :class:`GNNStep` of a cell; ``n_edges`` is the generated graph's
    (self-loop removal makes it depend on the seed)."""
    g, m = config["graph"], config["model"]
    dims = (int(g["n_feats"]), *[int(h) for h in m["hidden"]],
            int(m["n_classes"]))
    return GNNStep(int(g["n_nodes"]), int(n_edges), dims,
                   traffic.get("compression"), traffic.get("fused", "auto"))
