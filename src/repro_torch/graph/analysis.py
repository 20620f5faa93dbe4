"""The paper's Table-1 memory model (the byte-ledger part of the
reference's ``repro.graph.analysis``): pure arithmetic, equal to the
reference's numbers and to the bytes a training step's stash holds."""
from __future__ import annotations

from repro_torch.core import pack as packmod
from repro_torch.graph.models import GNNConfig, _dims


def relu_mask_nbytes(n_elements: int) -> int:
    """Bytes of the packed 1-bit ReLU sign mask (whole 32-bit words)."""
    return 4 * ((n_elements + 31) // 32)


def saved_bytes_per_layer(cfg: GNNConfig, in_dim: int,
                          n_nodes: int) -> list[dict]:
    """Per-layer saved-for-backward bytes.  ``fp32_bytes``: the f32 linear
    input plus (hidden layers) the f32 ReLU context; ``compressed_bytes``
    (compressed layers only): packed post-RP code words + 8-byte per-block
    (zero, range) + the 4-byte RP seed + the word-aligned 1-bit ReLU mask;
    ``bits``: the layer's quantization width."""
    dims = _dims(cfg, in_dim)
    per_layer = cfg.layer_compression()
    rows = []
    for li, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        lin_in = d_in * (2 if cfg.arch == "sage" else 1)
        hidden = li < len(dims) - 2
        fp32 = n_nodes * lin_in * 4 + (n_nodes * d_out * 4 if hidden else 0)
        row = {"layer": li, "fp32_bytes": fp32}
        comp = per_layer[li]
        if comp is not None:
            d_eff = lin_in // comp.rp_ratio if comp.rp_ratio > 1 else lin_in
            c = packmod.packed_nbytes((n_nodes, d_eff), comp.bits,
                                      comp.group_size) + 4
            if hidden:
                c += relu_mask_nbytes(n_nodes * d_out)
            row["compressed_bytes"] = c
            row["bits"] = comp.bits
        rows.append(row)
    return rows
