"""The one place the activation-seed scheme is defined (the reference's
``repro.engine.seeds``, full-graph part).

* an update ordinal ``o`` (the epoch, for full-graph training) maps to the
  base SR seed ``(o + 1) * 7919``;
* layer ``li`` offsets the base seed by ``li * 1013``.

Seeds are python ints wrapped mod 2**32, the uint32 the counter PRNG takes.
"""
from __future__ import annotations

from repro_torch.core.prng import MASK32

#: Base multiplier of the update-ordinal seed scheme: ``(o + 1) * 7919``.
SR_SEED_PRIME = 7919

#: Per-layer seed stride: layer li stashes with ``base + li * 1013``.
LAYER_SEED_STRIDE = 1013


def sr_seed(ordinal: int) -> int:
    """Base stochastic-rounding seed for one optimizer-update ordinal."""
    return (((int(ordinal) & MASK32) + 1) * SR_SEED_PRIME) & MASK32


def layer_seed(seed: int, li: int) -> int:
    """Layer li's stash seed given the update's base seed."""
    return (int(seed) + li * LAYER_SEED_STRIDE) & MASK32
