"""The one place the activation-seed scheme is defined (the reference's
``repro.engine.seeds``).

* an update ordinal ``o`` (the epoch for full-graph training, or
  ``epoch * n_parts + position`` for the mini-batch engine,
  :func:`batch_ordinals`) maps to the base SR seed ``(o + 1) * 7919``, so
  ``n_parts = 1`` reproduces the full-graph seeds;
* layer ``li`` offsets the base seed by ``li * 1013``;
* an LM step hashes to ``step * KNUTH_MULT``, and a serving KV write to
  :func:`kv_seed` of its position, slot, layer and field;
* the autoprec gradient probe draws two seeds from the training seed
  (:func:`probe_seeds`), and the mini-batch engine's per-epoch batch order
  comes from :func:`order_rng`.

Seeds are python ints (or int64 tensors) wrapped mod 2**32, the uint32 the
counter PRNG takes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.prng import KNUTH_MULT, MASK32, _mul32

#: Base multiplier of the update-ordinal seed scheme: ``(o + 1) * 7919``.
SR_SEED_PRIME = 7919

#: Per-layer seed stride: layer li stashes with ``base + li * 1013``.
LAYER_SEED_STRIDE = 1013

#: Salt for the batch-order shuffle rng of the mini-batch engine.
ORDER_SALT = 0x5EED_BA5E

#: Knuth multiplicative hash deriving the autoprec probe seeds (and the LM
#: per-step activation seed).
_PROBE_MULT = int(KNUTH_MULT)


def sr_seed(ordinal: int) -> int:
    """Base stochastic-rounding seed for one update ordinal: the epoch
    (full graph) or one of :func:`batch_ordinals` (mini-batch), wrapped to
    uint32 first as the reference's ``np.uint32`` cast does."""
    return (((int(ordinal) & MASK32) + 1) * SR_SEED_PRIME) & MASK32


def batch_ordinals(epoch: int, n_batches: int, update: int, group: int,
                   micro: int, dp: int) -> np.ndarray:
    """Update ordinals of one micro-batch's dp group inside an epoch:
    ``epoch * n_batches + update * group + micro * dp + arange(dp)``, each
    fed to :func:`sr_seed`."""
    base = epoch * n_batches + update * group
    return base + micro * dp + np.arange(dp)


def layer_seed(seed: int, li: int) -> int:
    """Layer li's stash seed given the update's base seed."""
    return (int(seed) + li * LAYER_SEED_STRIDE) & MASK32


def _wrap(x):
    """``x`` mod 2**32: a python int, or an int64 tensor of uint32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return int(x) & MASK32


def step_seed(step):
    """Activation-compression base seed for one LM step: the Knuth hash of
    the step counter, ``step * KNUTH_MULT`` mod 2**32 (a python int, or an
    int64 tensor of uint32 values for a tensor ``step``)."""
    if isinstance(step, torch.Tensor):
        return _mul32(_wrap(step), KNUTH_MULT)
    return (_wrap(step) * KNUTH_MULT) & MASK32


#: Per-slot seed stride for the serving KV cache: decorrelates two slots
#: that sit at the same absolute position (next prime after the ordinal
#: scheme's 7919 so the streams never alias).
KV_SLOT_STRIDE = 7927


def kv_seed(pos, slot, li, field):
    """SR seed for one serving KV-cache write.

    ``pos`` is the token's absolute position (prompt + generated), ``slot``
    the scheduler slot, ``li`` the layer, ``field`` 0 for K / 1 for V.  The
    base stream is the LM step hash of the position; slot and (layer,
    field) offsets draw decorrelated counter-PRNG streams.  Every argument
    may be a python int or an integer tensor (they broadcast); the result
    wraps mod 2**32 like the reference's uint32 arithmetic.
    """
    base = step_seed(pos) + _wrap(slot) * KV_SLOT_STRIDE
    off = (_wrap(li) * 2 + _wrap(field)) * LAYER_SEED_STRIDE
    return _wrap(base + off)


def probe_seeds(seed: int) -> tuple[int, int]:
    """Two decorrelated uint32 seeds for the autoprec two-seed grad probe."""
    h = int(seed) * _PROBE_MULT
    return (h + 101) & MASK32, (h + 211) & MASK32


def order_rng(seed: int) -> np.random.Generator:
    """The numpy rng that draws the mini-batch engine's per-epoch batch
    orders (host side)."""
    return np.random.default_rng(seed ^ ORDER_SALT)
