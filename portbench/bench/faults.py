"""Faults planted in the program under test, to show that the check fails
them: each patches the engine's step for as long as its context is open.

* ``state_unchanged``: the optimizer step returns its state unchanged;
* ``half_batch``: the loss leaves out every other training node and takes
  the mean over the rest;
* ``answer_altered``: the loss (and so every gradient) is altered by 1 %
  where it is produced.

The run's card has one chip, so no exchange between chips can be left out.
"""
from __future__ import annotations

import contextlib

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


@contextlib.contextmanager
def planted(kind: str):
    import torch

    import repro_torch.engine.compile as engine

    name = "adamw_update" if kind == "state_unchanged" else "masked_nll"
    orig = getattr(engine, name)
    if kind == "state_unchanged":
        def fault(grads, state, params, cfg):
            return None
    elif kind == "half_batch":
        def fault(logits, labels, mask):
            kept = mask.clone()
            kept[torch.nonzero(mask).flatten()[1::2]] = 0
            return orig(logits, labels, kept)
    elif kind == "answer_altered":
        def fault(logits, labels, mask):
            return orig(logits, labels, mask) * 1.01
    else:
        raise ValueError(f"unknown fault {kind!r}; known: {FAULTS}")
    setattr(engine, name, fault)
    try:
        yield
    finally:
        setattr(engine, name, orig)
