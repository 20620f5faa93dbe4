"""Step functions the launchers and tests drive (the reference's
``repro.launch.steps``; the training step waits for ROADMAP A.11)."""
from __future__ import annotations

import torch


def make_serve_step(model):
    """One decode step: greedy next token + updated cache (in place)."""

    def serve_step(cache, tokens):
        logits, cache = model.decode_step(cache, tokens)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], logits, cache

    return serve_step
