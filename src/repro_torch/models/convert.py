"""Weight carry-over from the JAX reference: the reference's ``Model.init``
parameter tree, as numpy arrays, into the port's :class:`Model`, so both
packages compute from the same weights.  Nothing here imports JAX: the
caller hands over numpy arrays (``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import Model, check_family


def to_tensor(a, device=None) -> torch.Tensor:
    """A numpy array as a tensor with the same dtype and bits; bfloat16
    (the ``ml_dtypes`` numpy type JAX hands out) goes through its 16-bit
    pattern."""
    a = np.array(a)   # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(stacked: dict, device) -> list:
    """A tree of layer-stacked arrays as one tree a layer."""
    n = np.asarray(next(iter(_leaves(stacked)))).shape[0]
    return [_map(stacked, lambda a, li=li: to_tensor(np.asarray(a)[li],
                                                       device))
            for li in range(n)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_from_jax(params_np: dict, cfg, device="cuda", *,
                    impl: str = "auto") -> Model:
    """The reference's parameter pytree (numpy leaves, layer weights
    stacked on a leading layer axis; a MoE layer's ``moe`` stacks are
    (L, E, D, F)) as the port's :class:`Model` on ``device`` (the card
    unless the CPU is asked for).  The ``layers`` and ``enc_layers`` axes
    are unstacked into one module per layer, and the hybrid's
    ``shared_attn`` and the enc-dec's ``enc_norm`` carry over as they
    are, every leaf keeping its dtype and bits (the router float32, the
    experts and convs bf16)."""
    check_family(cfg)
    device = resolve_device(device)
    tree = {name: _map(params_np[name], lambda a: to_tensor(a, device))
            for name in ("embed", "final_norm", "lm_head", "shared_attn",
                         "enc_norm") if name in params_np}
    tree["layers"] = _unstack(params_np["layers"], device)
    if "enc_layers" in params_np:
        tree["enc_layers"] = _unstack(params_np["enc_layers"], device)
    return Model(cfg, tree, device=device, impl=impl)
