"""Mesh builders (the reference's ``repro.launch.mesh``): functions, never
module-level constants, so importing touches no process group.

:func:`make_mesh` is ``jax.make_mesh``'s counterpart over
``torch.distributed``: a ``DeviceMesh`` of ``shape`` over the ranks of the
default process group, which must hold exactly ``prod(shape)`` ranks (the
mesh never shrinks to fit).  A mesh of one rank needs no process group: it
is this process alone, and nothing is ever sent over it.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist


def _this_rank(shape: tuple, axes: tuple, device):
    """A mesh of ``shape`` (all ones) holding this rank alone, with no
    process group of its own."""
    from torch.distributed.device_mesh import DeviceMesh

    rank = dist.get_rank() if dist.is_initialized() else 0
    return DeviceMesh(torch.device(device).type,
                      torch.full(shape, rank, dtype=torch.int),
                      mesh_dim_names=axes, _init_backend=False, _rank=rank)


def make_mesh(shape: tuple, axes: tuple, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default group's
    ranks (rank-major), on ``device``'s type.  Raises, naming the ranks it
    needs, when the world is another size."""
    shape, axes = tuple(shape), tuple(axes)
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise RuntimeError(
            f"a mesh of shape {shape} over {axes} needs {need} ranks; the "
            f"process group has {world}")
    if need == 1:
        return _this_rank(shape, axes, device)
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh: (16, 16) over ("data", "model"),
    or (2, 16, 16) over ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_local_mesh(device="cuda"):
    """A (1, 1) mesh of this rank with the production axis names."""
    return _this_rank((1, 1), ("data", "model"), device)
