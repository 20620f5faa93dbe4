"""Parallel training over ``torch.distributed`` (the reference's
``repro.parallel``): the graph half's static halo program, differentiable
halo exchange and byte counts (:mod:`~repro_torch.parallel.halo`); the LM
half's sharding rules over a (data, model) device mesh
(:mod:`~repro_torch.parallel.sharding`) and the logical-axis annotations
the models carry (:mod:`~repro_torch.parallel.annotate`); and
:func:`run_ranks`, which runs a function on every rank of a group of
spawned processes (:mod:`~repro_torch.parallel.spawn`)."""
from repro_torch.parallel.halo import (HaloProgram, HaloRound,
                                       build_halo_program, dp_size,
                                       exchange_widths, graph_mesh,
                                       group_rank, halo_bytes_per_epoch,
                                       halo_bytes_per_round, halo_exchange,
                                       rank_round, send_csr)
from repro_torch.parallel.sharding import (batch_pspecs, cache_pspecs,
                                           param_pspecs, to_named)
from repro_torch.parallel.spawn import run_ranks

__all__ = ["batch_pspecs", "cache_pspecs", "param_pspecs", "to_named",
           "HaloProgram", "HaloRound", "build_halo_program", "rank_round",
           "send_csr", "exchange_widths", "graph_mesh", "dp_size",
           "group_rank", "halo_bytes_per_round", "halo_bytes_per_epoch",
           "halo_exchange", "run_ranks"]
