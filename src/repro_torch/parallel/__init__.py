"""Partition-parallel training over ``torch.distributed`` process groups
(the reference's ``repro.parallel``, its graph half): the static halo
program, the differentiable halo exchange and the byte counts
(:mod:`~repro_torch.parallel.halo`), and :func:`run_ranks`, which runs a
function on every rank of a group of spawned processes
(:mod:`~repro_torch.parallel.spawn`).  The LM sharding rules
(``sharding.py``, ``annotate.py``) are not ported (ROADMAP A.12b)."""
from repro_torch.parallel.halo import (HaloProgram, HaloRound,
                                       build_halo_program, dp_size,
                                       exchange_widths, graph_mesh,
                                       group_rank, halo_bytes_per_epoch,
                                       halo_bytes_per_round, halo_exchange,
                                       rank_round, send_csr)
from repro_torch.parallel.spawn import run_ranks

__all__ = ["HaloProgram", "HaloRound", "build_halo_program", "rank_round",
           "send_csr", "exchange_widths", "graph_mesh", "dp_size",
           "group_rank", "halo_bytes_per_round", "halo_bytes_per_epoch",
           "halo_exchange", "run_ranks"]
