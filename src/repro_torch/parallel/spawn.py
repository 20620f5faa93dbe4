"""Run a function on every rank of a process group of spawned processes.

``run_ranks(target, world)`` starts ``world`` processes by ``spawn`` (CUDA
cannot be forked), joins them in one process group over a ``FileStore`` in
a fresh temporary directory (no port is opened), calls ``target(rank,
world, *args)`` in each, and returns the ranks' return values in rank
order.  Each return value travels back through ``torch.save`` in that
directory, so it must be picklable (move tensors to the CPU first).

Nothing can hang: the group is made with ``timeout``, the parent joins
every child within ``timeout`` seconds in all, kills what is still alive,
and raises with each failed rank's traceback.  The backend is the
caller's choice (``"gloo"``: two ranks may share one card, or run on the
CPU; ``"nccl"``: one card per rank); nothing retries another.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback

import torch


def _child(target, rank: int, world: int, backend: str, root: str,
           timeout: float, args: tuple) -> None:
    import torch.distributed as dist

    out = os.path.join(root, f"rank{rank}.pt")
    try:
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(root, "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        torch.save(("ok", target(rank, world, *args)), out)
    except BaseException:
        torch.save(("error", traceback.format_exc()), out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(target, world: int, args: tuple = (), *,
              backend: str = "gloo", timeout: float = 120.0) -> list:
    """``[target(rank, world, *args) for rank in range(world)]``, each in a
    spawned process of one ``backend`` process group (see the module
    docstring).  ``target`` must be importable by name (a module-level
    function).  Raises RuntimeError if a rank fails, exits without a
    result, or is still running after ``timeout`` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root:
        procs = [ctx.Process(target=_child, args=(target, rank, world,
                                                  backend, root, timeout,
                                                  tuple(args)))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [rank for rank, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results, failures = [], []
        for rank, p in enumerate(procs):
            path = os.path.join(root, f"rank{rank}.pt")
            if rank in hung:
                failures.append(f"rank {rank}: still running after "
                                f"{timeout} s, killed")
            elif not os.path.exists(path):
                failures.append(f"rank {rank}: exit code {p.exitcode}, "
                                "no result")
            else:
                status, value = torch.load(path, weights_only=False)
                if status != "ok":
                    failures.append(f"rank {rank}:\n{value}")
                results.append(value)
        if failures:
            raise RuntimeError("run_ranks: " + "\n".join(failures))
        return results
