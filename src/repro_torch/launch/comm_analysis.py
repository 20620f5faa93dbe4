"""Per-device counts of an eager step: dot FLOPs, a byte model of device
memory traffic, collective wire bytes by kind, and the peak of live bytes
(the counterpart of the reference's ``repro.launch.hlo_analysis``).

The reference parses XLA's optimized program text and multiplies each
``while`` body by its trip count.  The port has no program text: an
eager step dispatches every op of every layer, so a dispatch mode sees
each one as it runs and there are no loops to count.  :class:`StepCounter`
is that mode.  It sees the ops each rank runs on its local shards (it
declines the DTensor-level op, so DTensor dispatches it as the local ops
and collectives it runs, which the mode then sees), and it skips the ops
DTensor's sharding propagation runs on global shapes to infer a layout.
On ``meta`` tensors under a ``"fake"`` process group (the dry run)
nothing is computed or sent, and the counts are the same.

What carries over from the reference, exactly:

* the ring model's wire bytes a device (``hlo_analysis.py:8-17``): an
  all-gather ``(g-1)/g`` of its result, an all-reduce ``2(g-1)/g``, a
  reduce-scatter ``(g-1)`` times its result, an all-to-all ``(g-1)/g``, a
  collective-permute (point to point) 1.0, for a group of g ranks
  (:func:`wire_bytes`);
* the memory-traffic model: the bytes of every operand and result of each
  op, an upper bound (nothing is fused; a view moves nothing; an indexing
  op moves twice its result, as the reference charges a gather or a
  dynamic slice);
* dot FLOPs: ``2 * M * N * K`` of each matrix product (torch's own FLOP
  formulas, ``torch.utils.flop_counter``), on the local shapes.

Both the functional collectives DTensor issues (``_c10d_functional``) and
the blocking ones (``c10d``) the port's own layers issue are counted.
"""
from __future__ import annotations

import sys
import weakref

import torch

#: Collective kinds, the reference's names.
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Bytes a device sends for one collective of ``kind`` whose result
    (per device) is ``result_bytes``, over ``group`` ranks (the
    reference's ring factors)."""
    g = group
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return result_bytes * 2 * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _group_size(group) -> int:
    """Ranks of a process group: a ``ProcessGroup`` (the blocking ops'
    argument) or a group name (the functional ones')."""
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(group).size()
    if isinstance(group, torch.ScriptObject):
        group = torch._C._distributed_c10d.ProcessGroup.unbox(group)
    return group.size()


def _collective(func, args, out) -> tuple | None:
    """(kind, result bytes a device, group size) of a collective op, or
    None for any other op."""
    ns, name = func.namespace, func._opname
    if ns == "_c10d_functional":
        if name in ("all_gather_into_tensor", "all_gather_into_tensor_out"):
            return "all-gather", _nbytes(args[0]) * args[1], args[1]
        if name in ("all_reduce", "all_reduce_"):
            return "all-reduce", _nbytes(args[0]), _group_size(args[2])
        if name == "reduce_scatter_tensor":
            return ("reduce-scatter", _nbytes(args[0]) / args[2], args[2])
        if name == "all_to_all_single":
            return "all-to-all", _nbytes(out), _group_size(args[3])
        return None
    if ns != "c10d":
        return None
    if name == "allreduce_":
        return ("all-reduce", sum(_nbytes(t) for t in args[0]),
                _group_size(args[1]))
    if name == "_allgather_base_":
        return "all-gather", _nbytes(args[0]), _group_size(args[2])
    if name == "allgather_":
        return ("all-gather", sum(_nbytes(t) for t in args[0][0]),
                _group_size(args[2]))
    if name == "_reduce_scatter_base_":
        return "reduce-scatter", _nbytes(args[0]), _group_size(args[2])
    if name == "alltoall_base_":
        return "all-to-all", _nbytes(args[0]), _group_size(args[2])
    if name in ("send", "recv_"):
        return ("collective-permute", sum(_nbytes(t) for t in args[0]), 2)
    return None


#: Ops that move nothing: they make or relabel tensors.
_FREE = {"empty", "empty_strided", "empty_like", "detach", "lift_fresh",
         "alias", "wait_tensor", "_wrap_tensor_autograd"}
#: Indexing ops: twice their result, as the reference charges a gather.
_INDEXING = {"index", "index_select", "gather", "embedding", "slice",
             "select", "take_along_dim"}
#: Files whose ops run on global shapes to infer a layout (DTensor's
#: sharding propagation and its schema's stand-ins), not on a shard.
_PROPAGATION = ("sharding_prop.py", "_op_schema.py", "op_schema.py")


def _in_propagation(depth: int = 12) -> bool:
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _aliases(func) -> bool:
    """True where every result of ``func`` is a view of an input (it
    moves nothing) and none is written."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class StepCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts, per device, what the ops run under it do: ``flops`` (dot
    FLOPs), ``hbm`` (operand and result bytes), ``coll`` (wire bytes by
    kind of :data:`KINDS`), ``counts`` (collectives by kind), ``ops``, and
    ``peak`` (the most bytes that ops run under it held alive at once)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops_of = flop_registry
        self.flops = 0.0
        self.hbm = 0.0
        self.coll = {k: 0.0 for k in KINDS}
        self.counts = {k: 0 for k in KINDS}
        self.ops = 0
        self.live = self.peak = 0

    def _track(self, out) -> None:
        """Charge each fresh result's bytes while it is alive."""
        for t in out if isinstance(out, (list, tuple)) else (out,):
            if isinstance(t, torch.Tensor) and type(t) is torch.Tensor:
                n = _nbytes(t)
                if n:
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it as local ops
        out = func(*args, **kwargs)
        if _in_propagation():
            return out
        self.ops += 1
        coll = _collective(func, args, out)
        if coll is not None:
            kind, nbytes, group = coll
            self.coll[kind] += wire_bytes(kind, nbytes, group)
            self.counts[kind] += 1
            return out
        name = func._opname
        packet = func._overloadpacket
        if packet in self._flops_of:
            self.flops += self._flops_of[packet](*args, **kwargs,
                                                 out_val=out)
        if name in _FREE or _aliases(func):
            return out
        outs = out if isinstance(out, (list, tuple)) else (out,)
        res = sum(_nbytes(t) for t in outs)
        if name in _INDEXING:
            self.hbm += 2 * res
        else:
            ins = sum(_nbytes(a) for a in torch.utils._pytree.tree_leaves(
                (args, kwargs)))
            write = any(r.alias_info is not None and r.alias_info.is_write
                        for r in func._schema.returns)
            self.hbm += ins + (0 if write else res)
            if not write:
                self._track(out)
        return out

    def report(self) -> dict:
        return {"flops": self.flops, "hbm": self.hbm,
                "coll": dict(self.coll), "counts": dict(self.counts),
                "coll_total": sum(self.coll.values()), "ops": self.ops,
                "peak": self.peak}
