"""Manifest-based, atomic checkpoints (the reference's
``repro.checkpoint.checkpointer``).

Layout: ``<dir>/step_<N>/manifest.json`` and one ``leaf_<i>.npy`` a leaf.
A save writes ``step_<N>.tmp`` and renames it, so a crash mid-save never
leaves a partial ``step_<N>``: ``latest_step`` sees only whole checkpoints.

A tree is any nesting of dicts, lists, tuples and ``nn.Module``s whose
leaves are tensors or Python numbers (the optimizer's ``step`` counter).
Leaves are stored as full host arrays in the tree's own order; the
manifest names each leaf's path, dtype and shape.  numpy has no bfloat16,
so a bfloat16 leaf is stored as the ``uint16`` view of its bits and the
manifest keeps its dtype.

``load_checkpoint(dir, step, like)`` restores into ``like``'s tensors in
place (parameters keep their identity, so optimizers and closures that
hold them see the restored values) and returns ``like``'s structure with
the restored numbers in place of the old ones.

``save_checkpoint(..., async_write=True)`` copies every leaf to host memory
before it returns and writes the files on a thread.  The copy must come
first: the port's optimizer updates parameters in place, so a thread that
read them later would save the next step's weights.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
from torch import nn


def _items(tree, path: str = ""):
    """(path, leaf) pairs of ``tree`` in a fixed order."""
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield f"{path}{name}", t
    elif isinstance(tree, dict):
        for key, val in tree.items():
            yield from _items(val, f"{path}{key}.")
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from _items(val, f"{path}{i}.")
    else:
        yield path.rstrip("."), tree


def _rebuild(tree, values):
    """``tree``'s structure with each number leaf taken from ``values`` in
    order (tensor leaves were restored in place and stay as they are)."""
    if isinstance(tree, (nn.Module, torch.Tensor)):
        return tree
    if isinstance(tree, dict):
        return {key: _rebuild(val, values) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(val, values) for val in tree)
    return next(values)


def _to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` on the host (bfloat16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        a = t.to("cpu", copy=True).numpy()
        return a.view(np.uint16) if leaf.dtype == torch.bfloat16 else a
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return type(leaf).__name__


def save_checkpoint(ckpt_dir, step: int, tree, *, async_write: bool = False):
    """Save ``tree`` as ``<ckpt_dir>/step_<step>``.  With ``async_write``
    the host copies are taken now and the files written on a thread, which
    is returned (join it before relying on the files); else None."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    items = list(_items(tree))
    host = [_to_host(leaf) for _, leaf in items]
    manifest = {"step": step, "n_leaves": len(items),
                "paths": [p for p, _ in items],
                "dtypes": [_dtype_name(leaf) for _, leaf in items],
                "shapes": [list(a.shape) for a in host]}

    def write():
        tmp = ckpt_dir / f"step_{step}.tmp"
        final = ckpt_dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        for i, a in enumerate(host):
            np.save(tmp / f"leaf_{i}.npy", a)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir) -> int | None:
    """The newest whole checkpoint's step in ``ckpt_dir`` (None if none)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.is_dir() and d.name.startswith("step_")
             and not d.name.endswith(".tmp")
             and (d / "manifest.json").exists()]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir, step: int, like):
    """Restore step ``step`` into ``like`` (see the module docstring)."""
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    items = list(_items(like))
    if manifest["n_leaves"] != len(items):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(items)}")
    numbers = []
    for i, (path, proto) in enumerate(items):
        if manifest["paths"][i] != path:
            raise ValueError(f"leaf {i} is {manifest['paths'][i]!r} in the "
                             f"checkpoint, {path!r} here")
        a = np.load(d / f"leaf_{i}.npy")
        if not isinstance(proto, torch.Tensor):
            numbers.append(type(proto)(a))
            continue
        src = torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                               and proto.dtype == torch.bfloat16 else a)
        if proto.dtype == torch.bfloat16:
            src = src.view(torch.bfloat16)
        with torch.no_grad():
            proto.copy_(src.reshape(proto.shape))
    return _rebuild(like, iter(numbers))
