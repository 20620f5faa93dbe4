"""Build the port's CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  Libraries go to ``build/kernels/`` at the repository root,
named by a digest of the source, the ``csrc/*.cuh`` headers it includes
and the flags, so a changed source or header is rebuilt and an unchanged
one is reused.  Nothing is built when this module is imported:
:func:`load` builds at first use, :func:`build` builds several sources at
once, one ``nvcc`` process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quant_blockwise", "rp_matmul", "fused_matmul",
           "flash_attention")
# --fmad=false: the quantizer must round like the plain PyTorch version,
# which never contracts a multiply and an add into an FMA (the RP kernel
# asks for its FMAs explicitly).  -Xptxas -v reports registers and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: dict[tuple, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (put it on PATH or set CUDA_HOME): "
                           "the CUDA kernels are built from source at first "
                           "use")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _included(path: Path, seen: list[Path]) -> list[Path]:
    """``path`` and every ``csrc`` header it includes, transitively, each
    once, in the order first included."""
    if path in seen:
        return seen
    seen.append(path)
    for name in _INCLUDE.findall(path.read_bytes()):
        _included(CSRC / name.decode(), seen)
    return seen


def lib_path(name: str, defines: tuple = ()) -> Path:
    """The library of ``csrc/<name>.cu`` built with ``defines`` (extra
    ``-D`` flags of a measurement build) besides ``NVCC_FLAGS``."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for path in _included(CSRC / f"{name}.cu", []):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES, defines: tuple = ()) -> dict[str, str]:
    """Compile every source in ``names`` that has no current library, all
    in parallel; returns each compiled source's compiler log (register and
    spill counts).  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name, defines)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}:\n{logs[name]}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        build((name,), defines)
        lib = _LIBS[key] = ctypes.CDLL(str(lib_path(name, defines)))
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
