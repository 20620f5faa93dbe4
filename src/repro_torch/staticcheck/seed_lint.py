"""Seed/RNG discipline lint: an AST pass over ``src/repro_torch`` (the
reference's ``repro.staticcheck.seed_lint``, its rules restated for
torch's random model and eager execution).

The engine's replay guarantees rest on one seed scheme
(:mod:`repro_torch.engine.seeds`, constants shared through
:mod:`repro_torch.core.prng`).  Any module that re-derives a stream from
the raw constants can silently desynchronize from the scheme when a
constant changes: the counter-wraparound bug class.  The CUDA sources
(``csrc/*.cu``) are not linted: they spell the hash by design, and the
layout tests hold them bit-equal.  Rules:

* ``seed-constant``: a numeric literal equal to one of the scheme's
  constants (7919, 1013, the order salt, the Knuth hash multiplier)
  anywhere outside the two modules that *define* them.  Call the
  ``engine.seeds`` helpers instead;
* ``prng-key-arith``: ``manual_seed(...)`` whose argument does arithmetic
  (``Generator().manual_seed(seed + 3)``-style ad-hoc stream derivation)
  outside ``engine/seeds.py``; derived streams belong there, where the
  scheme is pinned by tests;
* ``jit-host-nondeterminism``: calls into Python ``random`` / ``time`` /
  ``datetime`` inside the bodies that run on the training path: a
  ``torch.autograd.Function``'s ``forward`` / ``backward`` or an
  ``nn.Module``'s ``forward`` (and functions nested in them); host
  nondeterminism there breaks bit-replay from one run to the next;
* ``sr-seed-reuse``: two ``sr_seed`` / ``layer_seed`` / ``step_seed`` calls
  with identical literal arguments in one function: two stashes drawing
  the same SR stream correlate their rounding noise (the variance model
  assumes independence across layers);
* ``host-callback-tap``: a device-to-host read (``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize``) inside those
  bodies anywhere except the two sanctioned homes: the obs probe
  (``obs/quantstats.py``) and the offload store (``offload/engine.py``).
  A read there stalls the card every step and is invisible to the
  saved-tensor audit: the port's counterpart of the reference's untracked
  host callback;
* ``obs-tap-dataflow``: any ``tap(...)`` call inside the residual/stash
  dataflow modules (``engine/forward.py``, ``offload/engine.py``,
  ``offload/arena.py``): obs taps must observe training from a *separate*
  probe pass, never from inside the stash path, or obs-on steps diverge
  from obs-off and the bit-identity gate is forfeit.
"""
from __future__ import annotations

import ast
import pathlib

from repro_torch.engine import seeds as seedsmod
from repro_torch.staticcheck.findings import Finding

PASS = "seed-lint"

#: The scheme's constants; literals equal to these are flagged elsewhere.
SEED_CONSTANTS = {
    seedsmod.SR_SEED_PRIME,
    seedsmod.LAYER_SEED_STRIDE,
    seedsmod.ORDER_SALT,
    int(seedsmod._PROBE_MULT),
}

#: Modules allowed to spell the constants: the scheme's definition sites.
ALLOWED_FILES = ("engine/seeds.py", "core/prng.py")

_HOST_MODULES = ("random", "time", "datetime")
_SEED_HELPERS = ("sr_seed", "layer_seed", "step_seed")

#: Device-to-host reads: tensor methods, and ``torch.cuda.synchronize``.
_HOST_READS = ("item", "cpu", "tolist", "numpy")

#: The two modules allowed a host read on the training path: the obs probe
#: and the offload store.
_CALLBACK_FILES = ("obs/quantstats.py", "offload/engine.py")

#: The residual/stash dataflow path: obs taps are banned here outright.
_DATAFLOW_FILES = ("engine/forward.py", "offload/engine.py",
                   "offload/arena.py")


def _expr_names(node: ast.AST) -> set[str]:
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _call_name(node: ast.Call) -> str:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def _traced_defs(tree: ast.Module) -> set[ast.AST]:
    """Function defs on the training path: ``forward`` / ``backward`` of a
    class deriving from ``Function``, ``forward`` of one deriving from
    ``Module``, and every def nested in them."""
    roots = set()
    for n in ast.walk(tree):
        if not isinstance(n, ast.ClassDef):
            continue
        bases = set().union(*(_expr_names(b) for b in n.bases)) \
            if n.bases else set()
        wanted = set()
        if "Function" in bases:
            wanted |= {"forward", "backward"}
        if "Module" in bases:
            wanted.add("forward")
        for item in n.body:
            if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and item.name in wanted):
                roots.add(item)
    traced = set()
    for root in roots:
        for n in ast.walk(root):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                traced.add(n)
    return traced


def _is_host_read(n: ast.Call) -> bool:
    f = n.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "synchronize":
        return "cuda" in _expr_names(f.value)
    return f.attr in _HOST_READS and not n.args and not n.keywords


def _literal_key(call: ast.Call) -> tuple | None:
    """Hashable identity of an all-literal argument list, else None."""
    vals = []
    for a in list(call.args) + [kw.value for kw in call.keywords]:
        if not isinstance(a, ast.Constant):
            return None
        vals.append(a.value)
    return (_call_name(call), tuple(vals))


def lint_source(src: str, filename: str) -> list[Finding]:
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Finding(PASS, "syntax", f"{filename}:{e.lineno}", str(e))]
    out = []
    allowed = filename.endswith(ALLOWED_FILES)

    # seed-constant: raw numeric literals of the scheme outside its home
    if not allowed:
        for n in ast.walk(tree):
            if (isinstance(n, ast.Constant) and isinstance(n.value, int)
                    and not isinstance(n.value, bool)
                    and n.value in SEED_CONSTANTS):
                out.append(Finding(
                    PASS, "seed-constant", f"{filename}:{n.lineno}",
                    f"raw seed constant {n.value} re-derived outside "
                    "engine/seeds.py: use the seeds helpers so the "
                    "scheme stays single-sourced"))

    # prng-key-arith: ad-hoc stream derivation at the manual_seed call
    if not filename.endswith("engine/seeds.py"):
        for n in ast.walk(tree):
            if not (isinstance(n, ast.Call)
                    and _call_name(n) == "manual_seed"):
                continue
            for a in list(n.args) + [kw.value for kw in n.keywords]:
                if any(isinstance(sub, ast.BinOp) for sub in ast.walk(a)):
                    out.append(Finding(
                        PASS, "prng-key-arith", f"{filename}:{n.lineno}",
                        "manual_seed argument does seed arithmetic inline; "
                        "derived streams belong in engine/seeds.py"))
                    break

    traced = _traced_defs(tree)
    # jit-host-nondeterminism: host clock/PRNG calls on the training path
    for fn in traced:
        for n in ast.walk(fn):
            if (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id in _HOST_MODULES):
                out.append(Finding(
                    PASS, "jit-host-nondeterminism",
                    f"{filename}:{n.lineno}",
                    f"{n.func.value.id}.{n.func.attr}() inside "
                    f"'{fn.name}' on the training path: host "
                    "nondeterminism breaks bit-replay"))

    # host-callback-tap: device-to-host reads on the training path outside
    # the sanctioned homes
    if not filename.endswith(_CALLBACK_FILES):
        for fn in traced:
            for n in ast.walk(fn):
                if isinstance(n, ast.Call) and _is_host_read(n):
                    out.append(Finding(
                        PASS, "host-callback-tap",
                        f"{filename}:{n.lineno}",
                        f"{_call_name(n)}() inside '{fn.name}' on the "
                        "training path: a device-to-host read belongs to "
                        "repro_torch.obs.quantstats (telemetry) or the "
                        "offload store; elsewhere it stalls the card and "
                        "evades the saved-tensor audit"))

    # obs-tap-dataflow: no obs taps on the residual/stash dataflow path
    if filename.endswith(_DATAFLOW_FILES):
        for n in ast.walk(tree):
            if isinstance(n, ast.Call) and _call_name(n) == "tap":
                out.append(Finding(
                    PASS, "obs-tap-dataflow", f"{filename}:{n.lineno}",
                    "obs tap() on the residual/stash dataflow path: "
                    "telemetry must run as a separate probe pass so "
                    "obs-on training stays bit-identical to obs-off"))

    # sr-seed-reuse: identical literal seed-helper calls in one function
    for n in ast.walk(tree):
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        seen: dict[tuple, int] = {}
        for c in ast.walk(n):
            if (isinstance(c, ast.Call)
                    and _call_name(c) in _SEED_HELPERS):
                key = _literal_key(c)
                if key is None:
                    continue
                if key in seen:
                    out.append(Finding(
                        PASS, "sr-seed-reuse", f"{filename}:{c.lineno}",
                        f"{key[0]}{key[1]} already drawn at line "
                        f"{seen[key]} of '{n.name}': reusing one SR "
                        "stream across stashes correlates their "
                        "rounding noise"))
                else:
                    seen[key] = c.lineno
    return out


def lint_file(path: pathlib.Path, root: pathlib.Path) -> list[Finding]:
    rel = path.relative_to(root).as_posix()
    return lint_source(path.read_text(), rel)


def run(root: pathlib.Path | None = None) -> list[Finding]:
    """Lint every module under ``src/repro_torch`` (or an explicit tree)."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[1]
    out = []
    for p in sorted(root.rglob("*.py")):
        out.extend(lint_file(p, root.parent))
    return out
