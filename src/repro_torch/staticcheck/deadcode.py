"""Unused-symbol sweep over ``src/repro_torch`` (the CLI's opt-in
``--dead-code``; a copy of the reference's ``repro.staticcheck.deadcode``).

A module-level function or class in ``src/repro_torch`` is *dead* when
nothing anywhere in the repo (source, tests, benchmarks, scripts,
examples, ``chip_smoke.py``) references it: not by name inside its own module (helpers a module still
calls are alive), not through an import (resolved per defining module, so
two modules exporting the same name are tracked separately), not through
a module-alias attribute access (``from repro_torch.offload import
engine as eng; eng.make_writer``), and not through the engine's lazy-export pattern
(a dict literal mapping ``"symbol" -> "module.path"`` strings, PEP 562
``__getattr__`` dispatch).

``__init__.py`` re-export imports are deliberately *transparent*: a shim
kept importable only by its package's ``__init__`` is exactly the dead
code this sweep exists to surface, so a re-export counts as a use only
when the package-level name is itself referenced somewhere.

The sweep is a reviewer aid, not a gate: it runs only under
``--dead-code`` and reports findings for a human to delete (or baseline,
for symbols kept intentionally as public API).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib

from repro_torch.staticcheck.findings import Finding

PASS = "dead-code"

#: Names never reported: entry points and protocol methods looked up
#: implicitly (by python itself, pytest, or console runners).
IMPLICIT_USES = {"main", "__getattr__", "__dir__"}

#: Reference-scan roots relative to the repo root: directories, and the
#: smoke script beside them.
SCAN_DIRS = ("src", "tests", "benchmarks", "scripts", "examples",
             "chip_smoke.py")


@dataclasses.dataclass
class Symbol:
    module: str            # dotted module defining it
    name: str
    lineno: int
    rel: str               # file path relative to the repo root


def _module_of(path: pathlib.Path, src_root: pathlib.Path) -> str:
    rel = path.relative_to(src_root).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_from(node: ast.ImportFrom, module: str) -> str | None:
    """Absolute module an ``ImportFrom`` names (relative imports resolved
    against the importing module)."""
    if node.level == 0:
        return node.module
    base = module.split(".")
    # level=1 from a module file strips the module leaf; each extra level
    # strips one package
    base = base[:len(base) - node.level]
    if node.module:
        base.append(node.module)
    return ".".join(base) if base else None


def collect_symbols(src_root: pathlib.Path,
                    repo_root: pathlib.Path) -> list[Symbol]:
    syms = []
    for path in sorted(src_root.rglob("*.py")):
        module = _module_of(path, src_root.parent)
        tree = ast.parse(path.read_text(), filename=str(path))
        for n in tree.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                if n.name.startswith("__") or n.name in IMPLICIT_USES:
                    continue
                syms.append(Symbol(module=module, name=n.name,
                                   lineno=n.lineno,
                                   rel=str(path.relative_to(repo_root))))
    return syms


def _scan_file(path: pathlib.Path, module: str | None, is_init: bool,
               uses: set[tuple[str | None, str]],
               reexports: list[tuple[str, str, str, str]]) -> None:
    """Record (module, name) uses from one file.

    ``uses`` entries with ``module=None`` are *unresolved* name uses (bare
    ``Name`` loads and attribute accesses through non-module values) —
    they match a symbol of that name in any module.  ``reexports`` rows
    are ``(pkg, name, src_module, src_name)`` aliases recorded by
    ``__init__`` re-export imports.
    """
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError:
        return
    alias_to_module: dict[str, str] = {}
    imported_syms: dict[str, tuple[str, str]] = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                alias_to_module[a.asname or a.name.split(".")[0]] = \
                    a.name if a.asname else a.name.split(".")[0]
        elif isinstance(n, ast.ImportFrom):
            src = _resolve_from(n, module) if module else n.module
            if src is None:
                continue
            for a in n.names:
                if a.name == "*":
                    continue
                local = a.asname or a.name
                if is_init and module:
                    # __init__ re-export: transparent — alias, not a use
                    reexports.append((module, local, src, a.name))
                else:
                    uses.add((src, a.name))
                    # `from pkg import mod` also binds a module alias
                    alias_to_module[local] = f"{src}.{a.name}"
                imported_syms[local] = (src, a.name)
    for n in ast.walk(tree):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name):
            mod = alias_to_module.get(n.value.id)
            if mod is not None:
                uses.add((mod, n.attr))
            else:
                uses.add((None, n.attr))
        elif isinstance(n, ast.Name) and not isinstance(n.ctx, ast.Store):
            # bare name load: a use of whatever it was imported as, or an
            # unresolved use inside the defining module itself
            if n.id in imported_syms and not is_init:
                uses.add(imported_syms[n.id])
            else:
                uses.add((None, n.id))
        elif isinstance(n, ast.Dict):
            # lazy-export pattern: {"symbol": "module.path", ...}
            for k, v in zip(n.keys, n.values):
                if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                        and isinstance(v, ast.Constant)
                        and isinstance(v.value, str) and "." in v.value):
                    uses.add((v.value, k.value))
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "getattr" and len(n.args) >= 2
                and isinstance(n.args[1], ast.Constant)
                and isinstance(n.args[1].value, str)):
            uses.add((None, n.args[1].value))


def sweep(repo_root: pathlib.Path | None = None) -> list[Finding]:
    if repo_root is None:
        repo_root = pathlib.Path(__file__).resolve().parents[3]
    src_root = repo_root / "src" / "repro_torch"
    symbols = collect_symbols(src_root, repo_root)
    uses: set[tuple[str | None, str]] = set()
    reexports: list[tuple[str, str, str, str]] = []
    for d in SCAN_DIRS:
        base = repo_root / d
        if not base.exists():
            continue
        paths = [base] if base.is_file() else sorted(base.rglob("*.py"))
        for path in paths:
            module = None
            if d == "src":
                module = _module_of(path, src_root.parent)
            _scan_file(path, module, path.name == "__init__.py",
                       uses, reexports)

    # close re-export aliases: a *resolved* use of the package-level name
    # is a use of the re-exported source symbol (one hop is enough for
    # this tree; unresolved bare-name uses already match by name below)
    closed = set(uses)
    for pkg, local, src, name in reexports:
        if (pkg, local) in uses:
            closed.add((src, name))
    # a bare-name use only counts within non-init files; re-exported
    # names still need a package-level reference
    resolved_names = {(m, n) for (m, n) in closed if m is not None}
    unresolved = {n for (m, n) in closed if m is None}

    out = []
    for s in symbols:
        if (s.module, s.name) in resolved_names:
            continue
        if s.name in unresolved:
            continue
        out.append(Finding(
            PASS, "unused-symbol", f"{s.rel}:{s.lineno}",
            f"{s.module}.{s.name} is referenced nowhere in "
            f"{'/'.join(SCAN_DIRS)} (re-export imports are transparent); "
            "delete it or baseline it as intentional API"))
    return out
