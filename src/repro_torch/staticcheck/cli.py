"""``python -m repro_torch.staticcheck``: run every pass, gate on new
findings.

Exit codes: 0, clean or fully baselined; 1, at least one finding not in
the baseline; 2, a pass crashed (an analyzer bug, not a repo finding).

The saved-tensor audit runs the forward and backward of the whole plan
matrix on ``--device`` (the card unless the CPU is asked for), a few
seconds; its results are cached in
``results/staticcheck/torch_audit_cache.json`` keyed by the device and a
digest of every source the audited programs could depend on
(``src/repro_torch/**/*.py`` and ``src/repro_torch/csrc/*``), so repeated
runs on an unchanged tree skip straight to the verdict.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import traceback

from repro_torch.staticcheck import (deadcode, findings as fmod,
                                     kernel_contracts, plan_verify,
                                     saved_audit, seed_lint)
from repro_torch.staticcheck.matrix import audit_matrix

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
PKG_ROOT = pathlib.Path(__file__).resolve().parents[1]
DEFAULT_BASELINE = pathlib.Path(__file__).resolve().parent / "baseline.json"
DEFAULT_CACHE = (REPO_ROOT / "results" / "staticcheck"
                 / "torch_audit_cache.json")

PASSES = ("seed-lint", "plan-verify", "kernel-contracts", "saved-audit")


def tree_digest(device: str, root: pathlib.Path = PKG_ROOT) -> str:
    """Digest of everything the audited matrix depends on: the device, the
    port's Python tree and its CUDA sources."""
    h = hashlib.sha256(device.encode())
    paths = sorted(root.rglob("*.py")) + sorted((root / "csrc").glob("*"))
    for p in paths:
        h.update(str(p.relative_to(root)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def run_saved_audit(cache: pathlib.Path | None,
                    device: str) -> list[fmod.Finding]:
    digest = tree_digest(device)
    if cache is not None and cache.exists():
        try:
            data = json.loads(cache.read_text())
        except ValueError:
            data = {}
        if data.get("digest") == digest:
            results = [saved_audit.AuditResult.from_json(r)
                       for r in data["results"]]
            return [f for r in results for f in r.findings]
    results = saved_audit.run(device=device)
    for r in results:
        print(f"  {r.key}: ledger {r.ledger_bytes} bytes, report "
              f"{r.report_bytes}, {r.n_saved} saved tensor(s)")
    if cache is not None:
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps(
            {"digest": digest, "results": [r.to_json() for r in results]},
            indent=2) + "\n")
    return [f for r in results for f in r.findings]


def run_pass(name: str, cache: pathlib.Path | None,
             device: str) -> list[fmod.Finding]:
    if name == "seed-lint":
        return seed_lint.run()
    if name == "plan-verify":
        out = []
        for case in audit_matrix():
            out.extend(plan_verify.verify_plan(
                case.plan, case.cfg, case.in_dim, case.n_nodes,
                where=case.key))
        out.extend(plan_verify.verify_kv_matrix())
        return out
    if name == "kernel-contracts":
        return kernel_contracts.run()
    if name == "saved-audit":
        return run_saved_audit(cache, device)
    if name == "dead-code":
        return deadcode.sweep()
    raise ValueError(f"unknown pass {name!r}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.staticcheck",
        description="compression-invariant static analysis over the port")
    ap.add_argument("--ci", action="store_true",
                    help="CI mode: plain output, all gating passes")
    ap.add_argument("--baseline", type=pathlib.Path,
                    default=DEFAULT_BASELINE,
                    help="suppression file (default: %(default)s)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept the current findings into --baseline")
    ap.add_argument("--dead-code", action="store_true",
                    help="also run the opt-in unused-symbol sweep")
    ap.add_argument("--passes", default=None, metavar="CSV",
                    help=f"subset of passes to run (default: all of "
                         f"{','.join(PASSES)})")
    ap.add_argument("--cache", type=pathlib.Path, default=DEFAULT_CACHE,
                    help="saved-audit result cache (default: %(default)s)")
    ap.add_argument("--no-cache", action="store_true",
                    help="re-run the plan matrix unconditionally")
    ap.add_argument("--device", default="cuda",
                    help="where the saved-tensor audit runs (default: "
                         "%(default)s; 'cpu' runs the plain kernels)")
    args = ap.parse_args(argv)

    names = (args.passes.split(",") if args.passes
             else list(PASSES) + (["dead-code"] if args.dead_code else []))
    cache = None if args.no_cache else args.cache

    all_findings: list[fmod.Finding] = []
    for name in names:
        try:
            got = run_pass(name.strip(), cache, args.device)
        except Exception:
            print(f"[{name}] pass crashed:", file=sys.stderr)
            traceback.print_exc()
            return 2
        print(f"[{name}] {len(got)} finding(s)")
        for f in got:
            print(f"  {f.render()}")
        all_findings.extend(got)

    if args.write_baseline:
        fmod.save_baseline(args.baseline, all_findings)
        print(f"wrote {len(all_findings)} finding(s) to {args.baseline}")
        return 0

    fresh = fmod.new_findings(all_findings, fmod.load_baseline(args.baseline))
    n_old = len(all_findings) - len(fresh)
    if fresh:
        print(f"FAIL: {len(fresh)} new finding(s) "
              f"({n_old} baselined)", file=sys.stderr)
        return 1
    print(f"OK: no new findings ({n_old} baselined)")
    return 0
