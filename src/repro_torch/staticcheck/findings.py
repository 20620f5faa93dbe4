"""Finding model + baseline suppression file shared by every pass (a copy
of the reference's ``repro.staticcheck.findings``).

A :class:`Finding` is one violation of a compression invariant:
``pass_name`` names the analysis pass ("saved-audit", "plan-verify",
"kernel-contracts", "seed-lint", "dead-code"), ``rule`` the specific
invariant, ``where`` the locator (``file:line`` for source passes, a
plan-matrix key or launch key for the symbolic passes), and ``message``
the human sentence.

Baselines are how pre-existing findings get grandfathered without
silencing the gate for *new* ones: a baseline JSON stores each accepted
finding's :meth:`Finding.fingerprint` (a stable hash of pass/rule/where,
deliberately not the message, so rewording a diagnostic doesn't
un-suppress it) plus the human text for review.  The CLI exits nonzero
exactly when a run produces a finding whose fingerprint is not in the
baseline.  The committed baseline (``baseline.json`` beside this module)
is empty: the port holds no known violations.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_name: str
    rule: str
    where: str
    message: str

    def fingerprint(self) -> str:
        h = hashlib.sha256(
            f"{self.pass_name}|{self.rule}|{self.where}".encode())
        return h.hexdigest()[:16]

    def render(self) -> str:
        return f"[{self.pass_name}/{self.rule}] {self.where}: {self.message}"

    def to_json(self) -> dict:
        return {"fingerprint": self.fingerprint(), "pass": self.pass_name,
                "rule": self.rule, "where": self.where,
                "message": self.message}

    @classmethod
    def from_json(cls, d: dict) -> "Finding":
        return cls(d["pass"], d["rule"], d["where"], d["message"])


def load_baseline(path: pathlib.Path) -> set[str]:
    """Fingerprints accepted by the baseline file (empty set if absent)."""
    if not path.exists():
        return set()
    data = json.loads(path.read_text())
    return {f["fingerprint"] for f in data.get("findings", [])}


def save_baseline(path: pathlib.Path, findings: list[Finding]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(
        {"findings": [f.to_json() for f in findings]},
        indent=2, sort_keys=True) + "\n")


def new_findings(findings: list[Finding],
                 baseline: set[str]) -> list[Finding]:
    """Findings not suppressed by the baseline, input order preserved."""
    return [f for f in findings if f.fingerprint() not in baseline]
