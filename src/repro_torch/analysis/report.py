"""PackLint findings and report serialization (``REPORT_torch_contracts.json``),
in the reference's ``packlint-report-v1`` schema."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Finding:
    """One checked subject under one rule.

    ``ok=True`` findings are kept in the report on purpose: the JSON artifact
    is the auditable record that a subject was *checked*, not just that
    nothing failed — a rule that silently skips a mode looks identical to a
    passing rule otherwise.
    """

    rule: str
    subject: str
    ok: bool
    detail: str = ""
    data: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = {"rule": self.rule, "subject": self.subject, "ok": self.ok}
        if self.detail:
            d["detail"] = self.detail
        if self.data:
            d["data"] = self.data
        return d


@dataclass
class Report:
    """All findings of one PackLint run, plus run metadata."""

    findings: List[Finding] = field(default_factory=list)
    meta: Dict[str, Any] = field(default_factory=dict)

    def extend(self, findings: List[Finding]) -> None:
        self.findings.extend(findings)

    @property
    def ok(self) -> bool:
        return all(f.ok for f in self.findings)

    def failures(self) -> List[Finding]:
        return [f for f in self.findings if not f.ok]

    def by_rule(self) -> Dict[str, List[Finding]]:
        out: Dict[str, List[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def to_dict(self) -> Dict[str, Any]:
        rules = {}
        for rule, fs in self.by_rule().items():
            rules[rule] = {
                "checked": len(fs),
                "failed": sum(not f.ok for f in fs),
                "findings": [f.to_dict() for f in fs],
            }
        return {
            "schema": "packlint-report-v1",
            "meta": self.meta,
            "ok": self.ok,
            "checked": len(self.findings),
            "failed": len(self.failures()),
            "rules": rules,
        }

    def to_json(self, path: Optional[str] = None, indent: int = 2) -> str:
        text = json.dumps(self.to_dict(), indent=indent, sort_keys=True)
        if path:
            with open(path, "w") as fh:
                fh.write(text + "\n")
        return text

    def summary(self) -> str:
        lines = []
        for rule, fs in sorted(self.by_rule().items()):
            bad = [f for f in fs if not f.ok]
            mark = "FAIL" if bad else "ok"
            lines.append(f"  {rule:<24} {len(fs):>4} checked  "
                         f"{len(bad):>3} failed  [{mark}]")
            for f in bad[:20]:
                lines.append(f"    ! {f.subject}: {f.detail}")
            if len(bad) > 20:
                lines.append(f"    ... and {len(bad) - 20} more")
        head = ("PackLint: PASS" if self.ok
                else f"PackLint: FAIL ({len(self.failures())} violations)")
        return "\n".join([head] + lines)
