"""Typed findings shared by the three analysis passes (a copy of the
reference's ``repro/analysis/report.py``, which needs no framework).

A :class:`Finding` is one violated obligation — a protocol contract the
model checker refuted, a result key the trace checks did not budget, a
value range the integer analyzer could not prove safe.  Passes return
``(findings, stats)``; the CLI (``python -m repro_torch.analysis``) renders
them and exits non-zero on any finding, which is what makes the CI step
a gate.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated obligation, uniquely identified by (pass, rule,
    subject): ``where`` pins the config/state that witnessed it and
    ``detail`` is the human-readable evidence."""
    pass_name: str            # "model" | "trace" | "range"
    rule: str                 # e.g. "lost-wakeup", "carry-count"
    subject: str              # protocol name / params description
    detail: str
    where: str = ""           # config / witness description

    def render(self) -> str:
        loc = f" [{self.where}]" if self.where else ""
        return (f"{self.pass_name}:{self.rule} {self.subject}{loc}: "
                f"{self.detail}")


@dataclasses.dataclass
class PassReport:
    """One pass over one subject (protocol or params grid)."""
    pass_name: str
    subject: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> Dict[str, Any]:
        return {
            "pass": self.pass_name,
            "subject": self.subject,
            "ok": self.ok,
            "findings": [dataclasses.asdict(f) for f in self.findings],
            "stats": self.stats,
            "wall_s": round(self.wall_s, 3),
        }


def summarize(reports: List[PassReport]) -> str:
    """Fixed-width console summary: one row per (pass, subject)."""
    lines = []
    width = max([len(r.subject) for r in reports] + [8])
    for r in reports:
        verdict = "ok" if r.ok else f"{len(r.findings)} finding(s)"
        extra = ""
        if "states" in r.stats:
            extra = (f"  states={r.stats['states']:>6}"
                     f" transitions={r.stats.get('transitions', 0):>7}")
        lines.append(f"  {r.pass_name:<6} {r.subject:<{width}} "
                     f"{verdict:<14} {r.wall_s:7.2f}s{extra}")
    return "\n".join(lines)


def all_findings(reports: List[PassReport]) -> List[Finding]:
    return [f for r in reports for f in r.findings]


def fail_fast(reports: List[PassReport],
              limit: Optional[int] = None) -> str:
    """Render findings (up to ``limit``) for console output."""
    fs = all_findings(reports)
    shown = fs if limit is None else fs[:limit]
    body = "\n".join("  - " + f.render() for f in shown)
    if limit is not None and len(fs) > limit:
        body += f"\n  ... and {len(fs) - limit} more"
    return body
