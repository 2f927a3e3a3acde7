"""Finding: one diagnostic emitted by a raylint rule."""

from __future__ import annotations

from dataclasses import dataclass, field

SCHEMA_VERSION = 3
SEVERITIES = ("error", "warn")


@dataclass
class Finding:
    rule: str           # rule id, e.g. "leaked-object-ref"
    path: str           # file the finding is in (as given on the cmdline)
    line: int           # 1-based
    col: int            # 0-based, ast convention
    message: str        # what is wrong at this site
    hint: str = ""      # how to fix it (one line)
    severity: str = "error"   # "error" | "warn"
    suppressed: bool = field(default=False)
    # SPMD facts backing the finding (schema v3): e.g. the declared-axes
    # set for mesh-axis-consistency, the per-arm schedule diff for
    # collective-schedule-divergence. {} for rules with nothing to add.
    spmd: dict = field(default_factory=dict)

    def render(self) -> str:
        tail = f"  [hint: {self.hint}]" if self.hint else ""
        sup = "  (suppressed)" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity}: {self.rule}: "
                f"{self.message}{tail}{sup}")

    def to_dict(self) -> dict:
        # Stable --json schema v3; tests/test_torch_lint.py pins these keys.
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
            "severity": self.severity,
            "suppressed": self.suppressed,
            "spmd": self.spmd,
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "Finding":
        """Accepts v1 dicts (no severity field — everything was an
        error), v2 (no spmd facts), and v3; tooling reading old CI
        artifacts keeps working."""
        return cls(
            rule=doc["rule"], path=doc["path"], line=doc["line"],
            col=doc["col"], message=doc["message"],
            hint=doc.get("hint", ""),
            severity=doc.get("severity", "error"),
            suppressed=doc.get("suppressed", False),
            spmd=doc.get("spmd", {}))
