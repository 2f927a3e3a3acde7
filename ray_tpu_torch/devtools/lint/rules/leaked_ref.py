"""leaked-object-ref: ``.remote()`` result discarded.

A discarded ObjectRef means task failures are silently swallowed (the
error lives in the ref nobody will get()) and, under reference-counted
stores, the result object may be collected before anyone can read it.
Fire-and-forget call sites that are genuinely intentional must say so
with a suppression + one-line justification.
"""

from __future__ import annotations

import ast

from ray_tpu_torch.devtools.lint.astutil import dotted_name
from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register


@register
class LeakedObjectRef(Rule):
    id = "leaked-object-ref"
    doc = (".remote() called as a bare statement — the returned "
           "ObjectRef (and any error inside it) is dropped")
    hint = ("assign the ref and get()/wait() it (batch refs if needed); "
            "if fire-and-forget is intended, suppress with a justification")

    def check(self, parsed):
        for node in ast.walk(parsed.tree):
            if not isinstance(node, ast.Expr):
                continue
            value = node.value
            if isinstance(value, ast.Await):
                value = value.value
            if not isinstance(value, ast.Call):
                continue
            name = dotted_name(value.func)
            if name == "remote" or name.endswith(".remote"):
                yield Finding(
                    rule=self.id, path=parsed.path,
                    line=value.lineno, col=value.col_offset,
                    message=f"result of {name}(...) is discarded; task "
                            "errors will never surface",
                    hint=self.hint)
