"""useless-suppression: a disable directive that suppresses nothing.

Suppressions are debt: each one is a spot where the linter was
overruled, justified by a comment that rots as the code under it
changes. When the rule stops firing there — the hazard was fixed, the
code moved, the directive's line drifted — the stale directive keeps
silently masking any *future* violation on that line. This meta-rule
audits the inventory after every other rule has run: a ``disable=``
whose named rule produces no raw finding on a covered line (or
``disable-file=`` whose rule never fires anywhere in the file) is
itself flagged.

Only directives naming rules active in this run are judged — running a
single rule in isolation must not condemn directives for the rules
that didn't run. ``disable=all`` is judged against *any* finding at
the covered lines.

This rule is ``file_wide_only``: a line-level
``# raylint: disable=useless-suppression`` cannot hide its own audit
(and is itself useless-by-construction, so it gets flagged). Fixture
and generated files can opt out with
``# raylint: disable-file=useless-suppression``.
"""

from __future__ import annotations

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register


@register
class UselessSuppression(Rule):
    id = "useless-suppression"
    doc = ("a `# raylint: disable=` directive whose rule no longer "
           "fires on the covered lines — stale debt masking future "
           "violations")
    hint = ("delete the directive; if the rule was recently split or "
            "renamed, update the rule id instead")
    scope = "report"
    severity = "warn"
    file_wide_only = True

    def check_report(self, parsed_files, findings, active_ids):
        # raw (pre-suppression) findings indexed per file
        by_path = {}
        for f in findings:
            if f.rule == self.id:
                continue
            by_path.setdefault(f.path, []).append(f)
        for pf in parsed_files:
            hits = by_path.get(pf.path, [])
            lines_hit = {}
            for f in hits:
                lines_hit.setdefault(f.line, set()).add(f.rule)
            for d in pf.suppressions.directives:
                judged = {r for r in d["rules"]
                          if r in active_ids or r == "all"}
                if d["file_level"]:
                    # disable-file=useless-suppression is the designated
                    # opt-out — it is not judged against itself
                    judged.discard(self.id)
                if not judged:
                    continue  # names only rules not active in this run
                for rule in sorted(judged):
                    if d["file_level"]:
                        used = any(
                            (rule == "all" and hits)
                            or f.rule == rule for f in hits)
                    else:
                        used = any(
                            rule in lines_hit.get(ln, ())
                            or (rule == "all" and ln in lines_hit)
                            for ln in d["covered"])
                    if used:
                        continue
                    kind = ("disable-file" if d["file_level"]
                            else "disable")
                    yield Finding(
                        rule=self.id, path=pf.path, line=d["line"],
                        col=0,
                        message=(f"`# raylint: {kind}={rule}` "
                                 "suppresses nothing — the rule does "
                                 "not fire "
                                 + ("anywhere in this file"
                                    if d["file_level"] else
                                    "on the covered line(s)")),
                        hint=self.hint)
