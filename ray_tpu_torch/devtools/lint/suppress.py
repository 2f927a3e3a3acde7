"""Inline suppression parsing.

Syntax (mirrors pylint's, namespaced so the two coexist):

    x.remote(payload)  # raylint: disable=leaked-object-ref  -- fire&forget

suppresses the named rule(s) on that line. A comment-only line
suppresses the line *below* it (for statements too long to share a line
with their justification):

    # raylint: disable=divergent-collective -- root-only barrier by design
    collective.barrier()

`disable=all` suppresses every rule on the line. A file-level opt-out

    # raylint: disable-file=large-closure-capture

anywhere in the file suppresses that rule for the whole file (reserved
for generated or fixture code; real code should suppress per-line with a
justification).

Every directive is kept in ``directives`` with the lines it covers, so
the useless-suppression meta-rule can audit the inventory: a directive
whose rule never fires at a covered line is itself a finding.

Directives are recognized in real comments only (tokenize-level), never
inside string literals — this file's own docstring examples must not
suppress anything, and before the tokenizer pass they did: the
``disable-file=large-closure-capture`` example above silently opted
this whole file out of that rule.
"""

from __future__ import annotations

import io
import re
import tokenize
from typing import Dict, List, Set

_RULE_LIST = r"([\w-]+(?:\s*,\s*[\w-]+)*)"
_LINE_RE = re.compile(r"#\s*raylint:\s*disable=" + _RULE_LIST)
_FILE_RE = re.compile(r"#\s*raylint:\s*disable-file=" + _RULE_LIST)


def _rules_of(match: re.Match) -> Set[str]:
    return {r.strip() for r in match.group(1).split(",") if r.strip()}


def _comments(source: str):
    """(line, text, own_line) for each real comment token. Falls back to
    nothing on tokenize errors — the file already failed to parse and is
    reported as a parse error, so losing its directives is moot."""
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                own_line = tok.line[:tok.start[1]].strip() == ""
                yield tok.start[0], tok.string, own_line
    except (tokenize.TokenizeError, SyntaxError, ValueError, IndentationError):
        return


class Suppressions:
    """Per-file suppression table, queried by (rule, line)."""

    def __init__(self, source: str):
        self.by_line: Dict[int, Set[str]] = {}
        self.file_level: Set[str] = set()
        # [{"line", "rules", "file_level", "covered"}] for auditing
        self.directives: List[dict] = []
        for i, text, own_line in _comments(source):
            m = _FILE_RE.search(text)
            if m:
                rules = _rules_of(m)
                self.file_level |= rules
                self.directives.append({"line": i, "rules": rules,
                                        "file_level": True, "covered": []})
                continue
            m = _LINE_RE.search(text)
            if not m:
                continue
            rules = _rules_of(m)
            covered = [i]
            self.by_line.setdefault(i, set()).update(rules)
            if own_line:
                # comment-only directive also covers the next line
                self.by_line.setdefault(i + 1, set()).update(rules)
                covered.append(i + 1)
            self.directives.append({"line": i, "rules": rules,
                                    "file_level": False,
                                    "covered": covered})

    def is_suppressed(self, rule: str, line: int,
                      file_only: bool = False) -> bool:
        """``file_only`` restricts to disable-file= directives (rules
        with ``file_wide_only = True``, e.g. useless-suppression —
        otherwise a line-level disable could hide its own audit)."""
        if rule in self.file_level or "all" in self.file_level:
            return True
        if file_only:
            return False
        rules = self.by_line.get(line, ())
        return rule in rules or "all" in rules
