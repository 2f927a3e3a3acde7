"""Rule base class + registry.

A rule is a class with a unique ``id``, a one-line ``doc`` (shown by
``--list-rules``), a ``severity`` (``"error"`` or ``"warn"``, stamped
onto every Finding the rule emits), and a scope:

- ``scope = "file"``: ``check(parsed)`` is called once per parsed file
  and yields Findings for that file only.
- ``scope = "graph"``: ``check_graph(graph)`` is called once with the
  :class:`~ray_tpu_torch.devtools.lint.callgraph.ProjectGraph` built from
  every file's summary — the home of interprocedural rules (call-graph
  reachability, lock-order, actor cycles). Graph rules never see ASTs,
  which is what lets the engine serve them from the result cache.
- ``scope = "project"``: ``check_project(parsed_files)`` is called once
  with every parsed file, for cross-file rules that genuinely need raw
  ASTs (none in-tree today; parsing is lazy, so using this scope
  forfeits the cache's parse-skipping).
- ``scope = "report"``: ``check_report(parsed_files, findings,
  active_ids)`` runs after every other rule with the raw (pre-
  suppression) findings — meta-rules like useless-suppression.

``file_wide_only = True`` makes the rule honor only ``disable-file=``
suppressions (line-level disables are ignored).

Register with the ``@register`` decorator; ``rules/__init__.py`` imports
every rule module so importing the package populates the registry.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Type

from ray_tpu_torch.devtools.lint.findings import Finding

_REGISTRY: Dict[str, Type["Rule"]] = {}


class Rule:
    id: str = ""
    doc: str = ""
    hint: str = ""
    scope: str = "file"  # "file" | "graph" | "project" | "report"
    severity: str = "error"  # "error" | "warn"
    file_wide_only: bool = False

    def check(self, parsed) -> Iterable[Finding]:  # file-scope rules
        return ()

    def check_graph(self, graph) -> Iterable[Finding]:  # graph scope
        return ()

    def check_project(self, parsed_files) -> Iterable[Finding]:  # project
        return ()

    def check_report(self, parsed_files, findings,
                     active_ids) -> Iterable[Finding]:  # report scope
        return ()


def register(cls: Type[Rule]) -> Type[Rule]:
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} has no id")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id!r}")
    _REGISTRY[cls.id] = cls
    return cls


def all_rules() -> List[Rule]:
    # import for side effect: rule modules self-register
    from ray_tpu_torch.devtools.lint import rules  # noqa: F401

    return [cls() for _, cls in sorted(_REGISTRY.items())]


def rule_ids() -> List[str]:
    from ray_tpu_torch.devtools.lint import rules  # noqa: F401

    return sorted(_REGISTRY)
