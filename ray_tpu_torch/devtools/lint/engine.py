"""raylint engine: file discovery, parsing, rule dispatch, result cache.

Degrades gracefully: a file that fails to parse yields a single
``syntax-error`` finding (it still fails the gate — broken source in
the tree is a finding, not a crash) and generated/bytecode trees
(``__pycache__``, ``*_pb2*.py``, ``protobuf/`` output) are skipped.

Phases per run:

1. per-file: parse + ``scope="file"`` rules + summary extraction
   (summaries.py). This whole phase is served from the result cache
   on a hit — keyed by (content sha256, ruleset fingerprint) — so a
   warm run over an unchanged tree does no parsing and no rule work.
2. graph: the :class:`ProjectGraph` is built once from the summaries
   and every ``scope="graph"`` rule runs against it (interprocedural
   deadlock/lock-order/channel-protocol analyses live here).
3. report: ``scope="report"`` meta-rules see the raw findings (the
   useless-suppression audit).

The ruleset fingerprint hashes the analyzer's own source (engine,
summaries, call graph, every active rule), so editing any rule — not
just bumping RULESET_VERSION — invalidates the cache honestly.
"""

from __future__ import annotations

import ast
import hashlib
import inspect
import json
import os
import subprocess
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

from ray_tpu_torch.devtools.lint.findings import SCHEMA_VERSION, Finding
from ray_tpu_torch.devtools.lint.registry import Rule, all_rules
from ray_tpu_torch.devtools.lint.suppress import Suppressions

SKIP_DIRS = {"__pycache__", ".git", "build", "node_modules", ".eggs",
             ".raylint_cache"}
# generated trees: protobuf output and anything stamped *_pb2
_GENERATED_MARKERS = ("_pb2.py", "_pb2_grpc.py")

# Bump to force a cache flush even when no analyzer source changed
# (e.g. a semantic change smuggled in via data files).
# 2: SPMD plane — summaries carry mesh-axis/jit-boundary/schedule facts.
# 3: the port's SPMD plane — DeviceMesh axes, spmd/torch.distributed
#    collectives, sharded-call specs, CUDA-graph capture blocks.
RULESET_VERSION = 3

DEFAULT_CACHE_DIR = ".raylint_cache"


class ParsedFile:
    """A scanned file. ``tree`` parses lazily: cache hits never touch
    the parser unless a ``scope="project"`` rule asks for the AST."""

    def __init__(self, path: str, source: str,
                 tree: Optional[ast.Module] = None,
                 suppressions: Optional[Suppressions] = None):
        self.path = path
        self.source = source
        self._tree = tree
        self.suppressions = suppressions if suppressions is not None \
            else Suppressions(source)

    @property
    def tree(self) -> ast.Module:
        if self._tree is None:
            self._tree = ast.parse(self.source, filename=self.path)
        return self._tree


@dataclass
class LintReport:
    findings: List[Finding] = field(default_factory=list)
    files_scanned: int = 0
    files_skipped: int = 0
    files_from_cache: int = 0
    parse_errors: int = 0

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    def failing(self, fail_on: str = "warn") -> List[Finding]:
        """Unsuppressed findings at or above the threshold: 'warn'
        fails on everything, 'error' only on errors."""
        if fail_on == "warn":
            return self.unsuppressed
        return [f for f in self.unsuppressed if f.severity == "error"]

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.unsuppressed:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def summary_line(self) -> str:
        # bench.py-style single greppable line for CI diffing
        return (f"RAYLINT files={self.files_scanned} "
                f"findings={len(self.unsuppressed)} "
                f"suppressed={len(self.suppressed)} "
                f"parse_errors={self.parse_errors} "
                f"cached={self.files_from_cache}")

    def to_dict(self) -> dict:
        return {
            "version": SCHEMA_VERSION,
            "summary": {
                "files_scanned": self.files_scanned,
                "files_skipped": self.files_skipped,
                "files_from_cache": self.files_from_cache,
                "parse_errors": self.parse_errors,
                "findings": len(self.unsuppressed),
                "suppressed": len(self.suppressed),
                "by_rule": self.by_rule(),
            },
            "findings": [f.to_dict() for f in self.findings],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "LintReport":
        """Read back a --json report; accepts schema v1, v2, and v3."""
        if doc.get("version") not in (1, 2, SCHEMA_VERSION):
            raise ValueError(f"unknown raylint schema {doc.get('version')}")
        summary = doc.get("summary", {})
        rep = cls(
            findings=[Finding.from_dict(f) for f in doc.get("findings",
                                                            [])],
            files_scanned=summary.get("files_scanned", 0),
            files_skipped=summary.get("files_skipped", 0),
            files_from_cache=summary.get("files_from_cache", 0),
            parse_errors=summary.get("parse_errors", 0))
        return rep


def _is_generated(path: str) -> bool:
    norm = path.replace(os.sep, "/")
    if any(norm.endswith(m) for m in _GENERATED_MARKERS):
        return True
    # protobuf output dir: skip generated modules, keep the generator
    parts = norm.split("/")
    if "protobuf" in parts[:-1]:
        return parts[-1] not in ("gen.py", "__init__.py")
    return False


def collect_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
            continue
        for root, dirs, names in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d not in SKIP_DIRS)
            for name in sorted(names):
                if name.endswith(".py"):
                    out.append(os.path.join(root, name))
    return [f for f in dict.fromkeys(out) if not _is_generated(f)]


def changed_files(repo_root: str = ".") -> Optional[List[str]]:
    """Paths changed vs HEAD plus untracked files, or None if git is
    unavailable (caller falls back to a full scan)."""
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"], cwd=repo_root,
            capture_output=True, text=True, timeout=30, check=True)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            cwd=repo_root, capture_output=True, text=True, timeout=30,
            check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    names = diff.stdout.split() + untracked.stdout.split()
    return [os.path.join(repo_root, n) if repo_root != "." else n
            for n in names if n.endswith(".py")]


# ---------------------------------------------------------------- cache

def ruleset_fingerprint(active: Sequence[Rule]) -> str:
    """Hash of everything that determines a file's analysis result:
    the explicit version knob, the active rule set, and the source of
    the analyzer itself (rules + engine layers). Editing any rule
    invalidates every cache entry — no stale-result footguns."""
    import ray_tpu_torch.devtools.lint.astutil as _astutil
    import ray_tpu_torch.devtools.lint.callgraph as _callgraph
    import ray_tpu_torch.devtools.lint.findings as _findings
    import ray_tpu_torch.devtools.lint.summaries as _summaries
    import ray_tpu_torch.devtools.lint.suppress as _suppress

    h = hashlib.sha256()
    h.update(str(RULESET_VERSION).encode())
    mods = (_astutil, _callgraph, _findings, _summaries, _suppress,
            inspect.getmodule(ruleset_fingerprint))
    for mod in mods:
        try:
            h.update(inspect.getsource(mod).encode())
        except (OSError, TypeError):
            h.update(mod.__name__.encode())
    for rule in sorted(active, key=lambda r: r.id):
        h.update(rule.id.encode())
        try:
            h.update(inspect.getsource(type(rule)).encode())
        except (OSError, TypeError):
            pass
    return h.hexdigest()


def _cache_path(cache_dir: str, path: str) -> str:
    key = hashlib.sha256(os.path.abspath(path).encode()).hexdigest()[:32]
    return os.path.join(cache_dir, f"{key}.json")


def _cache_load(cache_dir: str, path: str, content_sha: str,
                fingerprint: str) -> Optional[dict]:
    try:
        with open(_cache_path(cache_dir, path), encoding="utf-8") as fh:
            entry = json.load(fh)
    except (OSError, ValueError):
        return None
    if entry.get("content_sha") != content_sha \
            or entry.get("fingerprint") != fingerprint:
        return None
    return entry


def _cache_store(cache_dir: str, path: str, entry: dict) -> None:
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = _cache_path(cache_dir, path) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(entry, fh, separators=(",", ":"))
        os.replace(tmp, _cache_path(cache_dir, path))
    except OSError:
        pass  # cache is best-effort; the analysis result is already made


# ------------------------------------------------------------- analysis

def _analyze_file(pf: ParsedFile, file_rules: Sequence[Rule],
                  need_summary: bool):
    """Everything derivable from one file alone: file-scope findings +
    the interprocedural summary. Module-level so tests can spy on it
    (a cache hit must not reach this function)."""
    from ray_tpu_torch.devtools.lint.summaries import summarize

    findings: List[Finding] = []
    for rule in file_rules:
        for f in rule.check(pf):
            f.severity = rule.severity
            findings.append(f)
    summary = summarize(pf.tree, pf.source, pf.path) if need_summary \
        else None
    return findings, summary


def run_lint(paths: Sequence[str],
             rules: Optional[Iterable[Rule]] = None,
             changed_only: bool = False,
             cache_dir: Optional[str] = None,
             graph_depth: Optional[int] = None) -> LintReport:
    from ray_tpu_torch.devtools.lint.callgraph import (DEFAULT_DEPTH,
                                                       ProjectGraph)
    from ray_tpu_torch.devtools.lint.summaries import FileSummary

    report = LintReport()
    files = collect_files(paths)
    if changed_only:
        changed = changed_files()
        if changed is not None:
            allowed = {os.path.abspath(c) for c in changed}
            files = [f for f in files if os.path.abspath(f) in allowed]

    active = list(rules) if rules is not None else all_rules()
    file_rules = [r for r in active if r.scope == "file"]
    graph_rules = [r for r in active if r.scope == "graph"]
    project_rules = [r for r in active if r.scope == "project"]
    report_rules = [r for r in active if r.scope == "report"]
    need_summary = bool(graph_rules)
    fingerprint = ruleset_fingerprint(active) if cache_dir else ""

    parsed_files: List[ParsedFile] = []
    summaries: List[FileSummary] = []
    raw: List[Finding] = []

    for path in files:
        try:
            with open(path, encoding="utf-8", errors="replace") as fh:
                source = fh.read()
        except OSError as e:
            report.files_skipped += 1
            report.findings.append(Finding(
                rule="syntax-error", path=path, line=1, col=0,
                message=f"file unreadable: {e}"))
            continue

        entry = None
        content_sha = ""
        if cache_dir:
            content_sha = hashlib.sha256(source.encode()).hexdigest()
            entry = _cache_load(cache_dir, path, content_sha, fingerprint)

        if entry is not None:
            pf = ParsedFile(path, source)
            findings = [Finding.from_dict(d) for d in entry["findings"]]
            for f in findings:
                f.path = path
                f.suppressed = False
            if need_summary:
                if entry.get("summary") is None:
                    entry = None    # cached without summaries: recompute
                else:
                    summary = FileSummary.from_json(entry["summary"])
                    summary.path = path
            if entry is not None:
                report.files_from_cache += 1
                parsed_files.append(pf)
                raw.extend(findings)
                if need_summary:
                    summaries.append(summary)
                continue

        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            report.parse_errors += 1
            report.findings.append(Finding(
                rule="syntax-error", path=path,
                line=e.lineno or 1, col=e.offset or 0,
                message=f"file does not parse: {e.msg}",
                hint="raylint skipped this file's rules; fix the syntax"))
            continue
        pf = ParsedFile(path, source, tree=tree)
        findings, summary = _analyze_file(pf, file_rules, need_summary)
        parsed_files.append(pf)
        raw.extend(findings)
        if need_summary and summary is not None:
            summaries.append(summary)
        if cache_dir:
            _cache_store(cache_dir, path, {
                "content_sha": content_sha, "fingerprint": fingerprint,
                "findings": [f.to_dict() for f in findings],
                "summary": summary.to_json() if summary is not None
                else None})

    report.files_scanned = len(parsed_files)

    if graph_rules:
        graph = ProjectGraph(
            summaries,
            depth=graph_depth if graph_depth is not None else DEFAULT_DEPTH)
        for rule in graph_rules:
            for f in rule.check_graph(graph):
                f.severity = rule.severity
                raw.append(f)
    for rule in project_rules:
        for f in rule.check_project(parsed_files):
            f.severity = rule.severity
            raw.append(f)

    active_ids = {r.id for r in active}
    for rule in report_rules:
        for f in rule.check_report(parsed_files, list(raw), active_ids):
            f.severity = rule.severity
            raw.append(f)

    file_wide_only = {r.id for r in active if r.file_wide_only}
    supp_by_path = {pf.path: pf.suppressions for pf in parsed_files}
    for f in raw:
        supp = supp_by_path.get(f.path)
        if supp is not None and supp.is_suppressed(
                f.rule, f.line, file_only=f.rule in file_wide_only):
            f.suppressed = True
    report.findings.extend(raw)
    report.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return report
