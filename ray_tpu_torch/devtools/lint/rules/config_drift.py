"""config-knob-drift: Config/DataContext knobs that drift from reality.

Two failure directions, both seen in practice:

- **unknown knob**: code reads ``cfg.some_knob`` that the Config
  dataclass never defines — silently AttributeErrors at runtime (or
  worse, a typo reads a different knob than the one being tuned).
- **dead knob**: a knob is defined (and documented, and env-var
  plumbed) but nothing ever reads it — operators tune it and nothing
  happens.

``cfg`` is a heavily overloaded name in this codebase (RL configs,
model configs...), so receiver matching is evidence-based, not
name-based: an expression is Config-typed only if it traces to a
``Config(...)``/``Config.load(...)``/``Config.from_json(...)`` call, a
parameter annotated ``: Config``, ``GLOBAL_CONFIG``, or ``.cfg`` on a
known Runtime producer (``get_runtime()``/``current_runtime_or_none()``).
DataContext likewise via ``DataContext.get_current()``/``get_context()``.

Project-scoped: knob definitions are collected from every scanned file
that defines a class named ``Config`` or ``DataContext`` with annotated
fields; the dead-knob direction counts reads across the whole scanned
set (attribute reads, ``"knob"`` string keys, ``RAY_TPU_KNOB`` env
names). Dead-knob checking therefore only makes sense when the scan
includes the knobs' consumers — lint the package root, not config.py
alone.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from ray_tpu_torch.devtools.lint.astutil import (FuncNode, dotted_name,
                                                 walk_scope)
from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register

_CONFIG_CLASSES = ("Config", "DataContext")
_RUNTIME_PRODUCERS = {"get_runtime", "current_runtime_or_none"}
_CONFIG_PRODUCERS = {"Config", "Config.load", "Config.from_json"}


def _class_fields(tree: ast.AST, path: str) -> Dict[str, dict]:
    """{class_name: {"fields": {name: line}, "methods": set, "path": ..}}"""
    out: Dict[str, dict] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef) \
                or node.name not in _CONFIG_CLASSES:
            continue
        fields: Dict[str, int] = {}
        methods: Set[str] = set()
        for st in node.body:
            if isinstance(st, ast.AnnAssign) \
                    and isinstance(st.target, ast.Name) \
                    and not st.target.id.startswith("_"):
                fields[st.target.id] = st.lineno
            elif isinstance(st, FuncNode):
                methods.add(st.name)
            elif isinstance(st, ast.Assign):
                for t in st.targets:
                    if isinstance(t, ast.Name):
                        methods.add(t.id)  # class attrs are not knobs
        if fields:
            out[node.name] = {"fields": fields, "methods": methods,
                              "path": path, "line": node.lineno}
    return out


def _ann_is(ann, cls: str) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Name):
        return ann.id == cls
    if isinstance(ann, ast.Attribute):
        return ann.attr == cls
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip("'\"") == cls
    return False


def _ctx_producer_names(tree: ast.AST) -> Set[str]:
    """Bare names that really produce a DataContext in this file.

    ``get_context`` is a popular function name (train sessions have
    their own), so a bare call only counts when the file imports it
    from the data-execution context module — or shadows nothing and
    defines DataContext itself.
    """
    names: Set[str] = set()
    defines_ctx = any(isinstance(n, ast.ClassDef)
                      and n.name == "DataContext"
                      for n in ast.walk(tree))
    local_defs = {n.name for n in ast.walk(tree) if isinstance(n, FuncNode)}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and ("execution" in node.module
                     or node.module.endswith("context")):
            for alias in node.names:
                if alias.name == "get_context":
                    names.add(alias.asname or alias.name)
    if defines_ctx:
        names.add("get_context")
    else:
        names -= local_defs  # a same-named local def shadows the import
    return names


class _FileTyper(ast.NodeVisitor):
    """Per-file, flow-insensitive binding of names to Config/DataContext.

    Tracks plain names (``cfg = Config.load()``), self attributes
    (``self.cfg = cfg`` where cfg is a typed param), and runtime-typed
    names so ``r.cfg`` resolves.
    """

    def __init__(self, ctx_producers: Set[str] = frozenset()):
        self.ctx_producers = set(ctx_producers)
        self.config_names: Set[str] = set()     # bare names -> Config
        self.ctx_names: Set[str] = set()        # bare names -> DataContext
        self.runtime_names: Set[str] = set()    # bare names -> Runtime
        self.self_config_attrs: Set[str] = set()  # "self.<attr>" -> Config
        self.accesses: List[Tuple[str, ast.Attribute]] = []  # (cls, node)

    # -- typing helpers --------------------------------------------------
    def _expr_type(self, node: ast.AST) -> str:
        """'' | 'Config' | 'DataContext' | 'Runtime' for an expression."""
        if isinstance(node, ast.Name):
            if node.id == "GLOBAL_CONFIG" or node.id in self.config_names:
                return "Config"
            if node.id in self.ctx_names:
                return "DataContext"
            if node.id in self.runtime_names:
                return "Runtime"
            return ""
        if isinstance(node, ast.Attribute):
            if node.attr == "GLOBAL_CONFIG":
                return "Config"
            base = self._expr_type(node.value)
            if base == "Runtime" and node.attr == "cfg":
                return "Config"
            if isinstance(node.value, ast.Name) \
                    and node.value.id == "self" \
                    and f"self.{node.attr}" in self.self_config_attrs:
                return "Config"
            return ""
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            tail2 = ".".join(name.split(".")[-2:])
            tail1 = name.split(".")[-1]
            if name in _CONFIG_PRODUCERS or tail2 in _CONFIG_PRODUCERS:
                return "Config"
            if name == "DataContext.get_current" \
                    or tail2 == "DataContext.get_current" \
                    or name in self.ctx_producers:
                return "DataContext"
            if tail1 in _RUNTIME_PRODUCERS:
                return "Runtime"
            return ""
        if isinstance(node, ast.BoolOp):  # cfg = cfg or Config.load()
            for v in node.values:
                t = self._expr_type(v)
                if t:
                    return t
        return ""

    def _bind(self, target: ast.AST, typ: str):
        if not typ:
            return
        dest = {"Config": self.config_names,
                "DataContext": self.ctx_names,
                "Runtime": self.runtime_names}[typ]
        if isinstance(target, ast.Name):
            dest.add(target.id)
        elif typ == "Config" and isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            self.self_config_attrs.add(f"self.{target.attr}")

    # -- visitors --------------------------------------------------------
    def _visit_fn(self, node):
        for arg in (node.args.args + node.args.kwonlyargs
                    + node.args.posonlyargs):
            if _ann_is(arg.annotation, "Config"):
                self.config_names.add(arg.arg)
            elif _ann_is(arg.annotation, "DataContext"):
                self.ctx_names.add(arg.arg)
        self.generic_visit(node)

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Assign(self, node):
        typ = self._expr_type(node.value)
        for t in node.targets:
            self._bind(t, typ)
        self.generic_visit(node)

    def visit_AnnAssign(self, node):
        if _ann_is(node.annotation, "Config"):
            self._bind(node.target, "Config")
        elif _ann_is(node.annotation, "DataContext"):
            self._bind(node.target, "DataContext")
        elif node.value is not None:
            self._bind(node.target, self._expr_type(node.value))
        self.generic_visit(node)

    def visit_Attribute(self, node):
        base = self._expr_type(node.value)
        if base in ("Config", "DataContext"):
            self.accesses.append((base, node))
        self.generic_visit(node)


def _scope_filter(tree: ast.AST, typer: _FileTyper):
    """Drop accesses whose receiver root is an unannotated parameter of
    the enclosing function: the file-global name table is flow-
    insensitive, so ``def f(cfg: Config)`` must not type a *different*
    function's ``cfg`` parameter (RL configs reuse the name heavily).
    A param locally rebound from a typed producer stays typed."""
    owner = {}
    for fn in ast.walk(tree):
        if isinstance(fn, FuncNode):
            for sub in walk_scope(fn):
                owner[id(sub)] = fn

    def keep(access: Tuple[str, ast.Attribute]) -> bool:
        _, node = access
        root = node.value
        while isinstance(root, ast.Attribute):
            root = root.value
        if not isinstance(root, ast.Name) or root.id in ("self", "cls"):
            return True
        fn = owner.get(id(node))
        if fn is None:
            return True
        params = {a.arg: a for a in (fn.args.args + fn.args.kwonlyargs
                                     + fn.args.posonlyargs)}
        arg = params.get(root.id)
        if arg is None:
            return True
        if _ann_is(arg.annotation, "Config") \
                or _ann_is(arg.annotation, "DataContext"):
            return True
        for sub in walk_scope(fn):
            if isinstance(sub, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == root.id
                            for t in sub.targets) \
                    and typer._expr_type(sub.value):
                return True
        return False

    typer.accesses = [a for a in typer.accesses if keep(a)]


_TOKEN_ATTR = re.compile(r"\.(\w+)")
_TOKEN_STR = re.compile(r"['\"](\w+)['\"]")
_TOKEN_ENV = re.compile(r"RAY_TPU_(\w+)")


def extract_config(tree: ast.AST, source: str, path: str) -> dict:
    """The per-file half of the knob-drift analysis, JSON-able so the
    engine can cache it (summaries.py calls this into FileSummary.config).
    The cross-file aggregation lives in check_graph below."""
    typer = _FileTyper(_ctx_producer_names(tree))
    # two passes so use-before-def bindings (methods defined above
    # __init__) still resolve
    typer.visit(tree)
    typer.accesses.clear()
    typer.visit(tree)
    _scope_filter(tree, typer)

    classes = {
        cls: {"fields": info["fields"],
              "methods": sorted(info["methods"]), "line": info["line"]}
        for cls, info in _class_fields(tree, path).items()}

    # self.<attr> loads inside a config class defined here — the class
    # mediates access for its callers (e.g. DataContext.resolve_policy)
    self_reads: Dict[str, List[str]] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in classes:
            reads = {sub.attr for sub in ast.walk(node)
                     if isinstance(sub, ast.Attribute)
                     and isinstance(sub.ctx, ast.Load)
                     and isinstance(sub.value, ast.Name)
                     and sub.value.id == "self"}
            if reads:
                self_reads[node.name] = sorted(reads)

    # knob-shaped tokens for the untyped-receiver/string-key/env-var
    # fallback: `.knob`, "knob", RAY_TPU_KNOB (env tails keep their
    # `_`-split prefixes so RAY_TPU_FOO_BAR still reads knob `foo`)
    tokens = set(_TOKEN_ATTR.findall(source))
    tokens.update(_TOKEN_STR.findall(source))
    for env in _TOKEN_ENV.findall(source):
        parts = env.lower().split("_")
        for i in range(1, len(parts) + 1):
            tokens.add("_".join(parts[:i]))

    return {
        "classes": classes,
        "accesses": [[cls, node.attr, node.lineno, node.col_offset]
                     for cls, node in typer.accesses],
        "self_reads": self_reads,
        "tokens": sorted(tokens),
    }


@register
class ConfigKnobDrift(Rule):
    id = "config-knob-drift"
    doc = ("Config/DataContext attribute referenced but never defined, "
           "or defined but never read anywhere in the scanned tree")
    hint = ("define the knob on the config class, or delete/wire the "
            "dead knob")
    scope = "graph"

    def check_graph(self, graph):
        classes: Dict[str, dict] = {}
        for fs in graph.files:
            for cls, info in fs.config.get("classes", {}).items():
                if cls in classes:
                    # two definitions (e.g. fixtures): merge fields so
                    # neither side false-positives the other's knobs
                    classes[cls]["fields"].update(info["fields"])
                    classes[cls]["methods"] |= set(info["methods"])
                else:
                    classes[cls] = {"fields": dict(info["fields"]),
                                    "methods": set(info["methods"]),
                                    "path": fs.path, "line": info["line"]}
        if not classes:
            return

        read_fields: Dict[str, Set[str]] = {c: set() for c in classes}
        findings: List[Finding] = []

        for fs in graph.files:
            cfg = fs.config
            for cls, reads in cfg.get("self_reads", {}).items():
                if cls in classes and fs.path == classes[cls]["path"]:
                    read_fields[cls] |= \
                        set(reads) & set(classes[cls]["fields"])
            for cls, attr, line, col in cfg.get("accesses", []):
                if cls not in classes:
                    continue
                info = classes[cls]
                if attr in info["fields"]:
                    read_fields[cls].add(attr)
                elif attr not in info["methods"] \
                        and not attr.startswith("_"):
                    findings.append(Finding(
                        rule=self.id, path=fs.path, line=line, col=col,
                        message=f"{cls}.{attr} is read here but {cls} "
                                "defines no such knob",
                        hint="add the field to the config class (typo?)"))
            tokens = set(cfg.get("tokens", []))
            for cls, info in classes.items():
                if fs.path == info["path"]:
                    continue  # the defining file doesn't count
                for f in info["fields"]:
                    if f not in read_fields[cls] and f in tokens:
                        read_fields[cls].add(f)

        for cls, info in classes.items():
            for f, line in sorted(info["fields"].items()):
                if f not in read_fields[cls]:
                    findings.append(Finding(
                        rule=self.id, path=info["path"], line=line, col=4,
                        message=f"{cls}.{f} is defined but nothing in the "
                                "scanned tree reads it — tuning it is a "
                                "silent no-op",
                        hint="wire the knob into the code path it "
                             "documents, or delete it"))
        yield from findings
