"""Per-file analysis summaries for interprocedural raylint rules.

One :class:`FileSummary` per parsed file captures everything the
whole-program phase needs — per-function call sites, blocking
operations, lock acquisitions, collective invocations, compiled-channel
ops, rank-conditional branches, and per-class attribute types — as
plain JSON-able data. The project call graph (callgraph.py) is built
purely from summaries, never from ASTs, which is what makes the
result cache work: a cache hit loads the summary and skips both the
parse and the per-file extraction, and graph rules still see the file.

Extraction is deliberately conservative: a receiver or callee the
flow-insensitive pass cannot resolve is recorded raw and dropped at
resolution time, trading recall for a near-zero false-positive rate
(the tier-1 gate keeps the tree clean, so every false positive is a
build break).
"""

from __future__ import annotations

import ast
import os
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.devtools.lint.astutil import (FuncNode, decorator_names,
                                                 dotted_name, walk_scope)

# Blocking object-store reads (same exact-chain table blocking_async
# uses, plus the bare names `from ray_tpu_torch import get/wait` would
# bind).
BLOCKING_GET = {
    "ray_tpu_torch.get", "runtime.get", "rt.get", "_runtime.get",
    "_rt.get",
}
BLOCKING_WAIT = {
    "ray_tpu_torch.wait", "runtime.wait", "rt.wait", "_runtime.wait",
    "_rt.wait",
}

COLLECTIVE_OPS = {
    "allreduce", "allgather", "broadcast", "reducescatter", "barrier",
    "allreduce_async", "allgather_async", "broadcast_async",
    "reducescatter_async", "barrier_async",
}
_COLLECTIVE_RECEIVERS = ("collective", "col", "group", "comm")
_RANK_WORDS = ("rank", "is_leader", "is_root", "is_coordinator")

_LOCK_CTORS = {
    "threading.Lock": "lock", "Lock": "lock",
    "threading.RLock": "rlock", "RLock": "rlock",
    "threading.Condition": "cond", "Condition": "cond",
}
_THREAD_CTORS = {"threading.Thread", "Thread", "multiprocessing.Process",
                 "Process"}
# --- SPMD plane tables ------------------------------------------------------
# Device collectives of the port's SPMD bodies (parallel/spmd.py), the
# rank-by-rank counterparts of jax.lax's psum family: every rank of the
# axis must issue them in the same order, exactly like the host ops above.
# Each maps to the positional slot of its ``Axis`` argument (``axis=``
# wins), whose literal name the schedule records where one is visible.
SPMD_COLLECTIVES = {"ppermute": 2, "all_to_all": 3, "all_reduce": 1,
                    "broadcast": 2, "sendrecv": 2, "shift": 4}
# torch.distributed collectives: rendezvous points of a process group.
DIST_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                    "reduce_scatter", "reduce_scatter_tensor", "broadcast",
                    "barrier", "all_to_all", "all_to_all_single",
                    "batch_isend_irecv"}
# Mesh-axis queries on a DeviceMesh receiver: not rendezvous ops, but
# their axis argument must name a declared mesh axis all the same.
MESH_AXIS_METHODS = {"get_group", "get_local_rank"}
# Wall-clock reads: in a CUDA-graph capture or a torch.compile body
# these execute once, at capture or trace time, and bake a constant into
# what is replayed.
WALL_CLOCK = {"time.time", "time.perf_counter", "time.monotonic",
              "time.time_ns", "datetime.now", "datetime.datetime.now",
              "datetime.utcnow"}
_METRIC_RECV_WORDS = ("metric", "counter", "gauge", "hist")
# Host-collective calls that carry a group name, and which argument
# position it rides in (kwarg `group_name=` always wins).
HOST_GROUP_ARG = {
    "allreduce": 1, "allgather": 1, "reducescatter": 1, "broadcast": 2,
    "barrier": 0,
    "allreduce_async": 1, "allgather_async": 1, "reducescatter_async": 1,
    "broadcast_async": 2, "barrier_async": 0,
    "init_collective_group": 2, "destroy_collective_group": 0,
    "init_host_collective": 0, "destroy_host_collective": 0,
}

CHANNEL_OPS = {"execute", "teardown", "close", "put", "enqueue", "write",
               "experimental_compile",
               # KV-handoff lifecycle (serve/kv_transfer.py): exporters
               # and standing decode channels share the protocol —
               # export/adopt are channel traffic, close/teardown ends it
               "adopt", "export"}
SHUTDOWN_METHODS = {"shutdown", "stop", "close", "teardown", "drain",
                    "_stop", "_shutdown", "_close", "_teardown",
                    "__exit__", "__del__", "atexit_handler"}


def collective_op(call: ast.Call) -> str:
    """The collective op name if this call is one, else ''."""
    name = dotted_name(call.func)
    parts = name.split(".")
    if parts[-1] not in COLLECTIVE_OPS:
        return ""
    if len(parts) > 1 and not any(w in p for p in parts[:-1]
                                  for w in _COLLECTIVE_RECEIVERS):
        return ""
    return parts[-1]


def _axis_strs(node: Optional[ast.AST]) -> List[str]:
    """String literals in a Constant or Tuple/List/Set literal. Dynamic
    expressions yield [] — the SPMD pass only reasons about literals."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return [e.value for e in node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def _spec_arity(node: Optional[ast.AST]) -> int:
    """Arity of an in_specs/out_specs literal: len() for a tuple/list
    literal, -1 for anything else (single spec, variable, pytree)."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return len(node.elts)
    return -1


def _kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _arg(call: ast.Call, name: str, pos: int) -> Optional[ast.AST]:
    """The argument given as ``name=`` or, failing that, at ``pos``."""
    node = _kwarg(call, name)
    if node is None and 0 <= pos < len(call.args):
        node = call.args[pos]
    return node


def resolved_name(name: str, imports: Dict[str, str]) -> str:
    """``name`` with its root replaced by what the file imported under
    it: ``dist.all_reduce`` -> ``torch.distributed.all_reduce`` after
    ``import torch.distributed as dist``."""
    root, _, rest = name.partition(".")
    full = imports.get(root, root)
    return f"{full}.{rest}" if rest else full


def is_torch_compile(name: str, imports: Dict[str, str]) -> bool:
    """``torch.compile`` (or a bare ``compile`` imported from torch; the
    builtin ``compile`` is not it)."""
    return resolved_name(name, imports) == "torch.compile"


def _is_cuda_graph(name: str, imports: Dict[str, str]) -> bool:
    return resolved_name(name, imports) in ("torch.cuda.graph",
                                            "torch.cuda.graphs.graph")


def jit_decorator(fn: ast.AST,
                  imports: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """Compile-boundary facts from a function's decorator stack, seeing
    through ``functools.partial(torch.compile, ...)`` wrapping. Two kinds:
    ``sharded_jit`` (the port's late-bound sharded call, with its spec
    arities; its body runs eagerly on every call) and ``compile``
    (``torch.compile``: Dynamo traces the Python body and replays the
    graph). {} if the function carries neither."""
    imports = imports or {}
    for dec in getattr(fn, "decorator_list", []):
        call = dec if isinstance(dec, ast.Call) else None
        name = dotted_name(call.func if call else dec)
        tail = name.split(".")[-1]
        if tail == "partial" and call and call.args:
            name = dotted_name(call.args[0])
            tail = name.split(".")[-1]
        if is_torch_compile(name, imports):
            kind = "compile"
        elif tail == "sharded_jit":
            kind = "sharded_jit"
        else:
            continue
        out = {"kind": kind, "line": dec.lineno, "in_arity": -1,
               "out_arity": -1}
        if kind == "sharded_jit" and call is not None:
            out["in_arity"] = _spec_arity(_kwarg(call, "in_specs"))
            out["out_arity"] = _spec_arity(_kwarg(call, "out_specs"))
        return out
    return {}


def _returns_arity(fn: ast.AST) -> int:
    """Statically-known return arity: N when every return in the body
    is a bare N-tuple literal, else -1 (unknown)."""
    arity: Optional[int] = None
    for node in walk_scope(fn):
        if not isinstance(node, ast.Return):
            continue
        if not isinstance(node.value, ast.Tuple):
            return -1
        k = len(node.value.elts)
        if arity is None:
            arity = k
        elif arity != k:
            return -1
    return -1 if arity is None else arity


def mentions_rank(test: ast.AST) -> bool:
    for node in ast.walk(test):
        word = None
        if isinstance(node, ast.Name):
            word = node.id
        elif isinstance(node, ast.Attribute):
            word = node.attr
        if word and any(w in word.lower() for w in _RANK_WORDS):
            return True
    return False


def module_name_for(path: str) -> str:
    """Best-effort dotted module for a file path: the part from the last
    `ray_tpu_torch` component down, else the bare stem (fixtures, tmp
    files)."""
    norm = os.path.normpath(path).replace(os.sep, "/")
    parts = [p for p in norm.split("/") if p]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts and parts[-1] == "__init__":
        parts.pop()
    for anchor in ("ray_tpu_torch",):
        if anchor in parts:
            return ".".join(parts[parts.index(anchor):])
    return parts[-1] if parts else "?"


def _ctor_tag(value: ast.AST) -> str:
    """'lock'|'rlock'|'cond'|'thread'|'compiled'|'actor:<Cls>'|'' for the
    right-hand side of an assignment."""
    if not isinstance(value, ast.Call):
        return ""
    name = dotted_name(value.func)
    if name in _LOCK_CTORS:
        return _LOCK_CTORS[name]
    if name in _THREAD_CTORS:
        return "thread"
    tail = name.split(".")[-1]
    if tail == "experimental_compile":
        return "compiled"
    if tail == "remote":
        # Cls.remote(...) or Cls.options(...).remote(...)
        parts = name.split(".")
        if len(parts) == 2 and parts[0][:1].isupper():
            return f"actor:{parts[0]}"
        if isinstance(value.func, ast.Attribute) \
                and isinstance(value.func.value, ast.Call):
            inner = dotted_name(value.func.value.func)
            ip = inner.split(".")
            if ip[-1] == "options" and len(ip) == 2 \
                    and ip[0][:1].isupper():
                return f"actor:{ip[0]}"
    return ""


def _remote_targets(node: ast.AST) -> List[Dict[str, str]]:
    """`recv.meth.remote(...)` call sites anywhere under ``node``:
    [{'recv': 'self._replica', 'method': 'queue_len'}, ...]."""
    out = []
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        name = dotted_name(sub.func)
        parts = name.split(".")
        if parts[-1] != "remote" or len(parts) < 3:
            continue
        out.append({"recv": ".".join(parts[:-2]), "method": parts[-2]})
    return out


@dataclass
class FunctionSummary:
    qualname: str                     # "Class.method" | "fn" | "fn.inner"
    line: int
    cls: str = ""                     # enclosing class name, "" if none
    is_actor: bool = False            # enclosing class is @remote-decorated
    is_async: bool = False
    calls: List[List[Any]] = field(default_factory=list)   # [name, ln, col]
    blocking: List[Dict[str, Any]] = field(default_factory=list)
    collectives: List[List[Any]] = field(default_factory=list)
    # [op, axis, ln, col]: spmd.* and torch.distributed collectives
    device_collectives: List[List[Any]] = field(default_factory=list)
    rank_branches: List[Dict[str, Any]] = field(default_factory=list)
    lock_sections: List[Dict[str, Any]] = field(default_factory=list)
    channel_ops: List[Dict[str, Any]] = field(default_factory=list)
    local_types: Dict[str, str] = field(default_factory=dict)
    # SPMD plane extract (all keys optional, omitted when empty):
    #   jit            {kind,line,in_arity,out_arity} — this fn is
    #                  @sharded_jit or @torch.compile decorated
    #   jit_wraps      [[kind, target, line, in_arity, out_arity]] —
    #                  _shard_map(f, ...)/local_map(f, ...)/
    #                  sharded_jit(f, ...)/torch.compile(f)/
    #                  make_graphed_callables(f, ...) call sites in the body
    #   captures       [[line, end_line]] — `with torch.cuda.graph(...)`
    #                  capture blocks in the body
    #   axis_uses      [[axis, line, col, ctx]] — literal axis names
    #   axis_decls     [[axis, line]] — mesh constructions declaring axes
    #   schedule       ordered ["op",op,axis_or_group,ln,col] |
    #                  ["call",name,ln,col] events outside rank branches
    #   rank_scheds    [{line, arms: [events, events]}]
    #   group_literals [[op, name, line, col]] — hardcoded group strings
    #   host_effects   [[kind, name, line, col]] — wall-clock/metric calls
    #   params         [n_pos, n_required, has_varargs, first_param]
    #   returns        statically-known tuple return arity, -1 unknown
    spmd: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ClassSummary:
    name: str
    line: int
    is_actor: bool = False
    bases: List[str] = field(default_factory=list)
    methods: List[str] = field(default_factory=list)
    attr_types: Dict[str, str] = field(default_factory=dict)
    attr_lines: Dict[str, int] = field(default_factory=dict)


@dataclass
class FileSummary:
    path: str
    module: str
    functions: List[FunctionSummary] = field(default_factory=list)
    classes: List[ClassSummary] = field(default_factory=list)
    imports: Dict[str, str] = field(default_factory=dict)
    module_types: Dict[str, str] = field(default_factory=dict)
    config: Dict[str, Any] = field(default_factory=dict)
    # module-level SPMD facts: axis_decls [[axis, line]] from constants
    # like AXIS_ORDER = ("dp", "pp", ...)
    spmd: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "FileSummary":
        fs = cls(path=doc["path"], module=doc["module"],
                 imports=doc.get("imports", {}),
                 module_types=doc.get("module_types", {}),
                 config=doc.get("config", {}),
                 spmd=doc.get("spmd", {}))
        fs.functions = [FunctionSummary(**f) for f in doc.get("functions",
                                                              [])]
        fs.classes = [ClassSummary(**c) for c in doc.get("classes", [])]
        return fs


def _is_actor_class(node: ast.ClassDef) -> bool:
    return any(d == "remote" or d.endswith(".remote")
               for d in decorator_names(node))


def _imports_of(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return out


def _span(node: ast.AST) -> Tuple[int, int]:
    return node.lineno, getattr(node, "end_lineno", node.lineno)


class _FunctionExtractor:
    """Builds one FunctionSummary from an ast function node."""

    def __init__(self, fn: ast.AST, qualname: str, cls: str,
                 is_actor: bool, bare_gets: Dict[str, str],
                 imports: Optional[Dict[str, str]] = None):
        self.fn = fn
        self.bare_gets = bare_gets
        self.imports = imports or {}
        self.axis_vars: Dict[str, str] = {}   # read by _axis_of
        self.axis_vars = self._axis_bindings()
        self.s = FunctionSummary(
            qualname=qualname, line=fn.lineno, cls=cls, is_actor=is_actor,
            is_async=isinstance(fn, ast.AsyncFunctionDef))

    def run(self) -> FunctionSummary:
        s = self.s
        rank_arm_nodes = []   # nodes already claimed by a rank branch
        for node in walk_scope(self.fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tag = _ctor_tag(node.value)
                if tag:
                    s.local_types[node.targets[0].id] = tag
            if isinstance(node, ast.If) and mentions_rank(node.test):
                s.rank_branches.append({
                    "line": node.lineno,
                    "arms": [self._arm(node.body), self._arm(node.orelse)],
                })
                rank_arm_nodes.append(node)
            elif isinstance(node, ast.IfExp) and mentions_rank(node.test):
                s.rank_branches.append({
                    "line": node.lineno,
                    "arms": [self._arm([node.body]),
                             self._arm([node.orelse])],
                })
            elif isinstance(node, ast.With):
                self._with(node)
            elif isinstance(node, ast.Call):
                self._call(node)
        self._channel_ops()
        self._spmd()
        return s

    # -- pieces ----------------------------------------------------------
    def _arm(self, nodes) -> Dict[str, Any]:
        ops, calls = [], []
        for n in nodes:
            for sub in ast.walk(n):
                if not isinstance(sub, ast.Call):
                    continue
                dev = self._device_op(sub)
                op = dev[0] if dev else collective_op(sub)
                if op:
                    ops.append([op, sub.lineno, sub.col_offset])
                else:
                    calls.append([dotted_name(sub.func), sub.lineno,
                                  sub.col_offset])
        return {"ops": ops, "calls": calls}

    def _call(self, node: ast.Call) -> None:
        s = self.s
        name = dotted_name(node.func)
        parts = name.split(".")
        s.calls.append([name, node.lineno, node.col_offset])
        dev = self._device_op(node)
        op = "" if dev else collective_op(node)
        if dev:
            s.device_collectives.append([dev[0], dev[1], node.lineno,
                                         node.col_offset])
        elif op:
            s.collectives.append([op, node.lineno, node.col_offset])
        short = name[5:] if name.startswith("self.") else name
        if name in BLOCKING_GET or short in BLOCKING_GET \
                or (len(parts) == 1
                    and self.bare_gets.get(parts[0]) == "get"):
            s.blocking.append({
                "kind": "get", "name": name, "line": node.lineno,
                "col": node.col_offset,
                "targets": [t for a in node.args + [k.value for k in
                                                    node.keywords]
                            for t in _remote_targets(a)]})
        elif name in BLOCKING_WAIT or short in BLOCKING_WAIT \
                or (len(parts) == 1
                    and self.bare_gets.get(parts[0]) == "wait"):
            s.blocking.append({"kind": "wait", "name": name,
                               "line": node.lineno, "col": node.col_offset,
                               "targets": []})
        elif name == "time.sleep":
            secs: Optional[float] = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, (int, float)):
                secs = float(node.args[0].value)
            s.blocking.append({"kind": "sleep", "name": name,
                               "line": node.lineno, "col": node.col_offset,
                               "seconds": secs, "targets": []})
        elif parts[-1] == "join" and len(parts) >= 2 and parts[0] != "?":
            s.blocking.append({"kind": "join", "name": name,
                               "recv": ".".join(parts[:-1]),
                               "line": node.lineno, "col": node.col_offset,
                               "targets": []})
        elif parts[-1] == "wait" and len(parts) >= 2 and parts[0] != "?":
            # cond.wait() — blocking unless it is the section's own lock
            s.blocking.append({"kind": "cond-wait", "name": name,
                               "recv": ".".join(parts[:-1]),
                               "line": node.lineno, "col": node.col_offset,
                               "targets": []})
        elif parts[-1] == "acquire" and len(parts) >= 2 \
                and parts[0] != "?":
            self.s.lock_sections.append({
                "expr": ".".join(parts[:-1]), "line": node.lineno,
                "col": node.col_offset, "span": [node.lineno, node.lineno],
                "acquire_only": True})

    def _with(self, node: ast.With) -> None:
        body_start = node.body[0].lineno if node.body else node.lineno
        group = id(node) & 0xFFFFFFFF
        for gi, item in enumerate(node.items):
            expr = item.context_expr
            if isinstance(expr, (ast.Name, ast.Attribute)):
                name = dotted_name(expr)
                if name.startswith("?"):
                    continue
                self.s.lock_sections.append({
                    "expr": name, "line": node.lineno,
                    "col": node.col_offset,
                    "span": [body_start, _span(node)[1]],
                    "acquire_only": False, "group": group,
                    "group_idx": gi})

    def _channel_ops(self) -> None:
        """Ordered channel ops with (block, idx) identity so protocol
        rules can reason about straight-line statement order."""
        block_counter = [0]
        BLOCK_ATTRS = ("body", "orelse", "finalbody")

        def header_calls(stmt):
            """Calls in a statement outside its nested blocks/scopes."""
            skip = set()
            for attr in BLOCK_ATTRS:
                for s in getattr(stmt, attr, None) or ():
                    skip.add(id(s))
            for h in getattr(stmt, "handlers", None) or ():
                skip.add(id(h))
            stack = [c for c in ast.iter_child_nodes(stmt)
                     if id(c) not in skip]
            while stack:
                n = stack.pop()
                if isinstance(n, FuncNode + (ast.Lambda,)):
                    continue
                if isinstance(n, ast.Call):
                    yield n
                stack.extend(ast.iter_child_nodes(n))

        def visit_block(stmts) -> None:
            block_counter[0] += 1
            bid = block_counter[0]
            for idx, stmt in enumerate(stmts):
                for sub in header_calls(stmt):
                    name = dotted_name(sub.func)
                    parts = name.split(".")
                    if len(parts) >= 2 and parts[-1] in CHANNEL_OPS \
                            and parts[0] != "?":
                        self.s.channel_ops.append({
                            "recv": ".".join(parts[:-1]),
                            "op": parts[-1], "line": sub.lineno,
                            "col": sub.col_offset, "block": bid,
                            "idx": idx})
                for attr in BLOCK_ATTRS:
                    sub_stmts = getattr(stmt, attr, None)
                    if sub_stmts:
                        visit_block(sub_stmts)
                for h in getattr(stmt, "handlers", None) or ():
                    visit_block(h.body)

        visit_block(self.fn.body)

    # -- SPMD plane ------------------------------------------------------
    def _spmd(self) -> None:
        """Populate FunctionSummary.spmd. Runs its own ordered traversal:
        the main walk is BFS (ast.walk) which scrambles statement order,
        and collective schedules are only meaningful linearized."""
        fn, s = self.fn, self.s
        sp: Dict[str, Any] = {}
        a = fn.args
        pos = [p.arg for p in list(getattr(a, "posonlyargs", [])) + a.args]
        sp["params"] = [len(pos), len(pos) - len(a.defaults),
                        1 if a.vararg else 0, pos[0] if pos else ""]
        sp["returns"] = _returns_arity(fn)
        jd = jit_decorator(fn, self.imports)
        if jd:
            sp["jit"] = jd

        uses: List[List[Any]] = []
        decls: List[List[Any]] = []
        wraps: List[List[Any]] = []
        groups: List[List[Any]] = []
        effects: List[List[Any]] = []
        # def f(..., axis_name="sp"): the default is an axis use too
        for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults):
            if p in ("axis_name", "axis_names") and d is not None:
                for ax in _axis_strs(d):
                    uses.append([ax, d.lineno, d.col_offset,
                                 "axis-default"])

        claimed: set = set()      # call nodes owned by rank-branch arms
        rank_scheds: List[Dict[str, Any]] = []
        captures: List[List[int]] = []
        for node in walk_scope(fn):
            if isinstance(node, ast.With) and any(
                    isinstance(it.context_expr, ast.Call)
                    and _is_cuda_graph(dotted_name(it.context_expr.func),
                                       self.imports)
                    for it in node.items):
                captures.append(list(_span(node)))
            elif isinstance(node, ast.Subscript):
                self._mesh_subscript(node, uses)
            is_rank_if = isinstance(node, ast.If) \
                and mentions_rank(node.test)
            is_rank_ifexp = isinstance(node, ast.IfExp) \
                and mentions_rank(node.test)
            if not (is_rank_if or is_rank_ifexp):
                continue
            parts = ([node.body, node.orelse] if is_rank_if
                     else [[node.body], [node.orelse]])
            arms = []
            for arm in parts:
                arm_calls = [c for st in arm for c in ast.walk(st)
                             if isinstance(c, ast.Call)]
                claimed.update(id(c) for c in arm_calls)
                arms.append(self._events(arm_calls))
            rank_scheds.append({"line": node.lineno, "arms": arms})

        all_calls = [n for n in walk_scope(fn)
                     if isinstance(n, ast.Call)]
        all_calls.sort(key=lambda c: (c.lineno, c.col_offset))
        for c in all_calls:
            self._spmd_call(c, uses, decls, wraps, groups, effects)
        schedule = self._events([c for c in all_calls
                                 if id(c) not in claimed])

        if uses:
            sp["axis_uses"] = uses
        if decls:
            sp["axis_decls"] = decls
        if wraps:
            sp["jit_wraps"] = wraps
        if groups:
            sp["group_literals"] = groups
        if effects:
            sp["host_effects"] = effects
        if schedule:
            sp["schedule"] = schedule
        if rank_scheds:
            sp["rank_scheds"] = rank_scheds
        if captures:
            sp["captures"] = sorted(captures)
        s.spmd = sp

    def _events(self, calls: List[ast.Call]) -> List[List[Any]]:
        out = []
        for c in sorted(calls, key=lambda c: (c.lineno, c.col_offset)):
            ev = self._event_for(c)
            if ev:
                out.append(ev)
        return out

    def _event_for(self, call: ast.Call) -> Optional[List[Any]]:
        name = dotted_name(call.func)
        dev = self._device_op(call)
        if dev is not None:
            return ["op", dev[0], dev[1], call.lineno, call.col_offset]
        op = collective_op(call)
        if op:
            return ["op", op, self._group_of(call, op),
                    call.lineno, call.col_offset]
        if "?" in name:
            return None
        return ["call", name, call.lineno, call.col_offset]

    def _axis_of(self, node: Optional[ast.AST]) -> str:
        """The literal axis name of an ``Axis.of(mesh, "x")`` /
        ``Axis.local("x")`` expression, or of a local name bound once to
        one; '' when it is not visible."""
        if isinstance(node, ast.Name):
            return self.axis_vars.get(node.id, "")
        if not isinstance(node, ast.Call):
            return ""
        parts = dotted_name(node.func).split(".")
        if len(parts) < 2 or parts[-2] != "Axis":
            return ""
        if parts[-1] == "of":
            axes = _axis_strs(_arg(node, "name", 1))
        elif parts[-1] == "local":
            axes = _axis_strs(_arg(node, "name", 0))
        else:
            return ""
        return axes[0] if len(axes) == 1 else ""

    def _axis_bindings(self) -> Dict[str, str]:
        """{local name: axis} for names this function binds exactly once,
        to a literal ``Axis.of``/``Axis.local``: ``axis = spmd.Axis.of(
        mesh, "pp")`` then ``spmd.sendrecv(..., axis)``."""
        seen: Dict[str, List[str]] = {}
        for node in walk_scope(self.fn):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        seen.setdefault(t.id, []).append(
                            self._axis_of(node.value))
        return {n: v[0] for n, v in seen.items() if len(v) == 1 and v[0]}

    def _device_op(self, call: ast.Call) -> Optional[Tuple[str, str]]:
        """(op, axis) when this call is a device collective — one of the
        port's ``spmd`` exchanges (axis from its ``Axis`` argument, '' if
        not literal) or a ``torch.distributed`` collective (axis '') —
        else None."""
        full = resolved_name(dotted_name(call.func), self.imports)
        owner, _, tail = full.rpartition(".")
        if owner.split(".")[-1] == "spmd" and tail in SPMD_COLLECTIVES:
            return tail, self._axis_of(
                _arg(call, "axis", SPMD_COLLECTIVES[tail]))
        if owner == "torch.distributed" and tail in DIST_COLLECTIVES:
            return tail, ""
        return None

    def _mesh_subscript(self, node: ast.Subscript, uses) -> None:
        """``mesh["tp"]`` / ``mesh["dp", "fsdp"]``: DeviceMesh slicing
        names mesh dims."""
        recv = dotted_name(node.value).split(".")[-1].lower()
        if "mesh" not in recv:
            return
        for ax in _axis_strs(node.slice):
            uses.append([ax, node.lineno, node.col_offset, "axis-query"])

    def _group_of(self, call: ast.Call, op: str) -> str:
        """Literal group name on a host-collective call, '' if dynamic."""
        node = _kwarg(call, "group_name")
        if node is None:
            idx = HOST_GROUP_ARG.get(op, -1)
            if 0 <= idx < len(call.args):
                node = call.args[idx]
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return ""

    def _collectiveish(self, parts: List[str], tail: str) -> bool:
        if len(parts) == 1:
            return tail in COLLECTIVE_OPS \
                or "collective" in self.imports.get(tail, "")
        return any(w in p for p in parts[:-1]
                   for w in _COLLECTIVE_RECEIVERS)

    def _spmd_call(self, call: ast.Call, uses, decls, wraps, groups,
                   effects) -> None:
        name = dotted_name(call.func)
        parts = name.split(".")
        tail = parts[-1]
        ln, col = call.lineno, call.col_offset

        # PartitionSpec("dp", ...) — bare aliases (P) resolve via imports
        full = self.imports.get(tail, "") if len(parts) == 1 else name
        if tail == "PartitionSpec" or full.endswith(".PartitionSpec"):
            for argn in list(call.args) + [k.value for k in call.keywords]:
                for ax in _axis_strs(argn):
                    uses.append([ax, ln, col, "partition-spec"])

        # axis_name=/axis_names= kwargs anywhere
        for kw in call.keywords:
            if kw.arg in ("axis_name", "axis_names"):
                for ax in _axis_strs(kw.value):
                    uses.append([ax, ln, col, "axis-kwarg"])

        # Axis.of(mesh, "sp") / Axis.local("sp"): the port's SPMD axes
        if len(parts) >= 2 and parts[-2] == "Axis" \
                and tail in ("of", "local"):
            for ax in _axis_strs(_arg(call, "name",
                                      1 if tail == "of" else 0)):
                uses.append([ax, ln, col, "axis-of"])
        # axis queries: mesh_axis_size(mesh, "tp"), mesh.get_group("tp"),
        # mesh.get_local_rank("tp")
        elif tail == "mesh_axis_size":
            for ax in _axis_strs(_arg(call, "name", 1)):
                uses.append([ax, ln, col, "axis-query"])
        elif tail in MESH_AXIS_METHODS and len(parts) >= 2 \
                and "mesh" in parts[-2].lower():
            for ax in _axis_strs(_arg(call, "mesh_dim", 0)):
                uses.append([ax, ln, col, "axis-query"])
        elif tail == "mesh_groups":
            for ax in _axis_strs(_arg(call, "names", 1)):
                uses.append([ax, ln, col, "mesh-groups"])

        # ShardingRules mesh-axis values: .with_(embed="fsdp") kwarg
        # values, and the (("logical", ("mesh", ...)), ...) rule tables
        if tail == "with_":
            for kw in call.keywords:
                for ax in _axis_strs(kw.value):
                    uses.append([ax, ln, col, "rules-value"])
        elif tail == "ShardingRules" or (tail == "cls"
                                         and self.s.cls == "ShardingRules"):
            for argn in call.args:
                if isinstance(argn, (ast.Tuple, ast.List)):
                    for e in argn.elts:
                        if isinstance(e, (ast.Tuple, ast.List)) \
                                and len(e.elts) == 2:
                            for ax in _axis_strs(e.elts[1]):
                                uses.append([ax, ln, col, "rules-value"])

        # mesh constructions declare axes
        if tail in ("MeshSpec", "DCNSpec"):
            for kw in call.keywords:
                if kw.arg:
                    decls.append([kw.arg, ln])
        elif tail in ("DeviceMesh", "init_device_mesh"):
            for ax in _axis_strs(_kwarg(call, "mesh_dim_names")):
                decls.append([ax, ln])

        # compile-boundary call sites with a resolvable target:
        # _shard_map(f, mesh, in_specs, out_specs), local_map(f,
        # out_placements, in_placements), sharded_jit(f, ...),
        # torch.compile(f), make_graphed_callables(f or (f, g), ...)
        in_a = out_a = -1
        if tail == "_shard_map":
            in_a = _spec_arity(_arg(call, "in_specs", 2))
            out_a = _spec_arity(_arg(call, "out_specs", 3))
        elif tail == "local_map":
            in_a = _spec_arity(_arg(call, "in_placements", 2))
            # a list is ONE output's placements; a tuple, one per output
            out = _arg(call, "out_placements", 1)
            out_a = len(out.elts) if isinstance(out, ast.Tuple) else -1
        elif tail == "sharded_jit":
            in_a = _spec_arity(_kwarg(call, "in_specs"))
            out_a = _spec_arity(_kwarg(call, "out_specs"))
        if tail in ("_shard_map", "local_map", "sharded_jit"):
            wrap_kind = tail
        elif is_torch_compile(name, self.imports):
            wrap_kind = "compile"
        elif resolved_name(name, self.imports) in (
                "torch.cuda.make_graphed_callables",
                "torch.cuda.graphs.make_graphed_callables"):
            wrap_kind = "graphed"
        else:
            wrap_kind = ""
        first = _arg(call, "func", 0) if wrap_kind else None
        targets = first.elts if wrap_kind == "graphed" \
            and isinstance(first, ast.Tuple) else [first]
        for target in targets:
            if isinstance(target, (ast.Name, ast.Attribute)):
                tname = dotted_name(target)
                if "?" not in tname:
                    wraps.append([wrap_kind, tname, ln, in_a, out_a])

        # hardcoded group names on host-collective calls
        if tail in HOST_GROUP_ARG and self._collectiveish(parts, tail):
            g = self._group_of(call, tail)
            if g:
                groups.append([tail, g, ln, col])

        # host effects: wall-clock reads and metric RPCs
        short = name[5:] if name.startswith("self.") else name
        if name in WALL_CLOCK or short in WALL_CLOCK \
                or (len(parts) == 1
                    and self.imports.get(tail, "") in WALL_CLOCK):
            effects.append(["wall-clock", name, ln, col])
        elif tail in ("inc", "observe", "set") and len(parts) >= 2 \
                and any(w in p.lower() for p in parts[:-1]
                        for w in _METRIC_RECV_WORDS):
            effects.append(["metric", name, ln, col])


def _class_summary(node: ast.ClassDef, module: str) -> ClassSummary:
    cs = ClassSummary(name=node.name, line=node.lineno,
                      is_actor=_is_actor_class(node),
                      bases=[dotted_name(b).split(".")[-1]
                             for b in node.bases])
    for st in node.body:
        if isinstance(st, FuncNode):
            cs.methods.append(st.name)
        elif isinstance(st, ast.Assign):
            for t in st.targets:
                if isinstance(t, ast.Name):
                    tag = _ctor_tag(st.value)
                    if tag:
                        cs.attr_types[t.id] = tag
                        cs.attr_lines[t.id] = st.lineno
    # self.X = <ctor> anywhere in the class's methods
    for fn in node.body:
        if not isinstance(fn, FuncNode):
            continue
        for sub in walk_scope(fn):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                t = sub.targets[0]
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    tag = _ctor_tag(sub.value)
                    if tag and t.attr not in cs.attr_types:
                        cs.attr_types[t.attr] = tag
                        cs.attr_lines[t.attr] = sub.lineno
    return cs


def summarize(tree: ast.Module, source: str, path: str) -> FileSummary:
    """The per-file half of the interprocedural analysis; pure function
    of the file content, which is what makes it cacheable."""
    module = module_name_for(path)
    fs = FileSummary(path=path, module=module)
    fs.imports = _imports_of(tree)
    bare_gets = {local: target.rsplit(".", 1)[1]
                 for local, target in fs.imports.items()
                 if target in ("ray_tpu_torch.get", "ray_tpu_torch.wait")}

    for node in tree.body:
        targets: List[ast.Name] = []
        value: Optional[ast.AST] = None
        if isinstance(node, ast.Assign):
            targets = [t for t in node.targets if isinstance(t, ast.Name)]
            value = node.value
            for t in targets:
                tag = _ctor_tag(node.value)
                if tag:
                    fs.module_types[t.id] = tag
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            # AXIS_ORDER: Tuple[str, ...] = ("dp", ...) is an AnnAssign
            targets, value = [node.target], node.value
        for t in targets:
            if ("axis" in t.id.lower() or "axes" in t.id.lower()) \
                    and isinstance(value, (ast.Tuple, ast.List)):
                for ax in _axis_strs(value):
                    fs.spmd.setdefault("axis_decls", []).append(
                        [ax, node.lineno])

    # parent map for qualnames
    parents: Dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node

    def qualname_of(fn: ast.AST) -> Tuple[str, str, bool]:
        names: List[str] = [fn.name]
        cls, is_actor = "", False
        cur = parents.get(id(fn))
        while cur is not None and not isinstance(cur, ast.Module):
            if isinstance(cur, ast.ClassDef):
                if not cls:
                    cls, is_actor = cur.name, _is_actor_class(cur)
                names.append(cur.name)
            elif isinstance(cur, FuncNode):
                names.append(cur.name)
            cur = parents.get(id(cur))
        return ".".join(reversed(names)), cls, is_actor

    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            fs.classes.append(_class_summary(node, module))
        elif isinstance(node, FuncNode):
            qn, cls, is_actor = qualname_of(node)
            fs.functions.append(_FunctionExtractor(
                node, qn, cls, is_actor, bare_gets, fs.imports).run())

    from ray_tpu_torch.devtools.lint.rules.config_drift import extract_config
    fs.config = extract_config(tree, source, path)
    return fs
