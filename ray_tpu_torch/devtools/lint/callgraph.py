"""Project call graph over per-file summaries.

Nodes are functions, identified as ``"<module>:<qualname>"`` (e.g.
``ray_tpu_torch.serve.controller:ServeController._stop``). Edges come from
call-site name resolution — flow-insensitive and deliberately partial:
a callee the resolver cannot pin to exactly one project function is
dropped, so interprocedural rules under-approximate reachability
instead of spraying false positives through the tier-1 gate.

Resolution handles the shapes this codebase actually uses:

- bare names -> same-module functions, then ``from x import f`` imports
- ``self.m`` / ``cls.m`` -> the enclosing class, then its bases
  (project-wide, matched by class name)
- ``C.m`` / ``mod.f`` -> classes/modules visible through the import map

Reachability is depth-capped (``depth``): summaries propagate at most
that many call hops, which bounds both analysis cost and the blast
radius of a resolution mistake.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.devtools.lint.summaries import (ClassSummary, FileSummary,
                                                   FunctionSummary)

DEFAULT_DEPTH = 6


class ProjectGraph:
    """Whole-program view handed to ``scope = "graph"`` rules."""

    def __init__(self, files: List[FileSummary],
                 depth: int = DEFAULT_DEPTH):
        self.files = files
        self.depth = depth
        self.functions: Dict[str, FunctionSummary] = {}
        self.fn_path: Dict[str, str] = {}           # node id -> file path
        self.classes: Dict[str, Tuple[str, ClassSummary]] = {}
        self.class_index: Dict[str, List[Tuple[str, ClassSummary]]] = {}
        self.actor_methods: Dict[str, List[str]] = {}  # meth -> [cls names]
        self._by_module: Dict[str, Dict[str, str]] = {}
        self._imports: Dict[str, Dict[str, str]] = {}
        self._resolve_cache: Dict[Tuple[str, str, str], Optional[str]] = {}

        for fs in files:
            mod_fns = self._by_module.setdefault(fs.module, {})
            self._imports[fs.module] = fs.imports
            for f in fs.functions:
                nid = f"{fs.module}:{f.qualname}"
                self.functions[nid] = f
                self.fn_path[nid] = fs.path
                mod_fns.setdefault(f.qualname, nid)
            for c in fs.classes:
                self.classes.setdefault(c.name, (fs.module, c))
                self.class_index.setdefault(c.name, []).append(
                    (fs.module, c))
                if c.is_actor:
                    for m in c.methods:
                        self.actor_methods.setdefault(m, [])
                        if c.name not in self.actor_methods[m]:
                            self.actor_methods[m].append(c.name)

    # -- identity helpers ------------------------------------------------
    def node_id(self, module: str, qualname: str) -> str:
        return f"{module}:{qualname}"

    def summary(self, nid: str) -> Optional[FunctionSummary]:
        return self.functions.get(nid)

    def class_of(self, name: str, prefer_module: str = ""
                 ) -> Optional[Tuple[str, ClassSummary]]:
        hits = self.class_index.get(name, [])
        for mod, cs in hits:
            if mod == prefer_module:
                return mod, cs
        return hits[0] if hits else None

    def method_node(self, cls_name: str, method: str,
                    prefer_module: str = "") -> Optional[str]:
        """Resolve Class.method to a node id, walking base classes."""
        seen = set()
        queue = deque([cls_name])
        while queue:
            cname = queue.popleft()
            if cname in seen:
                continue
            seen.add(cname)
            hit = self.class_of(cname, prefer_module)
            if hit is None:
                continue
            mod, cs = hit
            if method in cs.methods:
                nid = self.node_id(mod, f"{cs.name}.{method}")
                if nid in self.functions:
                    return nid
            queue.extend(cs.bases)
        return None

    def attr_type(self, cls_name: str, attr: str,
                  prefer_module: str = "") -> Tuple[str, str, str]:
        """(tag, defining_module, defining_class) for self.<attr>, walking
        bases; ('', '', '') when unknown."""
        seen = set()
        queue = deque([cls_name])
        while queue:
            cname = queue.popleft()
            if cname in seen:
                continue
            seen.add(cname)
            hit = self.class_of(cname, prefer_module)
            if hit is None:
                continue
            mod, cs = hit
            if attr in cs.attr_types:
                return cs.attr_types[attr], mod, cs.name
            queue.extend(cs.bases)
        return "", "", ""

    # -- call resolution -------------------------------------------------
    def resolve_call(self, module: str, cls: str, name: str
                     ) -> Optional[str]:
        """Node id for a call-site name seen in (module, class) context,
        or None when it cannot be pinned to one project function."""
        key = (module, cls, name)
        if key in self._resolve_cache:
            return self._resolve_cache[key]
        nid = self._resolve_uncached(module, cls, name)
        self._resolve_cache[key] = nid
        return nid

    def _resolve_uncached(self, module: str, cls: str, name: str
                          ) -> Optional[str]:
        parts = name.split(".")
        mod_fns = self._by_module.get(module, {})
        imports = self._imports.get(module, {})

        if parts[0] in ("self", "cls") and len(parts) == 2 and cls:
            return self.method_node(cls, parts[1], prefer_module=module)
        if len(parts) == 1:
            n = parts[0]
            if n in mod_fns:
                return mod_fns[n]
            target = imports.get(n)
            if target and "." in target:
                tmod, tfn = target.rsplit(".", 1)
                hit = self._by_module.get(tmod, {}).get(tfn)
                if hit:
                    return hit
                # `from pkg import Class` then Class(...) — constructor
                pair = self.class_of(tfn, prefer_module=tmod)
                if pair and pair[0] == tmod:
                    return self.method_node(tfn, "__init__", tmod)
            # nested function: unique `outer.<n>` in this module
            nested = [nid for qn, nid in mod_fns.items()
                      if qn.endswith(f".{n}")]
            if len(nested) == 1:
                return nested[0]
            return None
        if len(parts) == 2:
            root, leaf = parts
            # Class.method in this module or through imports
            if root[:1].isupper():
                pair = self.class_of(root, prefer_module=module)
                target = imports.get(root)
                if target and "." in target:
                    tmod, tcls = target.rsplit(".", 1)
                    pair = self.class_of(tcls, prefer_module=tmod) or pair
                if pair:
                    return self.method_node(pair[1].name, leaf, pair[0])
                return None
            # mod.f through `import mod` / `from pkg import mod`
            target = imports.get(root)
            if target:
                hit = self._by_module.get(target, {}).get(leaf)
                if hit:
                    return hit
            if root in self._by_module:
                return self._by_module[root].get(leaf)
        return None

    def successors(self, nid: str) -> Iterator[Tuple[str, List]]:
        """(callee node id, call site [name, line, col]) pairs."""
        s = self.functions.get(nid)
        if s is None:
            return
        module = nid.split(":", 1)[0]
        for site in s.calls:
            callee = self.resolve_call(module, s.cls, site[0])
            if callee is not None and callee != nid:
                yield callee, site

    # -- reachability ----------------------------------------------------
    def reach(self, start: str, depth: Optional[int] = None,
              include_start: bool = True
              ) -> Iterator[Tuple[str, List[List]]]:
        """BFS over call edges from ``start`` up to the depth cap,
        yielding (node id, call-site path from start). The path is the
        chain of [name, line, col] sites that led there."""
        cap = self.depth if depth is None else depth
        seen = {start}
        queue: deque = deque([(start, [], 0)])
        while queue:
            nid, path, d = queue.popleft()
            if include_start or nid != start:
                yield nid, path
            if d >= cap:
                continue
            for callee, site in self.successors(nid):
                if callee not in seen:
                    seen.add(callee)
                    queue.append((callee, path + [site], d + 1))

    def find(self, start: str,
             pred: Callable[[FunctionSummary], bool],
             depth: Optional[int] = None
             ) -> Optional[Tuple[str, List[List]]]:
        """First reachable node whose summary satisfies ``pred``."""
        for nid, path in self.reach(start, depth):
            s = self.functions.get(nid)
            if s is not None and pred(s):
                return nid, path
        return None

    # -- domain-specific lookups ----------------------------------------
    def collectives_reachable(self, start: str,
                              depth: Optional[int] = None
                              ) -> Dict[str, Tuple[str, List[List], List]]:
        """{op: (node id, call path, op site)} over the reachable set."""
        out: Dict[str, Tuple[str, List[List], List]] = {}
        for nid, path in self.reach(start, depth):
            s = self.functions.get(nid)
            if s is None:
                continue
            for op, line, col in s.collectives:
                out.setdefault(op, (nid, path, [op, line, col]))
            for op, _axis, line, col in s.device_collectives:
                out.setdefault(op, (nid, path, [op, line, col]))
        return out

    def declared_axes(self) -> Dict[str, Tuple[str, int]]:
        """{axis name: (declaring path, line)} over every file's SPMD
        extract — module constants (AXIS_ORDER = (...)) plus in-function
        mesh constructions (DeviceMesh/init_device_mesh mesh_dim_names,
        MeshSpec/DCNSpec keywords)."""
        out: Dict[str, Tuple[str, int]] = {}
        for fs in self.files:
            for ax, line in (fs.spmd or {}).get("axis_decls", []):
                out.setdefault(ax, (fs.path, line))
            for f in fs.functions:
                for ax, line in (f.spmd or {}).get("axis_decls", []):
                    out.setdefault(ax, (fs.path, line))
        return out

    def linearize_events(self, module: str, cls: str, events: List[List],
                         depth: Optional[int] = None,
                         _seen: frozenset = frozenset()
                         ) -> List[Tuple[str, str]]:
        """Flatten an ordered SPMD event list into (op, axis-or-group)
        tokens, inlining resolvable helper calls depth-first so the
        result is the rank's actual rendezvous order. Depth-capped and
        cycle-safe; unresolvable calls contribute nothing (conservative:
        under-approximates, never invents an op)."""
        cap = self.depth if depth is None else depth
        out: List[Tuple[str, str]] = []
        for ev in events:
            if ev[0] == "op":
                out.append((ev[1], ev[2]))
                continue
            callee = self.resolve_call(module, cls, ev[1])
            if callee is None or callee in _seen or cap <= 0:
                continue
            cs = self.functions.get(callee)
            if cs is None:
                continue
            out.extend(self.linearize_events(
                callee.split(":", 1)[0], cs.cls,
                (cs.spmd or {}).get("schedule", []),
                cap - 1, _seen | {callee}))
        return out

    def resolve_lock(self, module: str, cls: str, expr: str
                     ) -> Tuple[str, str]:
        """(lock key, kind) for an acquisition expression, ('', '') when
        unknown. Keys name the defining site: 'module:Class.attr' or
        'module:NAME'."""
        parts = expr.split(".")
        if parts[0] == "self" and len(parts) == 2 and cls:
            tag, dmod, dcls = self.attr_type(cls, parts[1],
                                             prefer_module=module)
            if tag in ("lock", "rlock", "cond"):
                return f"{dmod}:{dcls}.{parts[1]}", tag
            return "", ""
        if len(parts) == 1:
            for fs in self.files:
                if fs.module == module:
                    tag = fs.module_types.get(parts[0], "")
                    if tag in ("lock", "rlock", "cond"):
                        return f"{module}:{parts[0]}", tag
                    target = fs.imports.get(parts[0])
                    if target and "." in target:
                        tmod, tname = target.rsplit(".", 1)
                        for other in self.files:
                            if other.module == tmod:
                                tag = other.module_types.get(tname, "")
                                if tag in ("lock", "rlock", "cond"):
                                    return f"{tmod}:{tname}", tag
                    break
            return "", ""
        return "", ""


def build_graph(files: List[FileSummary],
                depth: int = DEFAULT_DEPTH) -> ProjectGraph:
    return ProjectGraph(files, depth=depth)
