"""actor-get-cycle: blocking get whose remote target can call back.

The canonical distributed deadlock: actor A's method blocks in
``ray_tpu_torch.get(b.f.remote(...))`` while B.f (or anything B.f blocks on
in turn) makes a blocking get back into actor A. A is single-threaded
and stuck inside the get, so the call-back can never be served — both
actors hang until a timeout reaps the job (the serve-controller
``_stop`` hang fixed in PR 5 was exactly this shape).

Detection is interprocedural over the project call graph:

1. From every actor method, collect blocking-get sites reachable
   through local helper calls (same class / same module, depth-capped).
2. Each get site names its remote targets (``recv.meth.remote``).
   Receivers resolve through class-attribute and local-variable actor
   types (``self._h = Worker.remote(...)``); an unresolved receiver
   falls back to the actor classes that define the method name, but
   only when that resolution is unique — an ambiguous method name is
   dropped rather than guessed.
3. Follow the blocking-get edges actor-to-actor. If the closure can
   re-enter the originating actor class (including a self-get), the
   originating get site is flagged with the full cycle path.

``get`` on a self-owned handle (``ray_tpu_torch.get(self._self_handle.m
.remote())``) is degenerate but caught by the same machinery.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register


def _resolve_targets(graph, summary, module: str,
                     targets: List[dict]) -> List[Tuple[str, str]]:
    """[(actor class name, method)] a get site can block on."""
    out: List[Tuple[str, str]] = []
    for t in targets:
        recv, method = t["recv"], t["method"]
        cls_name: Optional[str] = None
        parts = recv.split(".")
        if parts[0] == "self" and len(parts) == 2 and summary.cls:
            tag, _, _ = graph.attr_type(summary.cls, parts[1],
                                        prefer_module=module)
            if tag.startswith("actor:"):
                cls_name = tag.split(":", 1)[1]
        elif len(parts) == 1:
            tag = summary.local_types.get(parts[0], "")
            if tag.startswith("actor:"):
                cls_name = tag.split(":", 1)[1]
        if cls_name is None:
            # name-based fallback: unique actor class defining the method
            owners = graph.actor_methods.get(method, [])
            if len(owners) == 1:
                cls_name = owners[0]
        if cls_name is not None:
            hit = graph.class_of(cls_name, prefer_module=module)
            if hit is not None and hit[1].is_actor \
                    and method in hit[1].methods:
                out.append((cls_name, method))
    return out


def _get_edges(graph, start_nid: str):
    """Blocking-get sites reachable from ``start_nid`` through local
    calls: [(site dict, site node id, summary, call path, targets)]."""
    out = []
    for nid, path in graph.reach(start_nid):
        s = graph.summary(nid)
        if s is None:
            continue
        module = nid.split(":", 1)[0]
        for b in s.blocking:
            if b["kind"] != "get" or not b.get("targets"):
                continue
            resolved = _resolve_targets(graph, s, module, b["targets"])
            if resolved:
                out.append((b, nid, s, path, resolved))
    return out


@register
class ActorGetCycle(Rule):
    id = "actor-get-cycle"
    doc = ("blocking ray_tpu_torch.get inside an actor method whose remote "
           "target can call back into the same actor — distributed "
           "deadlock")
    hint = ("break the cycle: make one side async (await / callback), "
            "or move the blocking get off the actor's main thread")
    scope = "graph"

    def check_graph(self, graph):
        # cache: actor class -> outgoing blocking-get target classes
        edges_of: Dict[str, Set[str]] = {}

        def class_edges(cls_name: str) -> Set[str]:
            if cls_name in edges_of:
                return edges_of[cls_name]
            edges_of[cls_name] = set()   # cycle guard during build
            hit = graph.class_of(cls_name)
            if hit is None:
                return set()
            mod, cs = hit
            targets: Set[str] = set()
            for m in cs.methods:
                nid = graph.method_node(cls_name, m, prefer_module=mod)
                if nid is None:
                    continue
                for edge in _get_edges(graph, nid):
                    targets.update(c for c, _ in edge[4])
            edges_of[cls_name] = targets
            return targets

        def reaches(src_cls: str, dst_cls: str,
                    seen: Set[str]) -> Optional[List[str]]:
            """Chain of actor classes from src to dst over blocking-get
            edges, or None."""
            if src_cls == dst_cls:
                return [src_cls]
            if src_cls in seen:
                return None
            seen.add(src_cls)
            for nxt in sorted(class_edges(src_cls)):
                sub = reaches(nxt, dst_cls, seen)
                if sub is not None:
                    return [src_cls] + sub
            return None

        reported: Set[Tuple[str, int]] = set()
        for nid, s in sorted(graph.functions.items()):
            if not s.is_actor or not s.cls:
                continue
            qual_head = s.qualname.split(".")[0]
            if qual_head != s.cls:
                continue   # nested class oddities: skip
            for b, site_nid, where, path, resolved in _get_edges(graph,
                                                                 nid):
                for target_cls, target_meth in resolved:
                    chain = reaches(target_cls, s.cls, set())
                    if chain is None:
                        continue
                    site = (where.qualname, b["line"])
                    if site in reported:
                        continue
                    reported.add(site)
                    via = "" if not path else (
                        " (reached via " +
                        " -> ".join(p[0] for p in path) + ")")
                    loop = " -> ".join([s.cls] + chain)
                    yield Finding(
                        rule=self.id,
                        path=graph.fn_path.get(site_nid, where.qualname),
                        line=b["line"], col=b["col"],
                        message=(f"blocking {b['name']}(...) on "
                                 f"{target_cls}.{target_meth} inside "
                                 f"actor method {s.cls}."
                                 f"{s.qualname.split('.', 1)[1]} can "
                                 f"deadlock: {loop}{via}"),
                        hint=self.hint)
                    break
