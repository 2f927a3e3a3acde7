"""host-effect-in-jit: host-side effects in code that is captured once.

On the card, two kinds of region run their Python once and replay what
it launched. A ``torch.cuda.graph`` capture records the kernels its
body enqueues; every ``replay()`` relaunches those kernels and never
runs the Python again. ``torch.compile`` traces the body into a graph
and replays it while its guards hold. A host effect written there —
``ray_tpu_torch.get``, ``time.sleep``, a wall-clock read, a metrics
RPC, a host collective — either executes exactly once and bakes its
result into what is replayed (wall-clock reads, metric increments that
silently stop counting) or splits the region at every call (a graph
break in the compiled function, a capture that fails outright). Both
are bugs that CPU tests cannot see: on the CPU there is no capture and
the eager path runs the Python every time.

Roots are ``with torch.cuda.graph(...)`` capture blocks (the effects in
the block itself, and everything reachable from its calls), the
targets of ``torch.cuda.make_graphed_callables(f, ...)``, functions
decorated with ``torch.compile`` and the targets of ``torch.compile(f)``
call sites. The port's ``sharded_jit`` is *not* a root: it is a
late-bound call whose body runs eagerly under ``local_map`` on every
call, so a host effect there runs every time, as written. Reachability
is deliberately shallow (depth 3): helpers called from a captured body
are usually device code, and the short horizon keeps a resolution
mistake from spraying findings.
"""

from __future__ import annotations

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register

_DEPTH = 3
_BLOCK_WORDS = {"get": "blocking ray_tpu_torch.get", "wait": "blocking wait",
                "sleep": "time.sleep", "join": "thread join",
                "cond-wait": "condition wait"}
# jit_wraps kinds whose target is compiled or captured once
_ROOT_WRAPS = ("compile", "graphed")


def _sites(s):
    """(line, col, what, effect kind) of every host effect in a summary."""
    out = []
    for b in s.blocking:
        what = _BLOCK_WORDS.get(b["kind"], b["kind"])
        out.append((b["line"], b["col"], f"{what} ({b['name']})", b["kind"]))
    for op, line, col in s.collectives:
        out.append((line, col, f"host collective {op}(...)",
                    "host-collective"))
    for kind, name, line, col in (s.spmd or {}).get("host_effects", []):
        what = "wall-clock read" if kind == "wall-clock" else "metric RPC"
        out.append((line, col, f"{what} ({name})", kind))
    return out


@register
class HostEffectInJit(Rule):
    id = "host-effect-in-jit"
    doc = ("host-side effect (blocking get/wait/sleep, wall-clock read, "
           "metric RPC, host collective) inside a torch.cuda.graph "
           "capture or a torch.compile body — runs at capture time only, "
           "or breaks the region at every call")
    hint = ("move the host effect outside the captured/compiled region "
            "and pass its result in as a tensor (or return data to log)")
    scope = "graph"

    def _roots(self, graph):
        """[(node id, root name, (first, last) line span or None)]: whole
        functions that are compiled/captured, and the calls made inside
        capture blocks (their callees are captured whole)."""
        roots = {}
        for nid, s in sorted(graph.functions.items()):
            sp = s.spmd or {}
            if (sp.get("jit") or {}).get("kind") == "compile":
                roots.setdefault(nid, (s.qualname, None))
            module = nid.split(":", 1)[0]
            for kind, target, _line, _ia, _oa in sp.get("jit_wraps", []):
                if kind not in _ROOT_WRAPS:
                    continue
                callee = graph.resolve_call(module, s.cls, target)
                if callee is not None and callee in graph.functions:
                    roots.setdefault(
                        callee, (graph.functions[callee].qualname, None))
            for start, end in sp.get("captures", []):
                name = f"the torch.cuda.graph capture in {s.qualname} " \
                       f"(line {start})"
                roots.setdefault((nid, start), (name, (start, end)))
        return roots

    def _reach(self, graph, root, span):
        """(node id, span filter) pairs a root covers: a capture block is
        its own function's lines in the span plus the callees of the calls
        there; a compiled function is everything it reaches."""
        if span is None:
            for nid, _path in graph.reach(root, depth=_DEPTH):
                yield nid, None
            return
        nid = root[0]
        yield nid, span
        s = graph.functions[nid]
        module = nid.split(":", 1)[0]
        seen = {nid}
        for name, line, _col in s.calls:
            if not span[0] <= line <= span[1]:
                continue
            callee = graph.resolve_call(module, s.cls, name)
            if callee is None:
                continue
            for sub, _path in graph.reach(callee, depth=_DEPTH - 1):
                if sub not in seen:
                    seen.add(sub)
                    yield sub, None

    def check_graph(self, graph):
        reported = set()
        for root, (root_name, span) in sorted(self._roots(graph).items(),
                                              key=lambda kv: str(kv[0])):
            for nid, within in self._reach(graph, root, span):
                s = graph.functions.get(nid)
                if s is None:
                    continue
                path = graph.fn_path.get(nid, "?")
                inside = "" if nid == root or within else \
                    f" (called from jitted {root_name})"
                for line, col, what, kind in _sites(s):
                    if within and not within[0] <= line <= within[1]:
                        continue
                    key = (nid, line, col)
                    if key in reported:
                        continue
                    reported.add(key)
                    yield Finding(
                        rule=self.id, path=path, line=line, col=col,
                        message=(f"{what} inside the jit-compiled body "
                                 f"of {root_name}{inside} — executes at "
                                 "trace time only (or blocks every "
                                 "dispatch)"),
                        hint=self.hint,
                        spmd={"jit_root": root_name, "effect": kind})
