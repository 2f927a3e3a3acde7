"""channel-protocol: compiled-graph / standing-channel lifecycle misuse.

The compiled-DAG layer (ray_tpu_torch/dag) trades per-call dispatch for
standing channels, which buys a protocol the type system does not
enforce:

- ``execute()`` after ``teardown()`` raises at runtime ("CompiledDAG
  has been torn down") — statically visible when both happen on the
  same receiver in one straight-line block.
- ``put``/``enqueue``/``write`` after ``close()`` on the same channel
  silently drops or raises depending on the transport — same shape.
- a class that compiles a standing graph (``self.x = dag.
  experimental_compile()``) but whose shutdown path never calls
  ``self.x.teardown()`` leaks the channels and the pinned actors of
  every instance (the router's drop-compiled/drain dance exists
  precisely because of this).
- the KV-handoff lifecycle (serve/kv_transfer.py) rides the same
  protocol: ``export()`` after the exporter's ``close()`` raises (the
  pins are already withdrawn), and ``adopt()`` after the standing
  decode channel's ``teardown()``/``close()`` resolves refs whose
  primaries may already be unpinned — both are ordering errors, same
  shape as put-after-close.

Statement-order checks use the (block, idx) identity the summaries
record — two ops only pair when they sit in the same statement list,
so ``if err: dag.teardown()`` followed by a normal-path ``execute()``
does not false-positive. The shutdown-path check walks the class's
own methods through the call graph: any teardown reachable from any
shutdown-ish method (``shutdown``/``stop``/``close``/``__exit__``...)
satisfies it.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register
from ray_tpu_torch.devtools.lint.summaries import SHUTDOWN_METHODS

_TERMINAL = {"teardown": ("execute", "adopt"),
             "close": ("put", "enqueue", "write", "export", "adopt")}


@register
class ChannelProtocol(Rule):
    id = "channel-protocol"
    doc = ("compiled-graph misuse: execute() after teardown(), enqueue "
           "on a closed channel, or a compiled graph no shutdown path "
           "tears down")
    hint = ("teardown()/close() must be the last op on a channel; give "
            "the owning class a shutdown path that tears the graph down")
    scope = "graph"

    def check_graph(self, graph):
        yield from self._sequencing(graph)
        yield from self._shutdown_paths(graph)

    # -- execute-after-teardown / put-after-close ------------------------
    def _sequencing(self, graph):
        for nid, s in sorted(graph.functions.items()):
            # (recv, block) -> [(op, line, col, idx)]
            seq: Dict[Tuple[str, int], List[Tuple[str, int, int, int]]]
            seq = {}
            for op in s.channel_ops:
                seq.setdefault((op["recv"], op["block"]), []).append(
                    (op["op"], op["line"], op["col"], op["idx"]))
            for (recv, _), ops in sorted(seq.items()):
                ops.sort(key=lambda t: t[3])
                for term, banned in _TERMINAL.items():
                    term_idx = next((t[3] for t in ops if t[0] == term),
                                    None)
                    if term_idx is None:
                        continue
                    for op, line, col, idx in ops:
                        if op in banned and idx > term_idx:
                            yield Finding(
                                rule=self.id,
                                path=graph.fn_path.get(nid, "?"),
                                line=line, col=col,
                                message=(f"{recv}.{op}(...) after "
                                         f"{recv}.{term}() in "
                                         f"{s.qualname} — the channel "
                                         "is already released"),
                                hint=self.hint)

    # -- compiled graph without a teardown on shutdown paths -------------
    def _shutdown_paths(self, graph):
        path_of_module = {fs.module: fs.path for fs in graph.files}
        for cls_name, (module, cs) in sorted(graph.classes.items()):
            compiled = sorted(a for a, tag in cs.attr_types.items()
                              if tag == "compiled")
            if not compiled:
                continue
            shutdownish = [m for m in cs.methods
                           if m in SHUTDOWN_METHODS]
            if not shutdownish:
                continue   # no shutdown path to audit
            torn: Set[str] = set()
            for m in shutdownish:
                nid = graph.method_node(cls_name, m,
                                        prefer_module=module)
                if nid is None:
                    continue
                for rnid, _ in graph.reach(nid):
                    rs = graph.summary(rnid)
                    if rs is None:
                        continue
                    for op in rs.channel_ops:
                        if op["op"] == "teardown":
                            recv = op["recv"].split(".")
                            if recv[0] == "self" and len(recv) == 2:
                                torn.add(recv[1])
                            else:
                                # torn down via a local alias — accept
                                # any teardown in the class's own reach
                                torn.update(compiled)
            for attr in compiled:
                if attr in torn:
                    continue
                yield Finding(
                    rule=self.id,
                    path=path_of_module.get(module, "?"),
                    line=cs.attr_lines.get(attr, cs.line), col=0,
                    message=(f"{cls_name}.{attr} holds a compiled graph "
                             f"but no shutdown path ("
                             f"{', '.join(sorted(shutdownish))}) ever "
                             f"calls its teardown() — standing channels "
                             "and pinned actors leak"),
                    hint=self.hint)
