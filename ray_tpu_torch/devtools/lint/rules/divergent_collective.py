"""divergent-collective: collective op call under a rank conditional.

Collective operations (allreduce/allgather/broadcast/reducescatter/
barrier) are rendezvous points: every rank in the group must reach the
same call in the same order, or the ranks that did call it block until
the per-round timeout fires and the whole slice aborts. ``if rank ==
0: broadcast(...)`` is the canonical deadlock — broadcast is collective
even for the source rank.

Interprocedural since the raylint call-graph engine landed: a helper
that hides the collective no longer hides the hazard —

    if rank == 0:
        _sync_weights(model)      # _sync_weights allreduces inside

is flagged at the call site, with the path to the buried collective.
The convergence check is symmetric: an op invoked (directly or through
helpers) in *both* arms is a rendezvous every rank still reaches, so
``broadcast(x) if rank == 0 else broadcast(None)`` stays clean even
when one side routes through a wrapper.

Matches the host collectives by bare name (``from
ray_tpu_torch.collective import barrier``) and through a collective-ish
receiver (``collective.barrier``, ``col.allreduce``,
``self.group.barrier``), and the device collectives: the port's
``spmd.ppermute/all_to_all/all_reduce/broadcast/sendrecv/shift`` and the
``torch.distributed`` ones (``dist.all_reduce``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``broadcast``, ``barrier``,
``all_to_all_single``, ``batch_isend_irecv`` ...). A device collective
under ``if dist.get_rank() == 0:`` hangs NCCL exactly as a host one
hangs the mailbox.
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register


def _arm_ops(graph, module: str, cls: str, arm: dict,
             cache: Dict[str, Dict[str, tuple]]
             ) -> Dict[str, List[tuple]]:
    """{op: [(line, col, via)]} for one branch arm: direct collective
    calls (host and device) plus collectives reachable through resolvable
    helper calls."""
    out: Dict[str, List[tuple]] = {}
    for op, line, col in arm["ops"]:
        out.setdefault(op, []).append((line, col, ""))
    for name, line, col in arm["calls"]:
        callee = graph.resolve_call(module, cls, name)
        if callee is None:
            continue
        if callee not in cache:
            cache[callee] = graph.collectives_reachable(callee)
        for op, (nid, path, site) in cache[callee].items():
            owner = graph.summary(nid)
            chain = " -> ".join(
                [name] + [p[0] for p in path]
                + ([owner.qualname] if owner is not None and path == []
                   and nid != callee else []))
            out.setdefault(op, []).append((line, col, chain))
    return out


@register
class DivergentCollective(Rule):
    id = "divergent-collective"
    doc = ("collective op called in one arm of an `if rank...` branch — "
           "ranks that skip the call deadlock the group (helpers are "
           "followed through the call graph)")
    hint = ("hoist the collective out of the conditional (all ranks call "
            "it); branch on rank only around the non-collective work")
    scope = "graph"

    def check_graph(self, graph):
        cache: Dict[str, Dict[str, tuple]] = {}
        for nid, s in sorted(graph.functions.items()):
            module = nid.split(":", 1)[0]
            path = graph.fn_path.get(nid, "?")
            for br in s.rank_branches:
                arms = [_arm_ops(graph, module, s.cls, arm, cache)
                        for arm in br["arms"]]
                body_ops, else_ops = set(arms[0]), set(arms[1])
                seen: Set[Tuple[int, int]] = set()
                for arm_ops in arms:
                    for op, sites in sorted(arm_ops.items()):
                        if op in body_ops and op in else_ops:
                            continue   # convergent: both arms reach it
                        for line, col, via in sites:
                            if (line, col) in seen:
                                continue
                            seen.add((line, col))
                            where = (f"collective {op}(...)"
                                     if not via else
                                     f"call reaching collective {op} "
                                     f"({via})")
                            yield Finding(
                                rule=self.id, path=path, line=line,
                                col=col,
                                message=(f"{where} inside a "
                                         "rank-dependent branch — ranks "
                                         "not taking this branch "
                                         "deadlock the group"),
                                hint=self.hint)
