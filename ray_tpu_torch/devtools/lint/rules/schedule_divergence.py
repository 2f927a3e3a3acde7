"""collective-schedule-divergence: rank arms order collectives alike.

The existing divergent-collective rule is set-based: an op reached from
*both* arms of an ``if rank...`` branch is convergent and stays clean.
That misses the ordering deadlock — two arms that each reach the same
rendezvous set but in a different order:

    if rank == 0:
        col.allreduce(g, "grads")   # rank 0 waits in allreduce...
        col.barrier("grads")
    else:
        col.barrier("grads")        # ...while everyone else waits in
        col.allreduce(g, "grads")   # barrier. Nobody moves.

This rule linearizes each arm's collective schedule — host collectives
*and* device collectives (the port's ``spmd`` exchanges, with the axis
of a literal ``Axis.of(mesh, "x")``, and ``torch.distributed``'s), with
resolvable helper calls inlined through the project call graph — and
requires the (op, axis/group) token sequences to agree (an axis the
extract could not read matches any). It fires only when the arms'
op-kind sets already match (otherwise divergent-collective owns the
finding), so the two rules partition the failure space instead of
double-reporting.
"""

from __future__ import annotations

from typing import List, Tuple

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register


def _same(a: List[Tuple[str, str]], b: List[Tuple[str, str]]) -> bool:
    """Token sequences agree: the same ops in the same order, on the same
    axis or group where both name one. An axis the extract could not read
    ('': an ``Axis`` passed in as a parameter, a group built at run time)
    matches any — the rule under-approximates rather than guess."""
    return len(a) == len(b) and all(
        op_a == op_b and (ax_a == ax_b or not ax_a or not ax_b)
        for (op_a, ax_a), (op_b, ax_b) in zip(a, b))


def _render(sched: List[Tuple[str, str]]) -> str:
    if not sched:
        return "(no collectives)"
    return " -> ".join(f"{op}[{ax}]" if ax else op for op, ax in sched)


@register
class CollectiveScheduleDivergence(Rule):
    id = "collective-schedule-divergence"
    doc = ("rank-conditional arms issue the same collectives in a "
           "different order (or against different axes/groups) — every "
           "rank blocks in a different rendezvous and the group wedges")
    hint = ("make both arms issue collectives in one order — hoist the "
            "shared tail out of the conditional, or reorder one arm")
    scope = "graph"

    def check_graph(self, graph):
        for nid, s in sorted(graph.functions.items()):
            module = nid.split(":", 1)[0]
            path = graph.fn_path.get(nid, "?")
            for br in (s.spmd or {}).get("rank_scheds", []):
                arms = [graph.linearize_events(module, s.cls, a)
                        for a in br["arms"]]
                a, b = arms
                if _same(a, b):
                    continue
                # different op-kind sets: divergent-collective territory
                if {op for op, _ in a} != {op for op, _ in b}:
                    continue
                yield Finding(
                    rule=self.id, path=path, line=br["line"], col=0,
                    message=("rank arms disagree on collective order: "
                             f"the true arm runs {_render(a)} but the "
                             f"other arm runs {_render(b)} — same "
                             "rendezvous set, different order, so each "
                             "rank blocks in a different collective"),
                    hint=self.hint,
                    spmd={"schedule_true": [list(t) for t in a],
                          "schedule_false": [list(t) for t in b]})
