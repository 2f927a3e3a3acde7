"""hardcoded-group-name: elastic re-form paths must not pin group names.

Elastic remediation re-forms collective groups under a generation-
suffixed name (``collective.generation_name("train", 2)`` ->
``"train@g2"``) precisely so that stragglers from the old gang cannot
rendezvous with the new one. A call reachable from a re-form path that
passes a *literal* group name bypasses that: after the first
remediation it targets the generation-0 group, which no longer exists —
the op blocks until the collective timeout and the freshly healed gang
wedges again.

Roots are functions that look like elastic/remediation entry points
(module or qualname mentioning elastic/reform/remediate); from each
root the rule walks the call graph and flags any literal group-name
argument on a host-collective call. Names built dynamically —
f-strings, variables, ``generation_name(...)`` results — are invisible
to the extract by construction, so they never fire.
"""

from __future__ import annotations

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register

_ROOT_WORDS = ("elastic", "reform", "remediat")


def _is_elastic_root(nid: str, s) -> bool:
    module = nid.split(":", 1)[0].lower()
    qual = s.qualname.lower()
    return any(w in module for w in _ROOT_WORDS) \
        or any(w in qual for w in _ROOT_WORDS) \
        or "elastic" in (s.cls or "").lower()


@register
class HardcodedGroupName(Rule):
    id = "hardcoded-group-name"
    doc = ("literal collective group name reachable from an elastic "
           "re-form path — re-formed groups are generation-suffixed, so "
           "the hardcoded name targets a group that no longer exists")
    hint = ("thread the group name through from the caller and build it "
            "with collective.generation_name(group, generation)")
    scope = "graph"

    def check_graph(self, graph):
        reported = set()
        for nid, s in sorted(graph.functions.items()):
            if not _is_elastic_root(nid, s):
                continue
            for reach_nid, _path in graph.reach(nid):
                rs = graph.functions.get(reach_nid)
                if rs is None:
                    continue
                for op, name, line, col in (rs.spmd or {}).get(
                        "group_literals", []):
                    site = (reach_nid, line, col)
                    if site in reported:
                        continue
                    reported.add(site)
                    via = "" if reach_nid == nid else \
                        f" (reached from {s.qualname})"
                    yield Finding(
                        rule=self.id,
                        path=graph.fn_path.get(reach_nid, "?"),
                        line=line, col=col,
                        message=(f"{op}(...) uses hardcoded group name "
                                 f"{name!r} on an elastic re-form path"
                                 f"{via} — after remediation the live "
                                 "group is generation-suffixed and this "
                                 "call targets the dead one"),
                        hint=self.hint,
                        spmd={"group": name, "op": op,
                              "elastic_root": s.qualname})
