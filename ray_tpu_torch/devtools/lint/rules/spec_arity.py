"""spec-arity: sharded-call in/out specs must match the wrapped fn.

The port's ``sharded_jit(in_specs=..., out_specs=...)`` runs its body
under ``local_map`` over the resolved mesh (parallel/presets.py): one
spec per positional argument, zipped against the call's arguments. A
3-spec tuple over a 2-argument function raises (``presets.py``'s count
check) — but only when the function is called under a bound mesh, long
after the CPU tests that never bound one passed. The out_specs side is
worse: a tuple out_specs against a non-tuple return (or the wrong tuple
width) wraps the wrong local results as DTensors.

Only literal tuple/list specs are checked (a variable or single spec is
recorded as arity -1 and skipped), and functions taking ``*args`` are
exempt — the rule under-approximates rather than guess. Covers the
decorator form (``@sharded_jit(in_specs=...)`` on the function itself)
and the call forms ``_shard_map(f, mesh, in_specs, out_specs)``,
``sharded_jit(f, in_specs=..., out_specs=...)`` and ``local_map(f,
out_placements=..., in_placements=...)`` (a tuple of per-input
placements in; a tuple of per-output placements out, where a list is
one output's), with the target resolved through the project call graph.
"""

from __future__ import annotations

from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register


def _pos_range(params):
    """(min, max) acceptable spec count for a params record, accounting
    for a leading self/cls; (None, None) when *args makes it unknowable."""
    n_pos, n_required, has_varargs, first = params
    if has_varargs:
        return None, None
    skip = 1 if first in ("self", "cls") else 0
    return max(0, n_required - skip), max(0, n_pos - skip)


@register
class SpecArity(Rule):
    id = "spec-arity"
    doc = ("sharded_jit/_shard_map/local_map in_specs arity disagrees "
           "with the wrapped function's signature (or out_specs with its "
           "return arity) — fails only once a real mesh attaches")
    hint = ("give every mapped positional argument exactly one spec in "
            "in_specs, and match out_specs to the returned tuple shape")
    scope = "graph"

    def check_graph(self, graph):
        for nid, s in sorted(graph.functions.items()):
            module = nid.split(":", 1)[0]
            path = graph.fn_path.get(nid, "?")
            sp = s.spmd or {}

            jd = sp.get("jit")
            if jd and jd.get("kind") == "sharded_jit":
                yield from self._compare(
                    path, jd["line"], f"@{jd['kind']} on {s.qualname}",
                    jd.get("in_arity", -1), jd.get("out_arity", -1),
                    sp.get("params"), sp.get("returns", -1))

            for kind, target, line, in_a, out_a in sp.get("jit_wraps", []):
                if in_a < 0 and out_a < 0:
                    continue
                callee = graph.resolve_call(module, s.cls, target)
                if callee is None:
                    continue
                cs = graph.functions.get(callee)
                if cs is None:
                    continue
                csp = cs.spmd or {}
                yield from self._compare(
                    path, line, f"{kind}({target}, ...)",
                    in_a, out_a, csp.get("params"),
                    csp.get("returns", -1))

    def _compare(self, path, line, what, in_a, out_a, params, returns):
        if params is None:
            return
        lo, hi = _pos_range(params)
        facts = {"in_specs": in_a, "out_specs": out_a,
                 "params": list(params), "returns": returns}
        if in_a >= 0 and lo is not None and not (lo <= in_a <= hi):
            takes = str(hi) if lo == hi else f"{lo}..{hi}"
            yield Finding(
                rule=self.id, path=path, line=line, col=0,
                message=(f"{what}: in_specs has {in_a} spec(s) but the "
                         f"wrapped function takes {takes} positional "
                         "argument(s)"),
                hint=self.hint, spmd=facts)
        if out_a >= 0 and returns >= 0 and out_a != returns:
            yield Finding(
                rule=self.id, path=path, line=line, col=0,
                message=(f"{what}: out_specs has {out_a} spec(s) but "
                         f"the wrapped function returns a "
                         f"{returns}-tuple"),
                hint=self.hint, spmd=facts)
