"""large-closure-capture: remote fns closing over module-level arrays.

A remote function (or actor method) that references a module-level
ndarray / torch tensor serializes that array into the function's
closure, shipping it with EVERY task submission — and for CUDA tensors
forces a D2H copy per pickle. The fix is to ``put()`` the array once
and pass the ref, pass it as an argument, or construct it inside the
task.

Detection is two-phase per file: collect module-level names assigned
from numpy/torch (or jax) array factories, then flag Name loads of
those inside ``@remote``-decorated functions and methods of ``@remote``
classes.
"""

from __future__ import annotations

import ast

from ray_tpu_torch.devtools.lint.astutil import (FuncNode, dotted_name,
                                                 is_remote_decorated,
                                                 walk_scope)
from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register

_ARRAY_ROOTS = {"np", "jnp", "numpy", "jax", "torch"}
_FACTORIES = {
    "tensor", "as_tensor", "from_numpy",     # torch's own constructors
    "array", "asarray", "ones", "zeros", "full", "empty", "arange",
    "linspace", "eye", "identity", "rand", "randn", "normal", "uniform",
    "randint", "ones_like", "zeros_like", "full_like", "load", "loadtxt",
}


def _is_array_expr(value: ast.AST) -> bool:
    for sub in ast.walk(value):
        if isinstance(sub, ast.Call):
            name = dotted_name(sub.func)
            parts = name.split(".")
            if parts[0] in _ARRAY_ROOTS and parts[-1] in _FACTORIES:
                return True
    return False


def _module_array_consts(tree: ast.Module) -> dict:
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            target, value = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) and node.value:
            target, value = node.target.id, node.value
        else:
            continue
        if _is_array_expr(value):
            consts[target] = node.lineno
    return consts


@register
class LargeClosureCapture(Rule):
    id = "large-closure-capture"
    doc = ("remote fn/actor method closes over a module-level ndarray — "
           "the array is reserialized into every task submission")
    hint = ("put() the array once and pass the ObjectRef, pass it as an "
            "argument, or build it inside the task")

    def check(self, parsed):
        consts = _module_array_consts(parsed.tree)
        if not consts:
            return
        remote_fns = []
        for node in ast.walk(parsed.tree):
            if isinstance(node, FuncNode) and is_remote_decorated(node):
                remote_fns.append(node)
            elif isinstance(node, ast.ClassDef) \
                    and is_remote_decorated(node):
                remote_fns.extend(n for n in node.body
                                  if isinstance(n, FuncNode))
        for fn in remote_fns:
            # shadowed names are the function's own, not captures
            local = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
            for sub in walk_scope(fn):
                if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in targets:
                        if isinstance(t, ast.Name):
                            local.add(t.id)
            for sub in walk_scope(fn):
                if isinstance(sub, ast.Name) \
                        and isinstance(sub.ctx, ast.Load) \
                        and sub.id in consts and sub.id not in local:
                    yield Finding(
                        rule=self.id, path=parsed.path,
                        line=sub.lineno, col=sub.col_offset,
                        message=f"remote {fn.name} captures module-level "
                                f"array {sub.id!r} (defined line "
                                f"{consts[sub.id]}) in its closure — "
                                "serialized per task",
                        hint=self.hint)
