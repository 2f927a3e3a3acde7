"""pep479-stopiteration: StopIteration escaping a generator body.

Since PEP 479 (Python 3.7), a StopIteration raised inside a generator —
whether explicitly or by an unguarded ``next()`` — is converted to
RuntimeError instead of ending iteration. The PR-1 collective broadcast
bug was exactly this: a bare ``next()`` over ragged per-rank iterators
took down the whole broadcast with RuntimeError when one rank drained
early.

Flags, inside generator functions only:
- ``raise StopIteration``: always wrong; ``return`` ends a generator.
- single-argument ``next(it)`` not wrapped in a ``try`` that catches
  StopIteration (two-arg ``next(it, default)`` never raises).
"""

from __future__ import annotations

import ast

from ray_tpu_torch.devtools.lint.astutil import (catches, enclosing_stack,
                                                 is_generator, walk_scope)
from ray_tpu_torch.devtools.lint.findings import Finding
from ray_tpu_torch.devtools.lint.registry import Rule, register


def _guarded(tree: ast.AST, fn: ast.AST, call: ast.Call) -> bool:
    """True if ``call`` sits in a try whose handlers catch StopIteration
    (within the generator's own scope — an outer try can't help)."""
    stack = enclosing_stack(tree, call)
    if fn in stack:
        stack = stack[stack.index(fn) + 1:]
    for anc in stack:
        if isinstance(anc, ast.Try):
            if any(catches(h, "StopIteration") for h in anc.handlers):
                return True
    return False


@register
class Pep479StopIteration(Rule):
    id = "pep479-stopiteration"
    doc = ("bare next()/raise StopIteration inside a generator becomes "
           "RuntimeError under PEP 479")
    hint = ("use `return` to end the generator; wrap next() in "
            "try/except StopIteration or pass a default")

    def check(self, parsed):
        for fn in ast.walk(parsed.tree):
            if not is_generator(fn):
                continue
            for node in walk_scope(fn):
                if isinstance(node, ast.Raise) and node.exc is not None:
                    exc = node.exc
                    name = exc.func if isinstance(exc, ast.Call) else exc
                    if isinstance(name, ast.Name) and \
                            name.id == "StopIteration":
                        yield Finding(
                            rule=self.id, path=parsed.path,
                            line=node.lineno, col=node.col_offset,
                            message=f"raise StopIteration inside generator "
                                    f"{fn.name} becomes RuntimeError "
                                    "(PEP 479)",
                            hint="use a plain `return` to end the generator")
                elif (isinstance(node, ast.Call)
                      and isinstance(node.func, ast.Name)
                      and node.func.id == "next"
                      and len(node.args) == 1 and not node.keywords
                      and not _guarded(parsed.tree, fn, node)):
                    yield Finding(
                        rule=self.id, path=parsed.path,
                        line=node.lineno, col=node.col_offset,
                        message=f"unguarded next() inside generator "
                                f"{fn.name}: an exhausted iterator raises "
                                "StopIteration -> RuntimeError (PEP 479)",
                        hint="wrap in try/except StopIteration, or use "
                             "next(it, sentinel)")
