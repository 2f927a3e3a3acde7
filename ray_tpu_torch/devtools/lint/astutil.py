"""Shared AST helpers for raylint rules."""

from __future__ import annotations

import ast
from typing import Iterator, List

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)
ScopeNode = FuncNode + (ast.Lambda,)


def dotted_name(func: ast.AST) -> str:
    """``a.b.c`` for an Attribute chain rooted at a Name; chains rooted
    at a call/subscript/other expression get a ``?`` root (so callers can
    still match on the tail): ``foo().bar.remote`` -> ``?.bar.remote``."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("?")
    return ".".join(reversed(parts))


def walk_scope(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk ``fn``'s body without descending into nested function/lambda
    scopes (their statements belong to the inner scope)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, ScopeNode):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def is_generator(fn: ast.AST) -> bool:
    """True if ``fn`` is a generator function (own-scope yield)."""
    if not isinstance(fn, FuncNode):
        return False
    return any(isinstance(n, (ast.Yield, ast.YieldFrom))
               for n in walk_scope(fn))


def functions(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, FuncNode):
            yield node


def exception_names(handler: ast.ExceptHandler) -> List[str]:
    """Names an ``except`` clause catches; [] for a bare except."""
    t = handler.type
    if t is None:
        return []
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    out = []
    for e in elts:
        if isinstance(e, ast.Name):
            out.append(e.id)
        elif isinstance(e, ast.Attribute):
            out.append(e.attr)
    return out


def catches(handler: ast.ExceptHandler, exc: str) -> bool:
    names = exception_names(handler)
    return not names or exc in names or "BaseException" in names \
        or (exc != "BaseException" and "Exception" in names)


def enclosing_stack(tree: ast.AST, target: ast.AST) -> List[ast.AST]:
    """Ancestor chain (outermost first) of ``target`` within ``tree``;
    [] if not found. O(tree) — fine for lint-sized files."""
    path: List[ast.AST] = []

    def visit(node: ast.AST, trail: List[ast.AST]) -> bool:
        if node is target:
            path.extend(trail)
            return True
        for child in ast.iter_child_nodes(node):
            if visit(child, trail + [node]):
                return True
        return False

    visit(tree, [])
    return path


def decorator_names(fn: ast.AST) -> List[str]:
    """Dotted names of each decorator, unwrapping calls:
    ``@ray_tpu_torch.remote(num_cpus=1)`` -> ``ray_tpu_torch.remote``."""
    out = []
    for dec in getattr(fn, "decorator_list", []):
        node = dec.func if isinstance(dec, ast.Call) else dec
        out.append(dotted_name(node))
    return out


def is_remote_decorated(fn: ast.AST) -> bool:
    return any(d == "remote" or d.endswith(".remote")
               for d in decorator_names(fn))
