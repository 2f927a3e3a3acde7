"""DAG node types.

Reference: python/ray/dag/dag_node.py:23 (DAGNode: bound args + traversal +
execute), input_node.py (InputNode context manager + attribute access),
function_node.py / class_node.py (task and actor-method nodes).

Execution model: `execute(*args)` walks the DAG bottom-up once per call,
replacing child nodes with the ObjectRefs of their `.remote()` submissions —
so a diamond DAG runs its independent branches concurrently for free (refs
flow, nothing blocks until the final `ray_tpu_torch.get`). Actor nodes
(`ClassNode`) instantiate their actor lazily on first execute and reuse it
after, matching the reference's stateful-node semantics.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

# Structure generation: bumped on any rebind() anywhere, so cached
# topological orders (kept per root node) invalidate without every node
# needing a back-pointer to the roots that traversed it.
_struct_gen = 0


def _bump_struct_gen() -> None:
    global _struct_gen
    _struct_gen += 1


class DAGNode:
    """Base: immutable bound (args, kwargs); children are nested DAGNodes."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._topo_cache: Optional[Tuple[int, List["DAGNode"]]] = None

    # -- traversal ------------------------------------------------------------

    def _children(self) -> List["DAGNode"]:
        out: List[DAGNode] = []

        def scan(v):
            if isinstance(v, DAGNode):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    scan(x)
            elif isinstance(v, dict):
                for x in v.values():
                    scan(x)

        for a in self._bound_args:
            scan(a)
        for a in self._bound_kwargs.values():
            scan(a)
        return out

    def _walk(self, seen: Optional[set] = None) -> List["DAGNode"]:
        """Post-order unique traversal."""
        if seen is None:
            seen = set()
        out = []
        for c in self._children():
            if id(c) not in seen:
                seen.add(id(c))
                out.extend(c._walk(seen))
                out.append(c)
        return out

    def _topo_order(self) -> List["DAGNode"]:
        """Topological order ending at self, cached on this root; the walk
        reruns only after a rebind() somewhere in the graph."""
        cached = self.__dict__.get("_topo_cache")
        if cached is not None and cached[0] == _struct_gen:
            return cached[1]
        order = self._walk() + [self]
        self._topo_cache = (_struct_gen, order)
        return order

    def rebind(self, *args, **kwargs) -> "DAGNode":
        """Replace this node's bound arguments in place. Invalidates every
        cached topological order (structure may have changed)."""
        self._bound_args = args
        self._bound_kwargs = kwargs
        _bump_struct_gen()
        return self

    # -- execution ------------------------------------------------------------

    def execute(self, *input_args, **input_kwargs):
        """Run the DAG; returns ObjectRef(s) for the root node
        (ref: DAGNode.execute)."""
        cache: Dict[int, Any] = {}
        for node in self._topo_order():
            cache[id(node)] = node._execute_impl(
                lambda v: _resolve(v, cache), input_args, input_kwargs)
        return cache[id(self)]

    def experimental_compile(self, *, resolve_timeout: Optional[float] = 60.0):
        """Compile this bound DAG into a CompiledDAG driving standing
        channels — see dag/compiled.py."""
        from ray_tpu_torch.dag.compiled import CompiledDAG

        return CompiledDAG(self, resolve_timeout=resolve_timeout)

    def _execute_impl(self, resolve, input_args, input_kwargs):
        raise NotImplementedError

    def _resolved_args(self, resolve):
        args = tuple(resolve(a) for a in self._bound_args)
        kwargs = {k: resolve(v) for k, v in self._bound_kwargs.items()}
        return args, kwargs


def _resolve(v, cache):
    if isinstance(v, DAGNode):
        return cache[id(v)]
    if isinstance(v, list):
        return [_resolve(x, cache) for x in v]
    if isinstance(v, tuple):
        return tuple(_resolve(x, cache) for x in v)
    if isinstance(v, dict):
        return {k: _resolve(x, cache) for k, x in v.items()}
    return v


class InputNode(DAGNode):
    """DAG input placeholder (ref: dag/input_node.py). Usable as a context
    manager for the `with InputNode() as inp:` authoring idiom."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key) -> "InputAttributeNode":
        return InputAttributeNode(self, key)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(
                f"InputNode has no attribute {name!r} (underscore names "
                "never become InputAttributeNodes)")
        return InputAttributeNode(self, name)

    def _execute_impl(self, resolve, input_args, input_kwargs):
        if input_args and input_kwargs:
            raise TypeError(
                "DAG execute() accepts positional OR keyword inputs, not both "
                "(an InputAttributeNode cannot address a mixed input)")
        if len(input_args) == 1 and not input_kwargs:
            return input_args[0]
        if input_kwargs and not input_args:
            return input_kwargs
        return input_args

    def __repr__(self):
        return "InputNode()"


class InputAttributeNode(DAGNode):
    """inp[0] / inp.key access on the DAG input."""

    def __init__(self, parent: InputNode, key):
        super().__init__((parent,), {})
        self._key = key

    def _execute_impl(self, resolve, input_args, input_kwargs):
        base = resolve(self._bound_args[0])
        if isinstance(base, dict):
            return base[self._key]
        if isinstance(self._key, int):
            return base[self._key]
        return getattr(base, self._key)

    def __repr__(self):
        return f"InputAttributeNode({self._key!r})"


class FunctionNode(DAGNode):
    """A bound remote-function invocation (ref: dag/function_node.py)."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_fn

    def _execute_impl(self, resolve, input_args, input_kwargs):
        args, kwargs = self._resolved_args(resolve)
        return self._fn.remote(*args, **kwargs)

    def __repr__(self):
        name = getattr(getattr(self._fn, "_fn", None), "__name__", "fn")
        return f"FunctionNode({name})"


class ClassNode(DAGNode):
    """A bound actor construction; instantiated once, reused across executes
    (ref: dag/class_node.py)."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_cls = actor_cls
        self._handle = None
        self._external = False  # bind_actor: caller owns the lifecycle
        self._lock = threading.Lock()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(
                f"ClassNode has no attribute {name!r} (underscore names "
                "never bind as actor methods)")
        return _UnboundMethod(self, name)

    def _get_handle(self, resolve):
        with self._lock:
            if self._handle is None:
                args, kwargs = self._resolved_args(resolve)
                self._handle = self._actor_cls.remote(*args, **kwargs)
            return self._handle

    def _execute_impl(self, resolve, input_args, input_kwargs):
        return self._get_handle(resolve)

    def __repr__(self):
        name = getattr(getattr(self._actor_cls, "_cls", None), "__name__", "Actor")
        return f"ClassNode({name})"


class _UnboundMethod:
    def __init__(self, class_node: ClassNode, name: str):
        self._class_node = class_node
        self._name = name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._name, args, kwargs)


class ClassMethodNode(DAGNode):
    """actor_node.method.bind(...) — method call on a ClassNode's actor."""

    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__(args, kwargs)
        self._class_node = class_node
        self._method = method

    def _children(self):
        return [self._class_node] + super()._children()

    def _execute_impl(self, resolve, input_args, input_kwargs):
        handle = resolve(self._class_node)
        args, kwargs = self._resolved_args(resolve)
        return getattr(handle, self._method).remote(*args, **kwargs)

    def __repr__(self):
        return f"ClassMethodNode(.{self._method})"


def bind_actor(handle) -> ClassNode:
    """Wrap an already-running actor's handle as a ClassNode, so a graph
    can route through externally-owned actors (e.g. serve replicas). The
    compiled layer never kills these at teardown."""
    node = ClassNode(None, (), {})
    node._handle = handle
    node._external = True
    return node


class MultiOutputNode(DAGNode):
    """Aggregates several leaves into one execute() result
    (ref: dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__((list(outputs),), {})

    def _execute_impl(self, resolve, input_args, input_kwargs):
        return resolve(self._bound_args[0])

    def __repr__(self):
        return f"MultiOutputNode({len(self._bound_args[0])})"
