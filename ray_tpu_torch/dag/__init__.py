"""Lazy task/actor DAGs: `.bind()` builds, `.execute()` runs — and
`.experimental_compile()` takes a static DAG out of the dispatch path.

Reference: python/ray/dag/ (DAGNode at dag/dag_node.py:23, InputNode,
function_node.py, class_node.py; compiled graphs per the aDAG layer).
Used by Serve deployment graphs the same way the reference's
pre-compiled-graph era DAGs are; compiled graphs drive the LLM router's
stream-frame hop and the data executor's fixed operator chains.
"""

from ray_tpu_torch.dag.dag_node import (ClassMethodNode, ClassNode, DAGNode,
                                  FunctionNode, InputAttributeNode, InputNode,
                                  MultiOutputNode, bind_actor)


def __getattr__(name):
    # compiled pulls in core.runtime; import lazily so `import ray_tpu_torch.dag`
    # stays cheap for authoring-only users
    if name in ("CompiledDAG", "CompiledDAGRef"):
        from ray_tpu_torch.dag import compiled

        return getattr(compiled, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode", "InputNode",
    "InputAttributeNode", "MultiOutputNode", "bind_actor", "CompiledDAG",
    "CompiledDAGRef",
]
