"""Serve deployment graphs: handle composition + DAGDriver execution.

Reference test model: serve/tests/test_deployment_graph*.py — compose
bound deployments, run the app, assert end-to-end results through the
driver.

Port of tests/test_serve_graph.py, aimed at ray_tpu_torch.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from torch_runtime_support import (  # noqa: F401
    ray_start_regular, reap_orphans)


def test_handle_composition(ray_start_regular):
    """A bound deployment passed as an init arg arrives as a live
    DeploymentHandle (ref: deployment_graph_build.py handle injection)."""

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Tokenizer:
        def __call__(self, text):
            return text.split()

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Counter:
        def __init__(self, tokenizer):
            self.tokenizer = tokenizer

        def __call__(self, text):
            toks = ray_tpu_torch.get(self.tokenizer.remote(text))
            return len(toks)

    app = Counter.bind(Tokenizer.bind())
    assert len(app.deployments) == 2
    handle = serve.run(app)
    assert ray_tpu_torch.get(handle.remote("a b c d")) == 4
    serve.shutdown()


def test_dag_driver_chain(ray_start_regular):
    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Pre:
        def transform(self, x):
            return x + 1

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Model:
        def predict(self, x):
            return x * 10

    with serve.InputNode() as inp:
        pre = Pre.bind()
        model = Model.bind()
        out = model.predict.bind(pre.transform.bind(inp))

    app = serve.build_app(out)
    names = {d.name for d in app.deployments}
    assert names == {"DAGDriver", "Pre", "Model"}
    handle = serve.run(app)
    assert ray_tpu_torch.get(handle.remote(4)) == 50
    serve.shutdown()


def test_dag_driver_diamond_and_input_attr(ray_start_regular):
    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Left:
        def __call__(self, x):
            return x * 2

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Right:
        def __call__(self, y):
            return y + 100

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Join:
        def combine(self, a, b, scale):
            return (a + b) * scale

    with serve.InputNode() as inp:
        a = Left.bind().__call__.bind(inp["x"])
        b = Right.bind().__call__.bind(inp["y"])
        out = Join.bind().combine.bind(a, b, 3)

    handle = serve.run(serve.build_app(out))
    # ({"x":5} -> 10) + ({"y":7} -> 107) = 117; *3 = 351
    assert ray_tpu_torch.get(handle.remote({"x": 5, "y": 7})) == 351
    serve.shutdown()


def test_dag_driver_nested_containers(ray_start_regular):
    """Graph nodes nested inside list/dict args still execute
    (ref: reference DAG API supports nested structures)."""

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Sq:
        def __call__(self, x):
            return x * x

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class SumUp:
        def combine(self, parts):
            return sum(parts["values"]) + parts["bias"]

    with serve.InputNode() as inp:
        sq = Sq.bind()
        out = SumUp.bind().combine.bind(
            {"values": [sq.__call__.bind(inp), 7], "bias": 100})

    handle = serve.run(serve.build_app(out))
    assert ray_tpu_torch.get(handle.remote(3)) == 9 + 7 + 100
    serve.shutdown()


def test_shared_node_executes_once(ray_start_regular):
    """A node feeding two branches runs once per request (ref: DAG nodes
    are executed with a seen-set, not once per consumer)."""

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Counting:
        def __init__(self):
            self.calls = 0

        def tick(self, x):
            self.calls += 1
            return x + self.calls  # stateful: double-exec would diverge

        def count(self):
            return self.calls

    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class AddBoth:
        def combine(self, a, b):
            return a + b

    with serve.InputNode() as inp:
        shared = Counting.bind().tick.bind(inp)
        out = AddBoth.bind().combine.bind(shared, shared)

    handle = serve.run(serve.build_app(out))
    # one tick per request: 0+1=1 -> 1+1=2; double-exec would give 1+2=3
    assert ray_tpu_torch.get(handle.remote(0)) == 2
    serve.shutdown()


def test_bind_composition_duplicate_name_raises():
    @serve.deployment
    class Model:
        def __call__(self, x):
            return x

    @serve.deployment
    class Parent:
        def __init__(self, a, b):
            pass

    with pytest.raises(ValueError, match="share the name"):
        Parent.bind(Model.bind(), Model.bind())


def test_duplicate_deployment_name_raises():
    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Adder:
        def __call__(self, x):
            return x + 1

    with serve.InputNode() as inp:
        a = Adder.bind().__call__.bind(inp)
        b = Adder.bind().__call__.bind(a)
    with pytest.raises(ValueError, match="share the name"):
        serve.build_app(b)


def test_graph_method_typo_raises():
    @serve.deployment
    class M:
        def predict(self, x):
            return x

    app = M.bind()
    with pytest.raises(AttributeError):
        app.predicr  # typo must fail at authoring time
    assert not hasattr(app, "keys")  # no mapping duck-typing


def test_dag_driver_http_adapter(ray_start_regular):
    @serve.deployment(ray_actor_options={"num_cpus": 0.1})
    class Echo:
        def __call__(self, x):
            return x

    def adapter(request):
        return request["value"] * 2

    with serve.InputNode() as inp:
        out = Echo.bind().__call__.bind(inp)

    handle = serve.run(serve.build_app(out, http_adapter=adapter))
    assert ray_tpu_torch.get(handle.remote({"value": 21})) == 42
    serve.shutdown()
