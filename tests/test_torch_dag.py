"""Lazy DAG semantics + compiled execution graphs (ray_tpu_torch.dag).

Reference: python/ray/dag/ (lazy) and ray.dag experimental_compile /
compiled_dag_node.py (compiled). The compiled tests drive the standing-
channel path end to end: channel negotiation at compile, raw-enqueue
execute, per-execution sequencing, typed error propagation, teardown.

Port of tests/test_dag.py, aimed at ray_tpu_torch.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.core.status import ActorDiedError
from torch_runtime_support import reap_orphans  # noqa: F401


@pytest.fixture(scope="module")
def cluster():
    # enough virtual CPUs that lazy + compiled copies of the same graph
    # (plus per-test actors that live until module teardown) all schedule
    ray_tpu_torch.init(num_cpus=16)
    yield
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class Accum:
    def __init__(self):
        self.total = 0

    def add(self, x):
        self.total += x
        return self.total

    def get(self):
        return self.total


class TestLazyDag:
    def test_diamond_branches_run_concurrently(self, cluster):
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote
        def slow_double(x):
            time.sleep(0.5)
            return 2 * x

        @ray_tpu_torch.remote
        def add(a, b):
            return a + b

        # warm the worker pool so spawn time doesn't pollute the timing
        ray_tpu_torch.get([slow_double.remote(0), slow_double.remote(0)],
                    timeout=30)
        with InputNode() as inp:
            a = slow_double.bind(inp)
            b = slow_double.bind(inp)
            c = add.bind(a, b)
        t0 = time.perf_counter()
        assert ray_tpu_torch.get(c.execute(3), timeout=30) == 12
        # serial branches would take >= 1.0 s; concurrent ~0.5 s
        assert time.perf_counter() - t0 < 0.95

    def test_actor_reused_across_executes(self, cluster):
        from ray_tpu_torch.dag import InputNode

        with InputNode() as inp:
            out = Accum.bind().add.bind(inp)
        assert ray_tpu_torch.get(out.execute(1), timeout=30) == 1
        assert ray_tpu_torch.get(out.execute(2), timeout=30) == 3  # same actor

    def test_topo_order_cached_until_rebind(self, cluster):
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote
        def ident(x):
            return x

        with InputNode() as inp:
            mid = ident.bind(inp)
            root = ident.bind(mid)
        first = root._topo_order()
        assert root._topo_order() is first          # cache hit
        assert ray_tpu_torch.get(root.execute(7), timeout=30) == 7
        mid.rebind(inp)                             # structural change
        assert root._topo_order() is not first      # cache invalidated
        assert ray_tpu_torch.get(root.execute(8), timeout=30) == 8

    def test_multi_output_node(self, cluster):
        from ray_tpu_torch.dag import InputNode, MultiOutputNode

        @ray_tpu_torch.remote
        def plus(x, n):
            return x + n

        with InputNode() as inp:
            dag = MultiOutputNode([plus.bind(inp, 1), plus.bind(inp, 2)])
        ra, rb = dag.execute(10)
        assert ray_tpu_torch.get(ra, timeout=30) == 11
        assert ray_tpu_torch.get(rb, timeout=30) == 12

    def test_mixed_input_raises_typeerror(self, cluster):
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote
        def ident(x):
            return x

        with InputNode() as inp:
            dag = ident.bind(inp)
        with pytest.raises(TypeError, match="not both"):
            dag.execute(1, k=2)

    def test_getattr_errors_name_the_node_type(self, cluster):
        from ray_tpu_torch.dag import InputNode

        with pytest.raises(AttributeError, match="InputNode"):
            InputNode()._private
        node = Accum.bind()
        with pytest.raises(AttributeError, match="ClassNode"):
            node._private


class TestCompiledDag:
    def test_compiled_matches_lazy_bitwise(self, cluster):
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote
        class Mapper:
            def scale(self, x):
                return [v * 3 for v in x]

        @ray_tpu_torch.remote
        class Reducer:
            def merge(self, a, b):
                return a + b

        def build():
            with InputNode() as inp:
                m1 = Mapper.bind().scale.bind(inp)
                m2 = Mapper.bind().scale.bind(inp)
                return Reducer.bind().merge.bind(m1, m2)

        lazy = build()
        compiled = build().experimental_compile()
        try:
            for payload in ([1, 2], [5], list(range(20))):
                want = ray_tpu_torch.get(lazy.execute(payload), timeout=30)
                got = compiled.execute(payload).get(timeout=30)
                assert got == want
        finally:
            compiled.teardown()

    def test_pipelined_executions_stay_ordered(self, cluster):
        from ray_tpu_torch.dag import InputNode

        with InputNode() as inp:
            dag = Accum.bind().add.bind(inp)
        compiled = dag.experimental_compile()
        try:
            refs = [compiled.execute(1) for _ in range(30)]  # all in flight
            results = [r.get(timeout=30) for r in refs]
            assert results == list(range(1, 31))  # strict seq order
        finally:
            compiled.teardown()

    def test_error_poisons_only_its_sequence(self, cluster):
        from ray_tpu_torch.dag import InputNode

        @ray_tpu_torch.remote
        class Picky:
            def check(self, x):
                if x < 0:
                    raise ValueError(f"negative: {x}")
                return x * 10

        with InputNode() as inp:
            dag = Picky.bind().check.bind(inp)
        compiled = dag.experimental_compile()
        try:
            good1 = compiled.execute(1)
            bad = compiled.execute(-5)
            good2 = compiled.execute(2)
            assert good1.get(timeout=30) == 10
            with pytest.raises(ValueError, match="negative"):
                bad.get(timeout=30)
            assert good2.get(timeout=30) == 20   # later seq unaffected
        finally:
            compiled.teardown()

    def test_teardown_releases_channels_and_guards_execute(self, cluster):
        from ray_tpu_torch.core import runtime as rtmod
        from ray_tpu_torch.dag import InputNode

        with InputNode() as inp:
            dag = Accum.bind().add.bind(inp)
        compiled = dag.experimental_compile()
        assert compiled.execute(5).get(timeout=30) == 5
        rt = rtmod.get_runtime()
        assert rt._channel_sinks          # sink registered while live
        compiled.teardown()
        assert not rt._channel_sinks      # released
        with pytest.raises(RuntimeError, match="torn down"):
            compiled.execute(1)
        # the ClassNode recovers: lazy execution re-creates the actor
        assert ray_tpu_torch.get(dag.execute(4), timeout=30) == 4

    def test_actor_killed_mid_execute_raises_actor_died(self, cluster):
        from ray_tpu_torch.dag import InputNode, bind_actor

        @ray_tpu_torch.remote
        class Sleeper:
            def nap(self, s):
                time.sleep(s)
                return s

        handle = Sleeper.remote()
        ray_tpu_torch.get(handle.nap.remote(0), timeout=30)   # wait until alive
        with InputNode() as inp:
            dag = bind_actor(handle).nap.bind(inp)
        compiled = dag.experimental_compile()
        try:
            ref = compiled.execute(30)
            time.sleep(0.3)                 # let the frame reach the lane
            ray_tpu_torch.kill(handle)
            with pytest.raises(ActorDiedError):
                ref.get(timeout=30)
        finally:
            compiled.teardown()
