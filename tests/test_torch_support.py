"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

``import ray_tpu`` fails on Python >= 3.11 (``RpcTimeout``'s duplicate
``TimeoutError`` base at ray_tpu/core/rpc.py:92), so the JAX reference is
loaded through stub parent packages: ``types.ModuleType`` objects with
``__path__`` set for ``ray_tpu``, ``ray_tpu.serve``, ``ray_tpu.util``,
``ray_tpu.observability``, ``ray_tpu.data`` and ``ray_tpu.rl``, plus a
no-op ``ray_tpu.util.metrics``. The stub ``ray_tpu`` runs in local mode:
its ``remote`` wraps a class so that ``.options(**kw).remote(...)`` builds
the instance in this process and each method's ``.remote(...)`` runs the
call at once and returns a ref holding its value (``.id.binary()`` as an
ObjectRef's), ``get`` unwraps refs (anything else passes through),
``wait`` returns the first ``num_returns`` refs in the order given (every
call has already finished: the order a FIFO runtime would give) and
``kill`` does nothing, so the reference's RL trainers run wholly in the
test process on CPU JAX; on a function, ``remote`` gives one whose
``.remote(...)`` calls it at once (the workflow's steps). The
stubs (and ``ray_tpu.core.runtime``, reduced to the two functions the
serializer needs, see ``_runtime_stub``) live in ``sys.modules`` only
inside ``jax_reference()``: on exit every
``ray_tpu*`` entry is put back as it was, because xdist's ``loadfile``
runs other test files in the same worker process and they must see the
real package. The loaded reference modules are kept between uses and
re-inserted on entry, so their lazy imports resolve to the same objects.

The tests in this file check that helper itself.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
_STUB_PACKAGES = ("ray_tpu", "ray_tpu.serve", "ray_tpu.util",
                  "ray_tpu.observability", "ray_tpu.data", "ray_tpu.rl")
_REFERENCE_MODULES = ("ray_tpu.models.llama", "ray_tpu.models.gpt2",
                      "ray_tpu.models.moe", "ray_tpu.models.vit",
                      "ray_tpu.models.registry",
                      "ray_tpu.ops.ring_attention", "ray_tpu.ops.ulysses",
                      "ray_tpu.parallel.pipeline",
                      "ray_tpu.ops.paged_attention",
                      "ray_tpu.ops.flash_attention", "ray_tpu.serve.llm",
                      "ray_tpu.serve.paged_kv", "ray_tpu.serve.kv_transfer",
                      "ray_tpu.parallel.train_step",
                      # runtime modules that load without core/rpc.py
                      "ray_tpu.core.ids", "ray_tpu.core.config",
                      "ray_tpu.core.serialization",
                      "ray_tpu.core.scheduling_policy",
                      # the data layer's modules (numpy; the runtime is
                      # imported only inside their remote paths)
                      "ray_tpu.data.dataset", "ray_tpu.data.aggregate",
                      "ray_tpu.data.grouped", "ray_tpu.data.preprocessors",
                      "ray_tpu.data.execution.interfaces",
                      "ray_tpu.data.execution.resource_manager",
                      # the RL layer's core and on-policy family, over the
                      # stub's local-mode remote/get/kill
                      "ray_tpu.rl.core", "ray_tpu.rl.connectors",
                      "ray_tpu.rl.pixel_env", "ray_tpu.rl.vision",
                      "ray_tpu.rl.ppo", "ray_tpu.rl.learner",
                      "ray_tpu.rl.impala", "ray_tpu.rl.multi_agent",
                      "ray_tpu.rl.pg", "ray_tpu.rl.a2c", "ray_tpu.rl.a3c",
                      "ray_tpu.rl.appo", "ray_tpu.rl.ddppo",
                      # the off-policy, offline and gradient-free ones
                      "ray_tpu.rl.dqn", "ray_tpu.rl.simple_q",
                      "ray_tpu.rl.td3", "ray_tpu.rl.ddpg", "ray_tpu.rl.apex",
                      "ray_tpu.rl.r2d2", "ray_tpu.rl.sac",
                      "ray_tpu.rl.offline", "ray_tpu.rl.marwil",
                      "ray_tpu.rl.dt", "ray_tpu.rl.es", "ray_tpu.rl.bandit")
_RL_NEW = ("dqn", "simple_q", "td3", "ddpg", "apex", "r2d2", "sac",
           "offline", "marwil", "dt", "es", "bandit")
# Reference modules that only some test files use, by group: each loads
# on the first ``jax_reference(group)``, so that no other file's first
# ``jax_reference()`` grows. A group's stub packages keep the package's
# own __init__ from running (ray_tpu/tune/__init__.py imports the tuner).
_GROUPS = {
    # the multi-agent, meta-learning, planning and recommender RL modules
    "rl_final": ("ray_tpu.rl.slateq", "ray_tpu.rl.qmix",
                 "ray_tpu.rl.maddpg", "ray_tpu.rl.alpha_zero",
                 "ray_tpu.rl.maml"),
    # tune's search, schedulers and loggers (no runtime at module level)
    "tune": ("ray_tpu.tune.search", "ray_tpu.tune.schedulers",
             "ray_tpu.tune.loggers"),
    # the operator surface's host code (no runtime at module level; the
    # workflow's steps run through the stub's local-mode remote/get)
    "ops": ("ray_tpu.autoscaler.node_provider",
            "ray_tpu.autoscaler.autoscaler", "ray_tpu.autoscaler.launcher",
            "ray_tpu.workflow.api", "ray_tpu.dashboard.grafana",
            "ray_tpu.client_gateway", "ray_tpu.cli"),
}
_GROUP_STUBS = {"tune": ("ray_tpu.tune",),
                "ops": ("ray_tpu.autoscaler", "ray_tpu.workflow",
                        "ray_tpu.dashboard")}
_loaded: dict = {}
_loaded_groups: set = set()


def _is_ray_tpu(name: str) -> bool:
    return name == "ray_tpu" or name.startswith("ray_tpu.")


class _NoopInstrument:
    def __init__(self, *a, **k):
        pass

    def set_default_tags(self, tags):
        return self

    def observe(self, *a, **k):
        pass

    def inc(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass


def _runtime_stub():
    """``ray_tpu.core.runtime`` with only the two functions
    ``core/serialization.py`` imports from it (its pickler asks whether a
    function's module is importable by workers), compiled from the
    reference's own source: the real module imports ``core/rpc.py``."""
    import ast

    path = REPO / "ray_tpu" / "core" / "runtime.py"
    tree = ast.parse(path.read_text())
    keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("_module_is_installed", "_dumps_function")]
    m = types.ModuleType("ray_tpu.core.runtime")
    m.__file__ = str(path)
    m.cloudpickle = __import__("cloudpickle")
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"),
         m.__dict__)
    return m


class _LocalRef:
    """The finished value of a local-mode call, in an ObjectRef's place:
    hashable, ``.id.binary()`` unique."""

    _count = itertools.count()

    def __init__(self, value):
        self.value = value
        self.id = types.SimpleNamespace(
            binary=lambda n=next(_LocalRef._count): n.to_bytes(8, "big"))


class _LocalMethod:
    """An actor method whose ``.remote(...)`` calls it in process."""

    def __init__(self, fn):
        self._fn = fn

    def remote(self, *args, **kwargs):
        return _LocalRef(self._fn(*args, **kwargs))


class _LocalHandle:
    """A local-mode actor handle over the instance (``_instance``)."""

    def __init__(self, instance):
        self._instance = instance

    def __getattr__(self, name):
        return _LocalMethod(getattr(self._instance, name))


class _LocalActorClass:
    """``@ray_tpu.remote`` on a class, in local mode: ``_cls`` is the
    class, ``.options(**kw)`` ignores the options."""

    def __init__(self, cls):
        self._cls = cls

    def options(self, **kwargs):
        return self

    def remote(self, *args, **kwargs):
        return _LocalHandle(self._cls(*args, **kwargs))


class _LocalFunction:
    """``ray_tpu.remote(fn)`` on a function, in local mode:
    ``.options(**kw)`` ignores the options, ``.remote(...)`` calls ``fn``
    at once (its exception raises there) and returns a ref holding its
    value."""

    def __init__(self, fn):
        self._fn = fn

    def options(self, **kwargs):
        return self

    def remote(self, *args, **kwargs):
        return _LocalRef(self._fn(*args, **kwargs))


def _local_remote(*args, **options):
    if len(args) == 1 and isinstance(args[0], type) and not options:
        return _LocalActorClass(args[0])
    if len(args) == 1 and callable(args[0]) and not options:
        return _LocalFunction(args[0])
    return _LocalActorClass


def _local_get(refs, **kwargs):
    if isinstance(refs, (list, tuple)):
        return [_local_get(r) for r in refs]
    return refs.value if isinstance(refs, _LocalRef) else refs


def _local_wait(refs, num_returns=1, **kwargs):
    return list(refs[:num_returns]), list(refs[num_returns:])


def _install_stubs():
    for name in _STUB_PACKAGES:
        m = types.ModuleType(name)
        m.__path__ = [str(REPO / name.replace(".", "/"))]
        sys.modules[name] = m
    root = sys.modules["ray_tpu"]
    root.remote = _local_remote
    root.get = _local_get
    root.wait = _local_wait
    root.kill = lambda actor, **kwargs: None
    metrics = types.ModuleType("ray_tpu.util.metrics")
    metrics.Histogram = metrics.Counter = metrics.Gauge = _NoopInstrument
    sys.modules["ray_tpu.util.metrics"] = metrics
    sys.modules["ray_tpu.core.runtime"] = _runtime_stub()


class _Reference(types.SimpleNamespace):
    """The JAX reference modules: llama, gpt2, moe, vit, registry,
    paged_attention, flash_attention, ring_attention, ulysses, llm,
    paged_kv, kv_transfer, train_step, mesh, sharding, pipeline; of the
    runtime ids, config, serialization,
    scheduling_policy and common; of the data layer dataset, aggregate,
    grouped, preprocessors, interfaces and resource_manager; of the RL
    layer rl_core, rl_connectors, rl_pixel_env, rl_vision, rl_ppo,
    rl_learner, rl_impala, rl_multi_agent, rl_pg, rl_a2c, rl_a3c, rl_appo,
    rl_ddppo, rl_dqn, rl_simple_q, rl_td3, rl_ddpg, rl_apex, rl_r2d2,
    rl_sac, rl_offline, rl_marwil, rl_dt, rl_es and rl_bandit; and those
    of each group asked for (``_GROUPS``), named by their last two parts
    (``rl_qmix``, ``tune_search``)."""


@contextlib.contextmanager
def jax_reference(*groups):
    """Yield the JAX reference modules, and those of `groups` (keys of
    ``_GROUPS``), with their packages importable; restore every
    ``ray_tpu*`` entry of sys.modules on exit. Make every reference call
    inside the block (their lazy imports need it)."""
    import importlib

    saved = {k: v for k, v in sys.modules.items() if _is_ray_tpu(k)}
    for k in saved:
        del sys.modules[k]
    try:
        if _loaded:
            sys.modules.update(_loaded)
        else:
            _install_stubs()
            for name in _REFERENCE_MODULES:
                importlib.import_module(name)
            _loaded.update({k: v for k, v in sys.modules.items()
                            if _is_ray_tpu(k)})
        for group in groups:
            if group in _loaded_groups:
                continue
            for name in _GROUP_STUBS.get(group, ()):
                m = types.ModuleType(name)
                m.__path__ = [str(REPO / name.replace(".", "/"))]
                sys.modules[name] = m
            for name in _GROUPS[group]:
                importlib.import_module(name)
            _loaded.update({k: v for k, v in sys.modules.items()
                            if _is_ray_tpu(k)})
            _loaded_groups.add(group)
        extra = {"_".join(name.split(".")[-2:]): sys.modules[name]
                 for group in groups for name in _GROUPS[group]}
        yield _Reference(
            llama=sys.modules["ray_tpu.models.llama"],
            gpt2=sys.modules["ray_tpu.models.gpt2"],
            moe=sys.modules["ray_tpu.models.moe"],
            vit=sys.modules["ray_tpu.models.vit"],
            registry=sys.modules["ray_tpu.models.registry"],
            ring_attention=sys.modules["ray_tpu.ops.ring_attention"],
            ulysses=sys.modules["ray_tpu.ops.ulysses"],
            pipeline=sys.modules["ray_tpu.parallel.pipeline"],
            paged_attention=sys.modules["ray_tpu.ops.paged_attention"],
            # ray_tpu/ops/__init__.py rebinds the attribute to the function
            flash_attention=sys.modules["ray_tpu.ops.flash_attention"],
            llm=sys.modules["ray_tpu.serve.llm"],
            paged_kv=sys.modules["ray_tpu.serve.paged_kv"],
            kv_transfer=sys.modules["ray_tpu.serve.kv_transfer"],
            train_step=sys.modules["ray_tpu.parallel.train_step"],
            mesh=sys.modules["ray_tpu.parallel.mesh"],
            sharding=sys.modules["ray_tpu.parallel.sharding"],
            ids=sys.modules["ray_tpu.core.ids"],
            config=sys.modules["ray_tpu.core.config"],
            serialization=sys.modules["ray_tpu.core.serialization"],
            scheduling_policy=sys.modules["ray_tpu.core.scheduling_policy"],
            common=sys.modules["ray_tpu.core.common"],
            dataset=sys.modules["ray_tpu.data.dataset"],
            aggregate=sys.modules["ray_tpu.data.aggregate"],
            grouped=sys.modules["ray_tpu.data.grouped"],
            preprocessors=sys.modules["ray_tpu.data.preprocessors"],
            interfaces=sys.modules["ray_tpu.data.execution.interfaces"],
            resource_manager=sys.modules[
                "ray_tpu.data.execution.resource_manager"],
            rl_core=sys.modules["ray_tpu.rl.core"],
            rl_connectors=sys.modules["ray_tpu.rl.connectors"],
            rl_pixel_env=sys.modules["ray_tpu.rl.pixel_env"],
            rl_vision=sys.modules["ray_tpu.rl.vision"],
            rl_ppo=sys.modules["ray_tpu.rl.ppo"],
            rl_learner=sys.modules["ray_tpu.rl.learner"],
            rl_impala=sys.modules["ray_tpu.rl.impala"],
            rl_multi_agent=sys.modules["ray_tpu.rl.multi_agent"],
            rl_pg=sys.modules["ray_tpu.rl.pg"],
            rl_a2c=sys.modules["ray_tpu.rl.a2c"],
            rl_a3c=sys.modules["ray_tpu.rl.a3c"],
            rl_appo=sys.modules["ray_tpu.rl.appo"],
            rl_ddppo=sys.modules["ray_tpu.rl.ddppo"],
            **{f"rl_{m}": sys.modules[f"ray_tpu.rl.{m}"] for m in _RL_NEW},
            **extra)
    finally:
        for k in [k for k in sys.modules if _is_ray_tpu(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def flat(tree, prefix=""):
    """A nested dict of arrays as {"prefix/a/b": array}."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def unflat(arrays, prefix):
    """``flat``'s inverse for the keys under `prefix`."""
    tree = {}
    for k, v in arrays.items():
        if not k.startswith(prefix + "/"):
            continue
        node = tree
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


GANG_LOCK = "torch_rank_gangs.lock"
GANG_LOG = "torch_rank_gangs.jsonl"
# The longest a gang waits for the lock before it fails, naming the gang
# that holds it: every gang's budget together, with room.
GANG_WAIT_S = 900.0
# The one gang that holds the lock runs its ranks at this niceness, above
# the other xdist workers' tests (whose JAX and torch thread pools keep
# the host's load above its core count), so that its budget measures its
# own work. Where raising the priority is not permitted, ``nice`` says so
# on the rank's output and runs it at the parent's (each rank's times
# record the niceness it ran at).
RANK_NICE = -10


def shared_dir(d: Path) -> Path:
    """The temp dir that every worker of this pytest session shares, for
    `d`, a directory that ``tmp_path_factory.mktemp`` made: its parent is
    the process's base temp dir, which under xdist is one worker's
    (``<session base>/popen-gwN``), so the session's is one up."""
    import os

    base = Path(d).parent
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


class Ranks:
    """`world` gloo ranks, each ``python <script> RANK DIR`` (the test file
    run as a script, with the repo on its path, entering through
    ``rank_main``), joined by a ``file://`` store in DIR, a directory that
    ``tmp_path_factory.mktemp`` made.

    One gang runs at a time across every xdist worker of the session:
    ``start()`` takes an exclusive ``flock`` on GANG_LOCK in the session's
    shared temp dir (``shared_dir``) before it launches any rank, waiting
    at most GANG_WAIT_S, and ``results()`` releases it. A gang's
    budget, `timeout` seconds, runs from the moment it holds the lock to
    its last rank's exit: the gang's own time, not its wait for another
    gang nor the parent's reference computation (compute that before
    ``start()``); its ranks run at RANK_NICE where permitted.
    ``results()`` kills what is left at the deadline, appends the gang's
    times (the wait, its own time and each rank's import, rendezvous and
    run seconds, from DIR/rank{r}.times.json) as one JSON line to
    GANG_LOG beside the lock, and returns each rank's (DIR/rank{r}.npz
    arrays or {}, DIR/rank{r}.json dict), failing with the rank's output
    when one did not finish or loaded JAX."""

    def __init__(self, script, d: Path, world: int, timeout: float):
        self.script, self.d, self.world = script, Path(d), world
        self.timeout = timeout
        self.shared = shared_dir(self.d)
        self.procs = []

    def start(self):
        import fcntl
        import os
        import subprocess
        import time

        t0 = time.monotonic()
        self._lock = open(self.shared / GANG_LOCK, "a+")
        while True:
            try:
                fcntl.flock(self._lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() - t0 > GANG_WAIT_S:
                    self._lock.seek(0)
                    holder = self._lock.read()
                    self._lock.close()
                    raise TimeoutError(f"no rank-gang lock after "
                                       f"{GANG_WAIT_S} s; held by {holder}")
                time.sleep(0.2)
        self.t_lock = time.monotonic()
        self._lock.truncate(0)
        self._lock.write(f"{Path(self.script).name} (pid {os.getpid()})")
        self._lock.flush()
        self.waited_s = self.t_lock - t0
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   TEST_RANK_SPAWNED_AT=repr(time.time()))
        self.procs = [subprocess.Popen(
            ["nice", "-n", str(RANK_NICE), sys.executable, str(self.script),
             str(r), str(self.d)],
            env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(self.world)]
        return self

    def results(self):
        import fcntl
        import json
        import subprocess
        import time

        deadline = self.t_lock + self.timeout
        logs = []
        try:
            for p in self.procs:
                left = max(1.0, deadline - time.monotonic())
                try:
                    logs.append(p.communicate(timeout=left)[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0] + "\n(timed out)")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            own_s = time.monotonic() - self.t_lock
            fcntl.flock(self._lock, fcntl.LOCK_UN)
            self._lock.close()
        times = []
        for r in range(self.world):
            f = self.d / f"rank{r}.times.json"
            times.append(json.loads(f.read_text()) if f.exists() else None)
        line = {"script": Path(self.script).name, "world": self.world,
                "waited_s": round(self.waited_s, 2),
                "own_s": round(own_s, 2), "budget_s": self.timeout,
                "ranks": times}
        with open(self.shared / GANG_LOG, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), file=sys.stderr)
        for r, p in enumerate(self.procs):
            assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
            assert not times[r]["jax_loaded"], f"rank {r} loaded JAX"
        return [(dict(np.load(self.d / f"rank{r}.npz"))
                 if (self.d / f"rank{r}.npz").exists() else {},
                 json.loads((self.d / f"rank{r}.json").read_text()))
                for r in range(self.world)]

    def run(self):
        """``start()`` then ``results()``."""
        return self.start().results()


def rank_main(main):
    """A rank script's entry: ``main(RANK, DIR)`` from argv, timed into
    DIR/rank{r}.times.json: ``import_s`` from the parent's launch to this
    call (the interpreter's start and the script's imports),
    ``rendezvous_s`` inside ``torch.distributed.init_process_group``,
    ``run_s`` the rest of `main`, ``nice`` (the niceness it ran at) and
    ``jax_loaded`` (a rank must not load JAX). Then the process ends at
    once (``os._exit``): every file is written and closed, and the
    interpreter's teardown of torch, gloo and DTensor state would add
    seconds to the gang's own time."""
    import json
    import os
    import time

    import torch.distributed as dist

    t_call = time.time()
    rank, d = int(sys.argv[1]), Path(sys.argv[2])
    real, spent = dist.init_process_group, []

    def timed(*args, **kwargs):
        t = time.time()
        try:
            return real(*args, **kwargs)
        finally:
            spent.append(time.time() - t)

    dist.init_process_group = timed
    main(rank, d)
    total = time.time() - t_call
    spawned = float(os.environ.get("TEST_RANK_SPAWNED_AT", t_call))
    (d / f"rank{rank}.times.json").write_text(json.dumps({
        "import_s": round(t_call - spawned, 2),
        "rendezvous_s": round(sum(spent), 2),
        "run_s": round(total - sum(spent), 2),
        "nice": os.nice(0), "jax_loaded": "jax" in sys.modules}))
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def require_cuda():
    """Skip the calling test (marked ``cuda``) when there is no card. Called
    inside the test, never at import, so every xdist worker collects the
    same tests."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernel has no CPU or interpret mode")


def jax_tree_to_np(tree):
    """A JAX param pytree (nested dicts) as numpy arrays."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_np(v) for k, v in tree.items()}
    return np.asarray(tree)


def to_np(x):
    """A JAX array or torch tensor as a float64/int numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        if x.is_floating_point():
            x = x.double()
        return x.numpy()
    return np.asarray(x)


def test_reference_stubs_are_removed_after_use():
    pytest.importorskip("jax")
    before = {k: v for k, v in sys.modules.items() if _is_ray_tpu(k)}
    with jax_reference() as ref:
        assert ref.llama.PRESETS["tiny"].d_model == 64
        assert callable(ref.flash_attention._flash_fwd_loop)
    after = {k: v for k, v in sys.modules.items() if _is_ray_tpu(k)}
    assert after == before


def test_reference_reentry_reuses_loaded_modules():
    pytest.importorskip("jax")
    with jax_reference() as a:
        first = a.llama
    with jax_reference() as b:
        assert b.llama is first
        assert sys.modules["ray_tpu.models.llama"] is first
