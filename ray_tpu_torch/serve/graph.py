"""Serve deployment graphs: model composition as a DAG + DAGDriver ingress.

Reference: python/ray/serve/deployment_graph_build.py (walk a DAG of bound
deployments, emit the deployment list) and serve/drivers.py (DAGDriver —
an ingress deployment that executes the graph per request, with an
optional http adapter). Authoring mirrors the reference idiom:

    with InputNode() as inp:
        a = Preprocess.bind()
        b = Model.bind()
        out = b.predict.bind(a.transform.bind(inp))
    app = build_app(out)
    handle = serve.run(app)

The compiled graph ships to the DAGDriver replica as a pure-data spec
(deployment NAMES, not objects); the driver resolves DeploymentHandles
lazily and re-executes the spec per request. Independent branches are
submitted as soon as their inputs materialize; each stage is an async
handle call.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.api import Application, Deployment, deployment
from ray_tpu_torch.serve.handle import DeploymentHandle


class DeploymentMethodNode:
    """`app.method.bind(*args)` — one graph stage calling a deployment
    method; args may contain other nodes, InputNode markers, or literals
    (ref: serve/deployment_method_node.py)."""

    def __init__(self, app: Application, method: str, args: tuple,
                 kwargs: dict):
        self.app = app
        self.method = method
        self.args = args
        self.kwargs = kwargs


class _GraphMethod:
    def __init__(self, app: Application, name: str):
        self._app = app
        self._name = name

    def bind(self, *args, **kwargs) -> DeploymentMethodNode:
        return DeploymentMethodNode(self._app, self._name, args, kwargs)


class GraphInput:
    """Request-input placeholder (ref: dag InputNode used in serve graphs).
    `with InputNode() as inp:` — index/attr access addresses structured
    inputs."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key):
        return _GraphInputAttr(key)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _GraphInputAttr(name)


class _GraphInputAttr:
    def __init__(self, key):
        self.key = key


def _compile(node: Any, apps: Dict[str, Application]) -> dict:
    """Node -> pure-data spec; collects referenced applications."""
    if isinstance(node, DeploymentMethodNode):
        name = node.app.ingress.name
        prev = apps.setdefault(name, node.app)
        if prev.ingress is not node.app.ingress:
            raise ValueError(
                f"two distinct bound deployments share the name {name!r}; "
                "give one a .options(name=...) — merging them would route "
                "both graph stages to whichever deployed first")
        return {
            "type": "call",
            # identity key: a node shared by two downstream stages must
            # execute ONCE per request (ref: DAG nodes are walked with a
            # seen-set), even though it compiles into both branches
            "id": id(node),
            "deployment": name,
            "method": node.method,
            "args": [_compile(a, apps) for a in node.args],
            "kwargs": {k: _compile(v, apps)
                       for k, v in node.kwargs.items()},
        }
    if isinstance(node, Application):
        # a bare bound deployment as a stage input -> its handle
        name = node.ingress.name
        prev = apps.setdefault(name, node)
        if prev.ingress is not node.ingress:
            raise ValueError(
                f"two distinct bound deployments share the name {name!r}; "
                "give one a .options(name=...)")
        return {"type": "handle", "deployment": name}
    if isinstance(node, GraphInput):
        return {"type": "input"}
    if isinstance(node, _GraphInputAttr):
        return {"type": "input_attr", "key": node.key}
    if isinstance(node, (list, tuple)):
        return {"type": "list" if isinstance(node, list) else "tuple",
                "items": [_compile(x, apps) for x in node]}
    if isinstance(node, dict):
        return {"type": "dict",
                "items": {k: _compile(v, apps) for k, v in node.items()}}
    return {"type": "const", "value": node}


class DAGDriverImpl:
    """Ingress callable executing a compiled graph spec per request
    (ref: drivers.py DAGDriver.predict / __call__)."""

    def __init__(self, spec: dict, http_adapter=None):
        self.spec = spec
        self.http_adapter = http_adapter
        self._handles: Dict[str, DeploymentHandle] = {}

    def _handle(self, name: str) -> DeploymentHandle:
        if name not in self._handles:
            self._handles[name] = DeploymentHandle(name)
        return self._handles[name]

    def _run(self, spec: dict, request, memo: dict):
        t = spec["type"]
        if t == "const":
            return spec["value"]
        if t == "input":
            return request
        if t == "input_attr":
            key = spec["key"]
            if isinstance(request, dict):
                return request[key]
            if isinstance(key, int):
                return request[key]
            return getattr(request, key)
        if t == "handle":
            return self._handle(spec["deployment"])
        if t in ("list", "tuple"):
            out = self._fan(spec["items"], request, memo)
            return out if t == "list" else tuple(out)
        if t == "dict":
            keys = list(spec["items"])
            vals = self._fan([spec["items"][k] for k in keys], request, memo)
            return dict(zip(keys, vals))
        if t == "call":
            return self._call_once(spec, request, memo)
        raise ValueError(f"bad graph node type {t!r}")

    def _call_once(self, spec: dict, request, memo: dict):
        """Execute a call node exactly once per request even when it is
        shared by several downstream stages; concurrent consumers wait on
        the first executor's Future."""
        from concurrent.futures import Future

        node_id = spec["id"]
        with memo["lock"]:
            fut = memo.get(node_id)
            if fut is None:
                fut = memo[node_id] = Future()
                owner = True
            else:
                owner = False
        if not owner:
            return fut.result()
        try:
            import ray_tpu_torch

            args = self._fan(spec["args"], request, memo)
            kwargs = dict(zip(
                spec["kwargs"],
                self._fan(list(spec["kwargs"].values()), request, memo)))
            h = self._handle(spec["deployment"])
            ref = h.method(spec["method"]).remote(*args, **kwargs) \
                if spec["method"] != "__call__" else h.remote(*args, **kwargs)
            out = ray_tpu_torch.get(ref)
        except BaseException as e:
            fut.set_exception(e)
            raise
        fut.set_result(out)
        return out

    def _fan(self, specs, request, memo: dict):
        """Evaluate sibling subtrees concurrently so independent branches
        of a diamond overlap (each branch blocks on its own gets). One
        BRANCHING sibling runs inline; the others get dedicated threads —
        a bounded shared pool here can deadlock (threads blocked in
        result() on children that queue behind them) at depth under
        load, and thread spawn is cheap next to a handle round-trip."""
        import threading

        branch_idx = [i for i, s in enumerate(specs)
                      if s["type"] in ("call", "list", "tuple", "dict")]
        if len(branch_idx) < 2:
            return [self._run(s, request, memo) for s in specs]
        inline_i = branch_idx[-1]
        out: list = [None] * len(specs)
        errs: list = []
        threads = []
        for i in branch_idx[:-1]:
            def work(i=i):
                try:
                    out[i] = self._run(specs[i], request, memo)
                except BaseException as e:  # re-raised on the caller
                    errs.append(e)
            t = threading.Thread(target=work, daemon=True)
            t.start()
            threads.append(t)
        for i, s in enumerate(specs):
            if i == inline_i or i not in branch_idx:
                out[i] = self._run(s, request, memo)
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out

    def predict(self, request):
        import threading

        return self._run(self.spec, request, {"lock": threading.Lock()})

    def __call__(self, request):
        if self.http_adapter is not None:
            request = self.http_adapter(request)
        return self.predict(request)


def build_app(root: DeploymentMethodNode, *, name: str = "DAGDriver",
              http_adapter=None, num_replicas: int = 1) -> Application:
    """Compile a deployment graph into a runnable Application whose
    ingress is a DAGDriver (ref: deployment_graph_build.py build +
    drivers.py DAGDriver.bind)."""
    apps: Dict[str, Application] = {}
    spec = _compile(root, apps)
    driver = deployment(DAGDriverImpl, name=name,
                        num_replicas=num_replicas)
    driver_app = driver.bind(spec, http_adapter)
    merged: List[Deployment] = list(driver_app.deployments)
    seen: Dict[str, Deployment] = {d.name: d for d in merged}
    for app in apps.values():
        for d in app.deployments:
            prev = seen.get(d.name)
            if prev is None:
                seen[d.name] = d
                merged.append(d)
            elif prev is not d:
                raise ValueError(
                    f"two distinct bound deployments share the name "
                    f"{d.name!r}; give one a .options(name=...)")
    return Application(merged, driver_app.ingress)


# authoring alias matching the reference's import name
InputNode = GraphInput
