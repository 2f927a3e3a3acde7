"""serve public API: @deployment, run, shutdown, handles.

Reference: python/ray/serve/api.py:242 (@serve.deployment), :414 (serve.run).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.serve.handle import DeploymentHandle

CONTROLLER_NAME = "_serve_controller"
_NAMESPACE = "serve"


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    max_concurrent_queries: int = 100
    user_config: Any = None
    autoscaling_config: Optional[dict] = None
    model_autoscaling_config: Optional[dict] = None
    ray_actor_options: Optional[dict] = None
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)

    def bind(self, *args, **kwargs) -> "Application":
        d = Deployment(self.func_or_class, self.name, self.num_replicas,
                       self.max_concurrent_queries, self.user_config,
                       self.autoscaling_config, self.model_autoscaling_config,
                       self.ray_actor_options, args, kwargs)
        # Composition (ref: deployment_graph_build.py): nested bound
        # deployments in the init args join this application's deployment
        # list; serve.run turns them into handles at deploy time.
        deps = [d]
        seen = {d.name: d}
        for v in _flatten_values(args, kwargs):
            if isinstance(v, Application):
                for child in v.deployments:
                    prev = seen.get(child.name)
                    if prev is None:
                        seen[child.name] = child
                        deps.append(child)
                    elif prev is not child:
                        raise ValueError(
                            f"two distinct bound deployments share the "
                            f"name {child.name!r}; give one a "
                            ".options(name=...) — merging would route "
                            "both handles to whichever deployed first")
        return Application(deps, d)

    def options(self, **kw) -> "Deployment":
        d = Deployment(self.func_or_class, kw.pop("name", self.name),
                       kw.pop("num_replicas", self.num_replicas),
                       kw.pop("max_concurrent_queries",
                              self.max_concurrent_queries),
                       kw.pop("user_config", self.user_config),
                       kw.pop("autoscaling_config", self.autoscaling_config),
                       kw.pop("model_autoscaling_config",
                              self.model_autoscaling_config),
                       kw.pop("ray_actor_options", self.ray_actor_options))
        if kw:
            raise ValueError(f"unknown deployment options {sorted(kw)}")
        return d


def _flatten_values(args, kwargs):
    out = []

    def scan(v):
        if isinstance(v, (list, tuple)):
            for x in v:
                scan(x)
        elif isinstance(v, dict):
            for x in v.values():
                scan(x)
        else:
            out.append(v)

    for a in args:
        scan(a)
    for a in kwargs.values():
        scan(a)
    return out


@dataclass
class Application:
    deployments: List[Deployment]
    ingress: Deployment

    def __getattr__(self, name: str):
        # graph authoring: `app.method.bind(...)` builds a
        # DeploymentMethodNode (ref: serve deployment graph DAG idiom)
        if (name.startswith("_") and name != "__call__") \
                or name in ("deployments", "ingress"):
            raise AttributeError(name)
        # only resolve methods the bound class actually defines — typos
        # and duck-type probes (hasattr(app, "keys")) must fail here, not
        # at request time inside the DAGDriver
        target = self.ingress.func_or_class
        if not hasattr(target, name):
            raise AttributeError(
                f"{getattr(target, '__name__', target)!r} has no method "
                f"{name!r} to bind")
        from ray_tpu_torch.serve.graph import _GraphMethod

        return _GraphMethod(self, name)


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_concurrent_queries: int = 100,
               user_config: Any = None,
               autoscaling_config: Optional[dict] = None,
               model_autoscaling_config: Optional[dict] = None,
               ray_actor_options: Optional[dict] = None):
    def deco(obj):
        return Deployment(obj, name or getattr(obj, "__name__", "deployment"),
                          num_replicas, max_concurrent_queries, user_config,
                          autoscaling_config, model_autoscaling_config,
                          ray_actor_options)

    if _func_or_class is not None:
        return deco(_func_or_class)
    return deco


def _get_or_start_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)
    except ValueError:
        from ray_tpu_torch.serve.controller import ServeController

        try:
            # max_restarts=-1: the controller is a checkpointed state
            # machine (GCS KV) — on death it restarts, restores the
            # deployment table, and re-adopts live named replicas
            # (ref: serve/controller.py:74). max_concurrency sized for
            # one pending long-poll per router/proxy subscriber.
            return ServeController.options(
                name=CONTROLLER_NAME, namespace=_NAMESPACE,
                max_restarts=-1, max_concurrency=64).remote()
        except ValueError:
            return ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)


def _handleize(v):
    """Replace nested bound deployments with runtime handles (ref:
    deployment_graph_build.py — DeploymentNodes become handles in the
    parent's init args)."""
    if isinstance(v, Application):
        return DeploymentHandle(v.ingress.name)
    if isinstance(v, tuple):
        return tuple(_handleize(x) for x in v)
    if isinstance(v, list):
        return [_handleize(x) for x in v]
    if isinstance(v, dict):
        return {k: _handleize(x) for k, x in v.items()}
    return v


def run(app: Application, *, route_prefix: Optional[str] = None,
        _blocking: bool = False) -> DeploymentHandle:
    """Deploy every deployment in the app; returns the ingress handle
    (ref: serve.run api.py:414). route_prefix registers the ingress with
    the HTTP proxy's route table."""
    controller = _get_or_start_controller()
    # children first (bind() appends them after the parent): a parent that
    # warms up through an injected handle in __init__ must find the child's
    # replicas already deployed (ref: topological deploy order in
    # deployment_graph_build.py)
    for d in reversed(app.deployments):
        from ray_tpu_torch.core.runtime import _dumps_function

        blob = _dumps_function(d.func_or_class) \
            if callable(d.func_or_class) else cloudpickle.dumps(d.func_or_class)
        config = {
            "num_replicas": d.num_replicas,
            "max_concurrent_queries": d.max_concurrent_queries,
            "user_config": d.user_config,
            "autoscaling_config": d.autoscaling_config,
            "model_autoscaling_config": d.model_autoscaling_config,
            "ray_actor_options": d.ray_actor_options,
        }
        ray_tpu_torch.get(controller.deploy.remote(
            d.name, blob, _handleize(d.init_args), _handleize(d.init_kwargs),
            config))
    if route_prefix is not None:
        ray_tpu_torch.get(controller.set_route.remote(route_prefix,
                                                      app.ingress.name))
    return DeploymentHandle(app.ingress.name)


def start(http_host: str = "127.0.0.1", http_port: int = 0,
          detached: bool = True) -> int:
    """Start the HTTP ingress proxy; returns the bound port (ref:
    serve.start / _private/http_state.py proxy startup)."""
    from ray_tpu_torch.serve.http_proxy import HTTPProxy, PROXY_NAME

    _get_or_start_controller()
    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=_NAMESPACE)
    except ValueError:
        try:
            proxy = HTTPProxy.options(
                name=PROXY_NAME, namespace=_NAMESPACE,
                max_concurrency=64).remote(http_host, http_port)
        except ValueError:
            proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=_NAMESPACE)
    return ray_tpu_torch.get(proxy.ready.remote())


def status() -> dict:
    """Deployment + route table snapshot (ref: serve.status / REST GET)."""
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)
    except ValueError:
        return {"deployments": {}, "routes": {}}
    return {"deployments": ray_tpu_torch.get(controller.list_deployments.remote()),
            "routes": ray_tpu_torch.get(controller.get_routes.remote())}


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def shutdown():
    from ray_tpu_torch.serve.http_proxy import PROXY_NAME

    try:
        proxy = ray_tpu_torch.get_actor(PROXY_NAME, namespace=_NAMESPACE)
        ray_tpu_torch.get(proxy.shutdown.remote())
        ray_tpu_torch.kill(proxy)
    except Exception:
        pass
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME, namespace=_NAMESPACE)
    except ValueError:
        return
    for name in ray_tpu_torch.get(controller.list_deployments.remote()):
        ray_tpu_torch.get(controller.delete_deployment.remote(name))
    try:
        # stop the control-loop thread before killing the actor: under
        # lane packing the daemon thread would outlive the actor in the
        # shared worker process (see ServeController.shutdown)
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=10)
    except Exception:
        pass  # best effort; kill() still tears down the lane
    ray_tpu_torch.kill(controller)
