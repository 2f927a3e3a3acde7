"""Declarative serve config (REST/CLI schema).

Reference: python/ray/serve/schema.py — ServeDeploySchema: a config file
listing applications (import_path + route_prefix + per-deployment
overrides) that `serve deploy` applies. Here the config is JSON (YAML also
accepted when pyyaml is importable) and `apply_config` builds and runs each
application from its import path.

Config shape:
    {
      "applications": [
        {
          "name": "app1",
          "route_prefix": "/app1",
          "import_path": "mypkg.mymodule:app",
          "deployments": [
            {"name": "Model", "num_replicas": 2,
             "user_config": {...}, "autoscaling_config": {...}}
          ]
        }
      ]
    }
"""

from __future__ import annotations

import importlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class DeploymentSchema:
    name: str
    num_replicas: Optional[int] = None
    max_concurrent_queries: Optional[int] = None
    user_config: Any = None
    autoscaling_config: Optional[dict] = None
    ray_actor_options: Optional[dict] = None


@dataclass
class ApplicationSchema:
    import_path: str
    name: str = "default"
    route_prefix: Optional[str] = None
    deployments: List[DeploymentSchema] = field(default_factory=list)


@dataclass
class ServeDeploySchema:
    applications: List[ApplicationSchema] = field(default_factory=list)
    http_host: str = "127.0.0.1"
    http_port: int = 8000

    @classmethod
    def parse(cls, data: dict) -> "ServeDeploySchema":
        apps = []
        for a in data.get("applications", []):
            deps = [DeploymentSchema(**d) for d in a.get("deployments", [])]
            apps.append(ApplicationSchema(
                import_path=a["import_path"],
                name=a.get("name", "default"),
                route_prefix=a.get("route_prefix"),
                deployments=deps))
        http = data.get("http_options", {})
        return cls(applications=apps,
                   http_host=http.get("host", "127.0.0.1"),
                   http_port=http.get("port", 8000))

    @classmethod
    def from_file(cls, path: str) -> "ServeDeploySchema":
        with open(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            import yaml  # optional; JSON is the native format

            data = yaml.safe_load(text)
        return cls.parse(data)


def _import_app(import_path: str):
    module_name, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path must be 'module:attr', got {import_path!r}")
    mod = importlib.import_module(module_name)
    return getattr(mod, attr)


def apply_config(schema: ServeDeploySchema, *, start_http: bool = True
                 ) -> Dict[str, Any]:
    """Build + run every application in the config; returns route→port info."""
    from ray_tpu_torch import serve

    port = None
    if start_http:
        port = serve.start(http_host=schema.http_host,
                           http_port=schema.http_port)
    routes = {}
    for app_schema in schema.applications:
        app = _import_app(app_schema.import_path)
        # per-deployment overrides by name
        overrides = {d.name: d for d in app_schema.deployments}
        for dep in app.deployments:
            ov = overrides.get(dep.name)
            if ov is None:
                continue
            if ov.num_replicas is not None:
                dep.num_replicas = ov.num_replicas
            if ov.max_concurrent_queries is not None:
                dep.max_concurrent_queries = ov.max_concurrent_queries
            if ov.user_config is not None:
                dep.user_config = ov.user_config
            if ov.autoscaling_config is not None:
                dep.autoscaling_config = ov.autoscaling_config
            if ov.ray_actor_options is not None:
                dep.ray_actor_options = ov.ray_actor_options
        serve.run(app, route_prefix=app_schema.route_prefix)
        if app_schema.route_prefix:
            routes[app_schema.route_prefix] = app.ingress.name
    return {"http_port": port, "routes": routes}
