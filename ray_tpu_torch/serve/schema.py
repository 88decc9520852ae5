"""Declarative serve config: file-driven deploy + build.

Reference surface: python/ray/serve/schema.py (ServeDeploySchema /
ServeApplicationSchema — applications listed with import_path + per-
deployment overrides) and the `serve run` / `serve deploy` / `serve build`
CLI (python/ray/serve/scripts.py).

Config shape (YAML or JSON):

    http:
      host: 127.0.0.1
      port: 8000
    applications:
      - import_path: my_pkg.my_module:my_deployment
        name: override-name            # optional
        num_replicas: 2                # optional overrides
        autoscaling_config: {...}
        init_args: [...]               # optional (re-binds the target)
        init_kwargs: {...}

`import_path` resolves "module.sub:attr" to either a Deployment (possibly
bound) or a zero-arg builder function returning one.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Optional

_DEPLOYMENT_OVERRIDES = (
    "num_replicas", "autoscaling_config", "ray_actor_options",
    "max_concurrent_queries", "max_queued_requests",
)


def load_config(path_or_dict) -> Dict[str, Any]:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    import json

    with open(path_or_dict) as f:
        text = f.read()
    if str(path_or_dict).endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(text)
    return json.loads(text)


def _resolve_import_path(import_path: str):
    module_name, _, attr = import_path.partition(":")
    if not attr:
        raise ValueError(
            f"import_path {import_path!r} must be 'module.sub:attribute'")
    obj = importlib.import_module(module_name)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def _to_deployment(app_cfg: Dict[str, Any]):
    from ray_tpu_torch.serve import Deployment

    target = _resolve_import_path(app_cfg["import_path"])
    if not isinstance(target, Deployment):
        if callable(target):
            target = target()  # builder function
        if not isinstance(target, Deployment):
            raise TypeError(
                f"{app_cfg['import_path']} resolved to {type(target).__name__},"
                f" expected a Deployment or a builder returning one")
    overrides = {k: app_cfg[k] for k in _DEPLOYMENT_OVERRIDES
                 if k in app_cfg}
    if "name" in app_cfg:
        overrides["name"] = app_cfg["name"]
    if overrides:
        target = target.options(**overrides)
    if "init_args" in app_cfg or "init_kwargs" in app_cfg:
        target = target.bind(*app_cfg.get("init_args", ()),
                             **app_cfg.get("init_kwargs", {}))
    return target


def deploy_config(path_or_dict, *, start_http: bool = True,
                  timeout: float = 120.0) -> Dict[str, Any]:
    """Deploy every application in the config; returns {name: handle} plus
    the ingress base URL under "_http" when started (reference:
    `serve deploy` applying a ServeDeploySchema)."""
    from ray_tpu_torch import serve

    cfg = load_config(path_or_dict)
    handles: Dict[str, Any] = {}
    for app_cfg in cfg.get("applications", []):
        dep = _to_deployment(app_cfg)
        handles[dep.name] = serve.run(dep, timeout=timeout)
    if start_http:
        http = cfg.get("http", {}) or {}
        handles["_http"] = serve.start(
            http_host=http.get("host", "127.0.0.1"),
            http_port=int(http.get("port", 8000)))
    return handles


def build_config(*deployments, http_host: str = "127.0.0.1",
                 http_port: int = 8000) -> Dict[str, Any]:
    """The inverse of deploy_config for programmatically-built deployments
    (reference: `serve build` emitting a config file). import_path cannot
    be reconstructed from a live object, so it is emitted as a TODO the
    way `serve build` leaves placeholders for unimportable targets."""
    apps: List[Dict[str, Any]] = []
    for dep in deployments:
        target = dep._target
        module = getattr(target, "__module__", None)
        qual = getattr(target, "__qualname__", None)
        app: Dict[str, Any] = {
            "name": dep.name,
            "import_path": (f"{module}:{qual}"
                            if module and qual and "<locals>" not in qual
                            else "TODO: module:attribute"),
            "num_replicas": dep.num_replicas,
            "max_concurrent_queries": dep.max_concurrent_queries,
        }
        if dep.max_queued_requests is not None:
            app["max_queued_requests"] = dep.max_queued_requests
        if dep.autoscaling_config:
            app["autoscaling_config"] = dep.autoscaling_config
        if dep.ray_actor_options:
            app["ray_actor_options"] = dep.ray_actor_options
        apps.append(app)
    return {"http": {"host": http_host, "port": http_port},
            "applications": apps}


__all__ = ["build_config", "deploy_config", "load_config"]
