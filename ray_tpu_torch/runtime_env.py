"""Public runtime-env surface (reference: python/ray/runtime_env/); the
port's copy of ``ray_tpu/runtime_env.py``.

A runtime_env dict on @remote / .options() describes the environment a
task or actor runs in:

    ray_tpu_torch.remote(runtime_env={
        "env_vars": {"TOKENIZERS_PARALLELISM": "false"},
        "pip": ["emoji==2.0"],          # or "uv": [...] (faster builds)
        "working_dir": "./my_project",  # content-addressed upload
        "py_modules": ["./libs/mylib"],
    })

`pip`/`uv` build content-addressed venvs on each node (workers are pooled
per env, so conflicting deps run concurrently in separate processes);
`working_dir`/`py_modules` ship as content-addressed zips through the
control store. Custom fields are added by registering a RuntimeEnvPlugin
(reference: _private/runtime_env/ARCHITECTURE.md's plugin registry).
"""

from ray_tpu_torch._private.runtime_env_mgr import (
    RuntimeEnvPlugin,
    register_runtime_env_plugin,
    unregister_runtime_env_plugin,
)

__all__ = [
    "RuntimeEnvPlugin",
    "register_runtime_env_plugin",
    "unregister_runtime_env_plugin",
]
