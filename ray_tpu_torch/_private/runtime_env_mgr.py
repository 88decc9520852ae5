"""Runtime environments: per-task/actor pip venvs, working_dir, py_modules,
env_vars.

Reference surface: python/ray/runtime_env/ + _private/runtime_env/
(ARCHITECTURE.md — env built once per URI, cached, applied before user
code; working_dir/py_modules are content-addressed zips; pip/conda envs
built by the per-node agent and workers exec'd inside them; worker_pool.h
keys cached workers by runtime-env hash). Here the packages travel through
the control store's KV (the reference's GCS-backed package store for small
URIs), and the per-node cache lives in the session dir.

ISOLATING env fields (`pip`, `working_dir`) contribute to an env key that
workers are POOLED BY: the daemon grants such leases only to workers
spawned for that exact env — a pip env's worker runs on the venv's own
interpreter, and working_dir is chdir'd once at worker startup. Two tasks
with conflicting deps or different working dirs therefore run concurrently
on one node in different worker processes, and the old process-wide-chdir-
on-pooled-workers hazard is gone. Venvs are content-addressed
(venvs/<hash> under the session cache) and built once per node with
--system-site-packages, so the framework and its baked deps resolve while
installed packages shadow them.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys
import zipfile
from typing import Any, Dict, List, Optional

KV_NS = "runtime_env"

# fields whose values require a dedicated worker process
_ISOLATING_FIELDS = ("pip", "uv", "working_dir_uri", "plugin_iso")

# every field the framework itself understands: user-facing inputs plus the
# wire-form fields prepare_runtime_env generates (a prepared env may be
# passed back in, e.g. an actor restart re-preparing its creation spec)
_BUILTIN_FIELDS = frozenset({
    "pip", "uv", "working_dir", "py_modules", "env_vars",
    "working_dir_uri", "py_module_uris", "env_key", "namespace",
    "detached", "plugin_iso", "_plugins",
})


# ---------------------------------------------------------------------------
# plugin architecture (reference: _private/runtime_env/ARCHITECTURE.md —
# each env field is a plugin with a driver-side prepare step and an
# executor-side setup step; third parties register their own)
# ---------------------------------------------------------------------------


class RuntimeEnvPlugin:
    """One runtime-env field. `name` is the runtime_env dict key the plugin
    owns. prepare() runs on the DRIVER at submission (return a wire-safe
    value — upload payloads through cw, never ship local paths); setup()
    runs in the EXECUTOR before user code. `isolating=True` pools workers
    by this field's value (a dedicated process per distinct value)."""

    name: str = ""
    isolating: bool = False

    async def prepare(self, value, runtime_env: Dict[str, Any], cw):
        return value

    async def setup(self, value, runtime_env: Dict[str, Any], cw):
        return None


_PLUGINS: Dict[str, RuntimeEnvPlugin] = {}


def register_runtime_env_plugin(plugin: RuntimeEnvPlugin):
    """Register a custom env field (reference: the plugin registry the
    runtime-env agent loads). Built-in fields cannot be overridden."""
    builtin = {"pip", "uv", "working_dir", "py_modules", "env_vars",
               "working_dir_uri", "py_module_uris", "env_key", "namespace"}
    if not plugin.name or plugin.name in builtin:
        raise ValueError(f"invalid plugin name {plugin.name!r}")
    _PLUGINS[plugin.name] = plugin


def unregister_runtime_env_plugin(name: str):
    _PLUGINS.pop(name, None)


def env_isolation_key(runtime_env: Optional[Dict[str, Any]]) -> str:
    """Stable key of the wire env's isolating fields; '' = any pooled
    worker may run it (reference: worker_pool.h runtime_env_hash)."""
    if not runtime_env:
        return ""
    parts = {k: runtime_env[k] for k in _ISOLATING_FIELDS if runtime_env.get(k)}
    if not parts:
        return ""
    for f in ("pip", "uv"):
        if f in parts:
            # order-insensitive, matching ensure_venv's cache key — reordered
            # but identical specs must share one worker pool
            parts[f] = sorted(parts[f])
    blob = json.dumps(parts, sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


def ensure_venv(pip_spec: List[str], cache_root: str,
                backend: str = "pip") -> str:
    """Build (or reuse) a content-addressed venv for `pip_spec`; returns its
    python executable. Concurrent builds serialize on an flock; the venv
    is built IN PLACE (crashed half-builds are tolerated by `venv` and
    rebuilt) and readers are gated by the .rt_ready marker written after a
    successful pip install. --no-build-isolation keeps local-path installs
    offline (the build env would otherwise fetch setuptools from the
    index). backend="uv" resolves/installs with uv (reference: the uv
    runtime-env plugin) — same cache layout, much faster cold builds."""
    key = hashlib.blake2b(
        json.dumps([backend, *sorted(pip_spec)]).encode(),
        digest_size=8).hexdigest()
    venv_dir = os.path.join(cache_root, "venvs", key)
    python = os.path.join(venv_dir, "bin", "python")
    ready = os.path.join(venv_dir, ".rt_ready")
    if os.path.exists(ready):
        return python
    os.makedirs(os.path.dirname(venv_dir), exist_ok=True)
    import fcntl

    with open(venv_dir + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(ready):  # built while we waited
                return python
            # build in place under the lock (venv tolerates an existing dir
            # from a crashed attempt); the .rt_ready marker gates readers
            subprocess.run(
                [sys.executable, "-m", "venv", venv_dir],
                check=True, capture_output=True, timeout=300,
            )
            # NOT --system-site-packages: a venv created from inside a venv
            # (e.g. a container's own venv) chains to the BASE interpreter's
            # site-packages, losing torch/setuptools/the framework's deps.
            # Instead a .pth appends the PARENT interpreter's site dirs
            # after the venv's own — installs shadow, everything resolves.
            import glob as _glob

            vsite = _glob.glob(os.path.join(
                venv_dir, "lib", "python*", "site-packages"))[0]
            parent_sites = [
                p for p in sys.path
                if p.endswith("site-packages") and os.path.isdir(p)
            ]
            with open(os.path.join(vsite, "_rt_parent.pth"), "w") as f:
                f.write("\n".join(parent_sites) + "\n")
            if backend == "uv":
                import shutil as _sh

                uv = _sh.which("uv")
                if uv is None:
                    raise RuntimeError(
                        "runtime_env 'uv' requested but no uv binary on "
                        "this node")
                cmd = [uv, "pip", "install", "--python", python,
                       "--no-build-isolation", "--quiet", *pip_spec]
            else:
                cmd = [python, "-m", "pip", "install",
                       "--no-build-isolation", "--quiet",
                       "--retries", "1", "--timeout", "10", *pip_spec]
            r = subprocess.run(
                cmd, capture_output=True, timeout=600, text=True,
            )
            if r.returncode != 0:
                raise RuntimeError(
                    f"{backend} install {pip_spec} failed:\n"
                    f"{r.stderr[-2000:]}")
            with open(ready, "w") as f:
                f.write("ok")
            return python
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _zip_dir_bytes(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in sorted(os.walk(path)):
            for f in sorted(files):
                full = os.path.join(root, f)
                # fixed timestamp: the URI must be a pure function of
                # CONTENT, or every mtime touch defeats package dedup
                info = zipfile.ZipInfo(os.path.relpath(full, path),
                                       date_time=(1980, 1, 1, 0, 0, 0))
                info.compress_type = zipfile.ZIP_DEFLATED
                with open(full, "rb") as fh:
                    zf.writestr(info, fh.read())
    return buf.getvalue()


def _dir_signature(path: str) -> tuple:
    """Cheap change detector for the driver-side upload cache."""
    sig = []
    for root, _dirs, files in sorted(os.walk(path)):
        for f in sorted(files):
            full = os.path.join(root, f)
            st = os.stat(full)
            sig.append((os.path.relpath(full, path), st.st_size,
                        st.st_mtime_ns))
    return tuple(sig)


# driver-side memo: (abspath, dir signature) -> uploaded uri — without it
# every task submission re-zips and re-ships the whole directory
_UPLOAD_CACHE: Dict[str, tuple] = {}

# executor-side record of which py_module version is live per module name
_APPLIED_MODULES: Dict[str, str] = {}
_REMOTE_WD_CACHE: Dict[str, str] = {}


async def prepare_runtime_env(runtime_env: Optional[Dict[str, Any]],
                              cw) -> Optional[Dict[str, Any]]:
    """Driver side: upload local dirs as content-addressed zips; return the
    wire form ({..._uri} instead of local paths). Unknown fields — matching
    neither a builtin nor a registered plugin — fail the submission here
    with a clear error instead of being silently dropped (a typo'd 'pipp'
    must not no-op; reference: the runtime-env plugin manager rejects
    unknown fields the same way)."""
    if not runtime_env:
        return runtime_env
    unknown = [k for k in runtime_env
               if k not in _BUILTIN_FIELDS and k not in _PLUGINS]
    if unknown:
        known = sorted(k for k in _BUILTIN_FIELDS if not k.startswith("_"))
        raise ValueError(
            f"unknown runtime_env field(s) {sorted(unknown)!r}: each field "
            f"must be a builtin ({', '.join(known)}) or a registered "
            "runtime-env plugin (register_runtime_env_plugin)")
    out = dict(runtime_env)

    async def upload(path: str) -> str:
        path = os.path.abspath(path)
        sig = _dir_signature(path)
        cached = _UPLOAD_CACHE.get(path)
        if cached is not None and cached[0] == sig:
            return cached[1]
        blob = _zip_dir_bytes(path)
        uri = "pkg_" + hashlib.blake2b(blob, digest_size=16).hexdigest()
        await cw.control.call("kv_put", {
            "ns": KV_NS, "key": uri.encode(), "value": blob,
            "overwrite": False,
        })
        _UPLOAD_CACHE[path] = (sig, uri)
        return uri

    wd = out.pop("working_dir", None)
    if wd:
        if "://" in wd:
            # remote package source (gs://, s3://, memory://...): stage it
            # locally through the storage plane once per URI (cached), then
            # upload as usual; the staging dir is removed after upload
            # (reference: remote working_dir URIs in runtime_env packaging)
            cached = _REMOTE_WD_CACHE.get(wd)
            if cached is not None:
                out["working_dir_uri"] = cached
            else:
                import shutil
                import tempfile

                from ray_tpu_torch.train._storage import get_storage

                staged = tempfile.mkdtemp(prefix="rt_wd_")
                try:
                    get_storage(wd).download_dir(wd, staged)
                    uri = await upload(staged)
                finally:
                    shutil.rmtree(staged, ignore_errors=True)
                _REMOTE_WD_CACHE[wd] = uri
                out["working_dir_uri"] = uri
        else:
            if not os.path.isdir(wd):
                raise ValueError(f"working_dir {wd!r} is not a directory")
            out["working_dir_uri"] = await upload(wd)
    mods = out.pop("py_modules", None)
    if mods:
        uris: List[str] = []
        for m in mods:
            if not os.path.isdir(m):
                raise ValueError(f"py_modules entry {m!r} is not a directory")
            uris.append(await upload(m) + ":" + os.path.basename(m.rstrip("/")))
        out["py_module_uris"] = uris
    for field in ("pip", "uv"):
        spec = out.get(field)
        if spec is None:
            continue
        if not isinstance(spec, (list, tuple)) or not all(
                isinstance(p, str) for p in spec):
            raise ValueError(f"runtime_env[{field!r}] must be a list of "
                             "requirement strings / local paths")
        # entries that LOOK like paths resolve against the DRIVER's cwd;
        # make them absolute so the daemon-side installer sees the same
        # files. Bare names stay requirement strings even if a same-named
        # file happens to exist in the cwd.
        def looks_like_path(p: str) -> bool:
            return p.startswith((".", "/", "~")) or os.sep in p

        out[field] = [
            os.path.abspath(os.path.expanduser(p))
            if looks_like_path(p) and os.path.exists(os.path.expanduser(p))
            else p
            for p in spec
        ]
    if out.get("pip") and out.get("uv"):
        raise ValueError("runtime_env takes 'pip' OR 'uv', not both")
    # registered custom plugins transform their fields to wire form; the
    # plugin OBJECT ships by value so executor processes (where nothing
    # registered it) can run its setup hook
    for name, plugin in _PLUGINS.items():
        if name in out:
            import cloudpickle

            out[name] = await plugin.prepare(out[name], out, cw)
            out.setdefault("_plugins", {})[name] = cloudpickle.dumps(plugin)
            if plugin.isolating:
                # isolating plugin values join the env key via a dedicated
                # wire field — daemons/workers recompute the key WITHOUT
                # knowing the plugin, so the value must be JSON-compatible
                out.setdefault("plugin_iso", {})[name] = out[name]
    out["env_key"] = env_isolation_key(out)
    return out


async def _fetch_extract(uri: str, cw, cache_root: str) -> str:
    dest = os.path.join(cache_root, uri)
    if os.path.isdir(dest):
        return dest
    reply = await cw.control.call("kv_get", {"ns": KV_NS, "key": uri.encode()})
    blob = reply.get("value")
    if blob is None:
        raise RuntimeError(f"runtime env package {uri} missing from KV")
    # per-process tmp dir: multiple pooled workers on a node can race the
    # same uncached URI, and a shared tmp path lets one process publish a
    # half-extracted tree out from under another
    tmp = f"{dest}.tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    zipfile.ZipFile(io.BytesIO(blob)).extractall(tmp)
    try:
        os.replace(tmp, dest)  # atomic publish; loser's replace fails
    except OSError:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dest


async def setup_runtime_env(runtime_env: Optional[Dict[str, Any]], cw,
                            dedicated: bool = False):
    """Executor side: apply env before user code runs (reference: the
    runtime-env agent builds the env, the worker execs inside it).
    `dedicated` = this process serves only this env (actor workers; task
    workers are instead spawned with RT_ENV_KEY by the daemon)."""
    if not runtime_env:
        return
    env_vars = runtime_env.get("env_vars") or {}
    if env_vars:
        os.environ.update(env_vars)
    for name, blob in (runtime_env.get("_plugins") or {}).items():
        plugin = _PLUGINS.get(name)
        if plugin is None:
            import cloudpickle

            # Trust note: the plugin object ships BY VALUE from the driver
            # and is unpickled+executed here during worker bootstrap. That
            # matches the trust model of task shipping (drivers already run
            # arbitrary code on workers via cloudpickled functions), but it
            # does widen what runs before any user task starts.
            plugin = cloudpickle.loads(blob)
        await plugin.setup(runtime_env.get(name), runtime_env, cw)
    cache_root = os.path.join(
        os.environ.get("RT_SESSION_DIR", "/tmp"), "runtime_env_cache")
    os.makedirs(cache_root, exist_ok=True)
    for entry in runtime_env.get("py_module_uris") or []:
        uri, _, modname = entry.partition(":")
        pkg_dir = await _fetch_extract(uri, cw, cache_root)
        # the zip holds the module's CONTENTS; expose it under its name
        named = os.path.join(cache_root, f"{uri}_as")
        target = os.path.join(named, modname)
        if not os.path.isdir(target):
            os.makedirs(named, exist_ok=True)
            try:
                os.symlink(pkg_dir, target)
            except FileExistsError:
                pass
        if named not in sys.path:
            sys.path.insert(0, named)
        # pooled worker previously imported an OLDER version of this module:
        # sys.modules would shadow the new path, silently serving stale code
        prev_uri = _APPLIED_MODULES.get(modname)
        if prev_uri is not None and prev_uri != uri:
            for loaded in [m for m in sys.modules
                           if m == modname or m.startswith(modname + ".")]:
                del sys.modules[loaded]
        _APPLIED_MODULES[modname] = uri
    wd_uri = runtime_env.get("working_dir_uri")
    if wd_uri:
        wd = await _fetch_extract(wd_uri, cw, cache_root)
        if wd not in sys.path:
            sys.path.insert(0, wd)
        # chdir only on a worker DEDICATED to this env (spawned with the
        # matching key, already chdir'd at startup — this is then a no-op
        # after a crash-restart). On a shared worker a process-wide chdir
        # would race concurrent tasks; sys.path covers imports instead.
        if dedicated or (
                os.environ.get("RT_ENV_KEY", "")
                == runtime_env.get("env_key", "")):
            os.chdir(wd)
