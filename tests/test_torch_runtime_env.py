"""The port's runtime environments: the cases of ``test_runtime_env.py``
(env_vars, working_dir, py_modules for tasks and actors, the package
cache) on the port's runtime, and ``ray_tpu_torch.runtime_env``'s exports
(a copy of ``ray_tpu/runtime_env.py`` over the port's
``_private/runtime_env_mgr.py``). The runtime imports no torch, so these
run in the pytest worker."""

import os

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def ray_init():
    info = ray_tpu_torch.init(num_cpus=4)
    yield info
    ray_tpu_torch.shutdown()


def test_task_env_vars(ray_init):
    @ray_tpu_torch.remote
    def read_env():
        return os.environ.get("RT_ENV_TEST", "missing")

    val = ray_tpu_torch.get(
        read_env.options(
            runtime_env={"env_vars": {"RT_ENV_TEST": "on"}}).remote(),
        timeout=60,
    )
    assert val == "on"


def test_task_working_dir(ray_init, tmp_path):
    (tmp_path / "payload.txt").write_text("working-dir-payload")
    (tmp_path / "helper.py").write_text("MAGIC = 'helper-magic'\n")

    @ray_tpu_torch.remote
    def use_working_dir():
        import helper  # importable: working_dir is on sys.path

        return open("payload.txt").read(), helper.MAGIC

    data, magic = ray_tpu_torch.get(
        use_working_dir.options(
            runtime_env={"working_dir": str(tmp_path)}).remote(),
        timeout=60,
    )
    assert data == "working-dir-payload"
    assert magic == "helper-magic"


def test_task_py_modules(ray_init, tmp_path):
    mod = tmp_path / "shipped_mod"
    mod.mkdir()
    (mod / "__init__.py").write_text("VALUE = 1234\n")
    (mod / "sub.py").write_text("def f():\n    return 'sub-ok'\n")

    @ray_tpu_torch.remote
    def use_module():
        import shipped_mod
        from shipped_mod.sub import f

        return shipped_mod.VALUE, f()

    value, sub = ray_tpu_torch.get(
        use_module.options(
            runtime_env={"py_modules": [str(mod)]}).remote(),
        timeout=60,
    )
    assert value == 1234
    assert sub == "sub-ok"


def test_actor_runtime_env(ray_init, tmp_path):
    (tmp_path / "actor_data.txt").write_text("actor-sees-this")

    @ray_tpu_torch.remote
    class EnvActor:
        def __init__(self):
            self.data = open("actor_data.txt").read()

        def get(self):
            return self.data, os.environ.get("ACTOR_ENV_FLAG")

    a = EnvActor.options(runtime_env={
        "working_dir": str(tmp_path),
        "env_vars": {"ACTOR_ENV_FLAG": "yes"},
    }).remote()
    data, flag = ray_tpu_torch.get(a.get.remote(), timeout=60)
    assert data == "actor-sees-this"
    assert flag == "yes"
    ray_tpu_torch.kill(a)


def test_package_cache_dedup(ray_init, tmp_path):
    """Identical working_dirs share one content-addressed package."""
    (tmp_path / "f.txt").write_text("same-content")

    @ray_tpu_torch.remote
    def read():
        return open("f.txt").read()

    env = {"working_dir": str(tmp_path)}
    r1 = ray_tpu_torch.get(read.options(runtime_env=env).remote(), timeout=60)
    r2 = ray_tpu_torch.get(read.options(runtime_env=env).remote(), timeout=60)
    assert r1 == r2 == "same-content"


# -- ray_tpu_torch.runtime_env ------------------------------------------------


def test_runtime_env_exports_match_jax():
    import ray_tpu.runtime_env as jax_env
    import ray_tpu_torch.runtime_env as port_env

    assert port_env.__all__ == jax_env.__all__
    for name in jax_env.__all__:
        assert getattr(port_env, name).__module__ == (
            "ray_tpu_torch._private.runtime_env_mgr"), name


def test_custom_runtime_env_plugin(ray_init):
    """A plugin registered through ``ray_tpu_torch.runtime_env`` runs its
    prepare step in the driver and its setup step in the worker, as in
    ``test_runtime_env_isolation.py``'s JAX case."""
    from ray_tpu_torch.runtime_env import (RuntimeEnvPlugin,
                                           register_runtime_env_plugin,
                                           unregister_runtime_env_plugin)

    class Banner(RuntimeEnvPlugin):
        name = "banner"

        async def prepare(self, value, runtime_env, cw):
            return f"prepared:{value}"

        async def setup(self, value, runtime_env, cw):
            import os

            os.environ["RT_TEST_BANNER"] = value

    register_runtime_env_plugin(Banner())
    try:
        @ray_tpu_torch.remote
        def read_banner():
            import os

            return os.environ.get("RT_TEST_BANNER", "")

        out = ray_tpu_torch.get(
            read_banner.options(
                runtime_env={"banner": "hello"}).remote(), timeout=60)
        assert out == "prepared:hello"
        with pytest.raises(ValueError, match="invalid plugin name"):
            register_runtime_env_plugin(type("Bad", (RuntimeEnvPlugin,),
                                             {"name": "env_vars"})())
    finally:
        unregister_runtime_env_plugin("banner")
