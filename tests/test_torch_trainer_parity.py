"""The port's train library against the JAX package's, on the same numpy
inputs: one numpy train fn through ``JaxTrainer`` on ``ray_tpu``'s cluster
and through ``TorchTrainer`` on ``ray_tpu_torch``'s gives the same metrics
and keeps the same checkpoints under top-k, and each package's final
checkpoint restores in the other. Then a tiny Llama (2 layers, dim 48,
fp32) trained by ``TorchTrainer`` from JAX's init (``params_from_jax`` in
the worker) follows JAX's ``make_train_step`` to 1e-4. Both clusters run
in the pytest worker, one after the other; torch runs only in the port's
worker processes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu
import ray_tpu.train
import ray_tpu_torch
import ray_tpu_torch.train
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshSpec

LOSSES = [3.0, 1.0, 2.0, 4.0, 0.5]
LLAMA = dict(vocab_size=96, dim=48, n_layers=2, n_heads=4, n_kv_heads=2,
             ffn_dim=96, max_seq_len=16)
LLAMA_STEPS, LLAMA_LR = 4, 1e-2


def _numpy_train_fn(package):
    """One train fn for either package (by value: a closure), numpy only:
    a state that grows by rank and step, restored from the latest
    checkpoint, with a fixed loss curve that top-k retention ranks."""

    def train_fn(config):
        import importlib

        import numpy as np

        train = importlib.import_module(package + ".train")
        ctx = train.get_context()
        rank = ctx.get_world_rank()
        state = {"w": np.zeros((2, 3), np.float32), "step": 0}
        start = 0
        ckpt = ctx.get_checkpoint()
        if ckpt is not None:
            state = ckpt.load_state(state, rank=rank)
            start = int(state["step"]) + 1
        for step in range(start, len(config["losses"])):
            state = {"w": state["w"] + np.float32(rank + 1) * (step + 1),
                     "step": step}
            train.report({"step": step, "rank": rank,
                          "world": ctx.get_world_size(),
                          "loss": config["losses"][step],
                          "w_sum": float(state["w"].sum())},
                         checkpoint_state=state)

    return train_fn


def _fit(pkg, tmp_path):
    """Two workers through the package's trainer; (sorted metrics, kept
    checkpoint dirs, the final checkpoint's path, the best's step)."""
    train = pkg.train
    trainer_cls = (train.JaxTrainer if pkg is ray_tpu
                   else train.TorchTrainer)
    pkg.init(num_cpus=4)
    try:
        result = trainer_cls(
            _numpy_train_fn(pkg.__name__),
            train_loop_config={"losses": LOSSES},
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(
                name="parity", storage_path=str(tmp_path / pkg.__name__),
                checkpoint_config=train.CheckpointConfig(
                    num_to_keep=2, checkpoint_score_attribute="loss",
                    checkpoint_score_order="min")),
        ).fit()
    finally:
        pkg.shutdown()
    run_dir = tmp_path / pkg.__name__ / "parity"
    kept = sorted(d for d in os.listdir(run_dir)
                  if d.startswith("checkpoint_"))
    metrics = sorted(result.metrics_history,
                     key=lambda m: (m["step"], m["rank"]))
    return (metrics, kept, result.checkpoint.path,
            result.best_checkpoint.step)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_parity")
    return {"jax": _fit(ray_tpu, tmp), "port": _fit(ray_tpu_torch, tmp)}


def test_same_metrics(fits):
    assert fits["port"][0] == fits["jax"][0]
    assert len(fits["port"][0]) == 2 * len(LOSSES)


def test_same_checkpoints_kept_under_top_k(fits):
    # latest (step 4) and best by min loss (step 4 too, 0.5), then step 1
    assert fits["port"][1] == fits["jax"][1] == [
        "checkpoint_000000001", "checkpoint_000000004"]
    assert fits["port"][3] == fits["jax"][3] == 4


@pytest.mark.parametrize("rank", [0, 1])
def test_final_checkpoints_restore_across_packages(fits, rank):
    """Each package's final checkpoint, read by the other's Checkpoint."""
    from ray_tpu.train import Checkpoint as JCheckpoint
    from ray_tpu_torch.train import Checkpoint as TCheckpoint

    want = np.full((2, 3), (rank + 1) * sum(range(1, len(LOSSES) + 1)),
                   np.float32)
    skeleton = {"w": np.zeros((2, 3), np.float32), "step": 0}
    from_jax = TCheckpoint(fits["jax"][2]).load_state(dict(skeleton), rank)
    from_port = JCheckpoint(fits["port"][2]).load_state(
        {"w": jnp.zeros((2, 3)), "step": 0}, rank)
    for got in (from_jax, from_port):
        np.testing.assert_array_equal(np.asarray(got["w"]), want)
        assert got["step"] == len(LOSSES) - 1


def _llama_train_fn():
    def train_fn(config):
        import torch

        from ray_tpu_torch import train
        from ray_tpu_torch.models.convert import params_from_jax
        from ray_tpu_torch.models.llama import LlamaConfig, make_train_step

        cfg = LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                          **config["shape"])
        init_state, shard_state, train_step, dev = make_train_step(
            cfg, learning_rate=config["lr"], device="cpu")
        state = shard_state(init_state(params_from_jax(config["params"],
                                                       "cpu")))
        tokens = torch.from_numpy(config["tokens"]).to(dev)
        for step in range(config["steps"]):
            state, loss = train_step(state, tokens)
            train.report({"step": step, "loss": float(loss)})

    return train_fn


def test_tiny_llama_trained_by_torch_trainer_follows_jax(tmp_path):
    cfg = jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                         **LLAMA)
    tokens = np.random.RandomState(3).randint(
        0, LLAMA["vocab_size"], size=(4, 16)).astype(np.int32)
    params = jl.init_params(cfg, jax.random.key(0))
    weights = jax.tree.map(np.array, params)
    mesh = MeshSpec().build(jax.devices()[:1])
    init_state, shard_state, train_step, data_sharding = jl.make_train_step(
        cfg, mesh, learning_rate=LLAMA_LR)
    state = shard_state((params, init_state(jax.random.key(0))[1]))
    toks = jax.device_put(jnp.asarray(tokens), data_sharding)
    want = []
    for _ in range(LLAMA_STEPS):
        state, loss = train_step(state, toks)
        want.append(float(loss))

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    ray_tpu_torch.init(num_cpus=2)
    try:
        result = TorchTrainer(
            _llama_train_fn(),
            train_loop_config={"shape": LLAMA, "params": weights,
                               "tokens": tokens, "lr": LLAMA_LR,
                               "steps": LLAMA_STEPS},
            scaling_config=ScalingConfig(num_workers=1),
            run_config=RunConfig(name="llama", storage_path=str(tmp_path)),
        ).fit()
    finally:
        ray_tpu_torch.shutdown()
    got = [m["loss"] for m in sorted(result.metrics_history,
                                     key=lambda m: m["step"])]
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[-1] < got[0]
