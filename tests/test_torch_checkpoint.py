"""Checkpoints of the PyTorch port (``ray_tpu_torch.train``) against the
JAX package's (``ray_tpu/train/_checkpoint.py``): the same files.

The JAX package's actor-free checkpoint tests on the port
(``test_train.py::test_checkpoint_manager_recovers_existing``,
``test_storage_plane.py::test_checkpoint_roundtrip_through_memory_fs``,
``test_elastic_restore.py``'s consolidated restore from another world
size, shard metadata and multi-shard rank file); then a JAX checkpoint of
a sharded Llama train state restored into the port and a port checkpoint
restored into JAX, each followed by one more step of both on the same
batch; a same-world restore on an uneven mesh and a leaf with an empty
block; a pipeline state restored at pp 1 and back; a snapshot that owns
its bytes; an unstepped optimizer saved as ``optax.adamw(...).init``.

Rank processes read and write files, so every checkpoint a rank touches
lies under ``tmp_path`` on disk (``memory://`` is per process). fp32 on
the CPU; the port runs in a spawned child (``_port_proc``) leading 8 gloo
rank processes (``_port_ranks``), each mesh filling the 8 ranks (a 4-rank
fsdp 2 x tp 2 layout runs as dp 2 x fsdp 2 x tp 2). JAX runs on the CPU
devices."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec

from _port_proc import spawn
from ray_tpu.models import llama as jl
from ray_tpu.parallel.mesh import MeshSpec
from ray_tpu.train._checkpoint import (AsyncCheckpointWriter, Checkpoint,
                                       _flatten_with_paths,
                                       snapshot_with_meta)
from ray_tpu.train._storage import get_storage

WORLD = 8
SHAPE = dict(vocab_size=512, dim=128, n_layers=2, n_heads=8, n_kv_heads=4,
             ffn_dim=256, max_seq_len=256)
# vocab 510 over fsdp 4: blocks of 128, 128, 128, 126
UNEVEN = dict(SHAPE, vocab_size=510, ffn_dim=250)
# test_pipeline.py's tiny Llama
PIPE = dict(vocab_size=128, dim=64, n_layers=4, n_heads=4, n_kv_heads=2,
            ffn_dim=128, max_seq_len=32)
LR = 1e-2
FSDP_TP = dict(dp=2, fsdp=2, tp=2)  # fsdp 2 x tp 2, twice side by side
# test_torch_train.py's leaf tolerance
PARAM_ATOL = 1e-4
PARAM_OUTLIER_FRAC = 1e-3
LOSS_RTOL = 1e-5
PIPE_LOSS_RTOL = 1e-4  # test_torch_pipeline.py's, pp against one stage
CALL_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def port():
    with spawn(timeout=CALL_TIMEOUT_S) as call:
        call("sp_start", WORLD)
        yield call
        call("sp_stop")


def _jcfg(shape=SHAPE):
    return jl.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                          **shape)


def _weights(shape=SHAPE):
    # copies: JAX's train step donates its state
    return jax.tree.map(np.array, jl.init_params(_jcfg(shape),
                                                 jax.random.PRNGKey(0)))


def _tokens(shape=SHAPE, b=8, s=32, seed=3):
    return np.random.RandomState(seed).randint(
        0, shape["vocab_size"], size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_train():
    """JAX's ``make_train_step`` on fsdp 2 x tp 2 (4 CPU devices):
    (init_state, shard_state, train_step, data sharding)."""
    mesh = MeshSpec(fsdp=2, tp=2).build(jax.devices()[:4])
    return jl.make_train_step(_jcfg(), mesh, learning_rate=LR, loss_chunk=0)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_leaves_close(got, want):
    """test_torch_train.py's rule: at most PARAM_OUTLIER_FRAC of a leaf
    beyond PARAM_ATOL."""
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_leaves_close(got[key], w)
            continue
        diff = np.abs(got[key] - w)
        assert np.mean(diff > PARAM_ATOL) <= PARAM_OUTLIER_FRAC, (
            key, np.sort(diff.ravel())[-5:])


# -- the JAX package's actor-free checkpoint tests, on the port ---------------


def test_checkpoint_manager_recovers_existing(port, tmp_path):
    """A new manager over an existing run dir finds prior checkpoints."""
    done, latest2, latest = port("ckpt_manager_recovers", str(tmp_path))
    assert done
    assert latest2 is not None and latest2 == latest


def test_checkpoint_roundtrip_through_memory_fs(port):
    """CheckpointManager acceptance: save -> finalize -> top-K retention ->
    restore, all through memory:// (inside the port's child)."""
    got = port("ckpt_manager_memory_fs")
    assert got["finalized"] == [1, 2, 3]
    # retention: keep latest (3) + best (2); checkpoint 1 evicted
    assert got["kept"] == [2, 3]
    assert got["best"] == 2 and got["latest"] == 3
    np.testing.assert_allclose(got["restored"], np.arange(6.0).reshape(2, 3))
    assert got["restored_step"] == 2
    # a NEW manager over the same URI recovers the list
    assert got["recovered"] == [2, 3]
    assert got["recovered_best_loss"] == 3.0


def _write_sharded_checkpoint(root, world, full):
    """What ``world`` JAX processes write for an array sharded along dim 0
    (``test_elastic_restore.py``'s synthesis)."""
    s = get_storage(root)
    s.makedirs(root)
    per = full.shape[0] // world
    for r in range(world):
        lo, hi = r * per, (r + 1) * per
        buf = io.BytesIO()
        np.savez(buf, **{"/w": full[lo:hi], "/step": np.asarray(7)})
        s.write_bytes(s.join(root, f"rank_{r}.npz"), buf.getvalue())
        s.write_json(s.join(root, f"manifest_{r}.json"), {
            "metrics": {"step": 7},
            "shards": {"/w": {
                "global_shape": list(full.shape),
                "shards": [{"key": "/w",
                            "index": [[lo, hi], [0, full.shape[1]]]}],
            }},
        })


def test_consolidated_restore_from_different_world_size(port, tmp_path):
    """Rank shards written at world 4 restore as one whole array, and onto
    a skeleton sharded for another layout (fsdp 2: each rank its rows)."""
    full = np.arange(64, dtype=np.float32).reshape(8, 8)
    root = str(tmp_path / "ckpt_w4")
    _write_sharded_checkpoint(root, world=4, full=full)
    assert port("ckpt_num_ranks", root) == 4
    whole = port("ckpt_restore_whole", root, {"w": full, "step": 0})
    np.testing.assert_array_equal(whole["w"], full)
    assert whole["step"] == 7
    for block, step, bounds in port(
            "sp_call", "ckpt_blocks", root, full, dict(dp=4, fsdp=2),
            ("fsdp", None), "load_consolidated"):
        assert step == 7
        np.testing.assert_array_equal(
            block, full[tuple(slice(lo, hi) for lo, hi in bounds)])
        assert block.shape == (4, 8)


def test_snapshot_shard_metadata_shapes(port):
    """A whole state snapshots with no metadata; a rank's block of an
    fsdp-split leaf records the [lo, hi) region that the JAX shard on the
    same mesh position has as its ``index``."""
    full = np.arange(8.0, dtype=np.float32).reshape(4, 2)
    host, meta = port("ckpt_snapshot_whole", {"w": full})
    assert host["/w"].shape == (4, 2) and meta == {}
    per = port("sp_call", "ckpt_snapshot", {"w": full},
               {"w": ("fsdp", None)}, dict(dp=4, fsdp=2))
    mesh = MeshSpec(fsdp=2).build(jax.devices()[:2])
    arr = jax.device_put(jnp.asarray(full),
                         NamedSharding(mesh, PartitionSpec("fsdp", None)))
    want = sorted([[0 if s.start is None else s.start,
                    d if s.stop is None else s.stop]
                   for s, d in zip(shard.index, full.shape)]
                  for shard in arr.addressable_shards)
    got = []
    for rank, (h, m) in enumerate(per):
        rec = m["/w"]
        assert rec["global_shape"] == [4, 2]
        (entry,) = rec["shards"]
        assert entry["key"] == "/w"
        lo, hi = entry["index"][0]
        np.testing.assert_array_equal(h["/w"], full[lo:hi])
        assert h["/w"].shape == (2, 2)
        got.append(entry["index"])
    assert sorted(got[:2]) == want  # dp 0's two fsdp ranks
    assert sorted({i[0][0] for i in got}) == [0, 2]
    # a tensor with no spec would pass its block for the whole leaf
    with pytest.raises(RuntimeError, match="no spec for the tensor leaf"):
        port("sp_call", "ckpt_snapshot", {"w": full, "v": full},
             {"w": ("fsdp", None)}, dict(dp=4, fsdp=2))


def test_load_state_merges_multi_shard_rank_file(port, tmp_path):
    """A rank file holding several shards merges by region on
    ``load_state``; a skeleton that needs regions the file does not hold
    (fsdp 4 wants quarter rows) raises ``ValueError`` naming
    ``load_consolidated``."""
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    root = str(tmp_path / "ckpt_multishard")
    s = get_storage(root)
    s.makedirs(root)
    buf = io.BytesIO()
    np.savez(buf, **{"/w": full[:2], "/w#shard1": full[2:],
                     "/step": np.asarray(3)})
    s.write_bytes(s.join(root, "rank_0.npz"), buf.getvalue())
    s.write_json(s.join(root, "manifest_0.json"), {
        "metrics": {"step": 3},
        "shards": {"/w": {
            "global_shape": [4, 4],
            "shards": [
                {"key": "/w", "index": [[0, 2], [0, 4]]},
                {"key": "/w#shard1", "index": [[2, 4], [0, 4]]},
            ],
        }},
    })
    whole = port("ckpt_restore_whole", root, {"w": full, "step": 0},
                 "load_state")
    np.testing.assert_array_equal(whole["w"], full)
    assert whole["step"] == 3
    for block, step, bounds in port(
            "sp_call", "ckpt_blocks", root, full, dict(dp=4, fsdp=2),
            ("fsdp", None), "load_state"):
        assert step == 3
        np.testing.assert_array_equal(block, full[slice(*bounds[0])])
    for err in port("sp_call", "ckpt_blocks", root, full,
                    dict(dp=2, fsdp=4), ("fsdp", None), "load_state"):
        assert isinstance(err, str) and "load_consolidated" in err


# -- across the two packages --------------------------------------------------


def _optax_keys(weights):
    """The keys of JAX's snapshot of an optax.adamw train state."""
    params = jax.tree.map(jnp.asarray, weights)
    return sorted(snapshot_with_meta(
        (params, optax.adamw(LR).init(params)))[0])


def test_jax_checkpoint_restores_into_port(port, tmp_path, jax_train):
    """JAX's train state after 2 steps on fsdp 2 x tp 2, saved by JAX,
    restores into the port's blocks on 8 ranks (``load_consolidated``):
    every leaf and the count as saved; then one more step of each on the
    same batch: losses within 1e-5, parameters as test_torch_train.py
    holds them."""
    _, shard_state, train_step, data_sharding = jax_train
    weights, toks = _weights(), _tokens()
    params = jax.tree.map(jnp.asarray, weights)
    state = shard_state((params, optax.adamw(LR).init(params)))
    t = jax.device_put(jnp.asarray(toks), data_sharding)
    for _ in range(2):
        state, _ = train_step(state, t)
    root = str(tmp_path / "jax")
    AsyncCheckpointWriter().save(state, root, rank=0, manifest={
        "metrics": {"step": 2}}).result(60)
    saved = _npz(os.path.join(root, "rank_0.npz"))
    assert sorted(saved) == _optax_keys(weights)
    state, want_loss = train_step(state, t)
    want = jax.tree.map(np.asarray, state[0])
    per = port("sp_call", "ckpt_llama_restore", SHAPE, root, toks, LR,
               FSDP_TP)
    restored, _, after = per[0]
    assert restored.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(restored[k], v, err_msg=k)
    assert restored["/1/0/0"] == 2
    for _, loss, _ in per:
        np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    _assert_leaves_close(after, want)


def test_port_checkpoint_restores_into_jax(port, tmp_path, jax_train):
    """The port's train state after 2 steps on fsdp 2 x tp 2, saved by
    the four ranks of one dp replica with shard metadata, restores into
    JAX's sharded skeleton (``load_consolidated``): JAX's keys, every leaf
    and the count as saved; then one more step of each: losses within
    1e-5, parameters as test_torch_train.py holds them."""
    init_state, shard_state, train_step, data_sharding = jax_train
    weights, toks = _weights(), _tokens()
    root = str(tmp_path / "port")
    per = port("sp_call", "ckpt_llama_save", SHAPE, weights, toks, LR,
               FSDP_TP, 2, root, {0: 0, 1: 1, 2: 2, 3: 3})
    losses, saved, after = per[0]
    assert all(p[0] == losses for p in per)
    ckpt = Checkpoint(root)
    assert ckpt.num_ranks() == 4
    assert sorted(_npz(os.path.join(root, "rank_0.npz"))) == _optax_keys(
        weights)
    rec = get_storage(root).read_json(os.path.join(root, "manifest_3.json"))
    assert rec["metrics"] == {"step": 2}
    wq = rec["shards"]["/0/layers/wq"]
    assert wq["global_shape"] == [2, 128, 128]
    assert wq["shards"] == [{"key": "/0/layers/wq",
                             "index": [[0, 2], [64, 128], [64, 128]]}]
    assert "/1/0/0" not in rec["shards"]  # whole leaves: no record
    assert "/0/layers/ln1" not in rec["shards"]
    _, opt = state0 = shard_state(init_state(jax.random.key(1)))
    skeleton = (state0[0], ((opt[0].count, opt[0].mu, opt[0].nu), (), ()))
    restored = ckpt.load_consolidated(skeleton)
    flat = _flatten_with_paths(restored)
    assert flat.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v, err_msg=k)
    state = (restored[0], jax.tree.unflatten(jax.tree.structure(opt),
                                             jax.tree.leaves(restored[1])))
    assert int(state[1][0].count) == 2
    state, loss = train_step(state, jax.device_put(jnp.asarray(toks),
                                                   data_sharding))
    np.testing.assert_allclose(losses[2], float(loss), rtol=LOSS_RTOL)
    _assert_leaves_close(after, jax.tree.map(np.asarray, state[0]))


# -- same world, uneven blocks, pipelines -------------------------------------


def test_same_world_load_state_on_an_uneven_mesh(port, tmp_path):
    """fsdp 4 x tp 2 with vocab 510 (blocks of 128, 128, 128, 126) and ffn
    250: every rank saves, then ``load_state`` into a fresh state gives
    every block, moment and the count back bitwise, and the next step the
    same loss; ``load_consolidated`` into one device gives the gathered
    state and a next-step loss within 1e-5."""
    per = port("sp_call", "ckpt_same_world", UNEVEN, _weights(UNEVEN),
               _tokens(UNEVEN), LR, dict(fsdp=4, tp=2), str(tmp_path))
    for bitwise, loss, loss_restored, _ in per:
        assert bitwise
        assert loss_restored == loss
    same, loss_one = per[0][3]
    assert same
    np.testing.assert_allclose(loss_one, per[0][1], rtol=LOSS_RTOL)


def test_empty_block_saves_and_restores(port, tmp_path):
    """6 heads over tp 4 are blocks of 2, 2, 2 and 0: the empty block is
    written with its [6, 6) region and read back like any other, by the
    port on the same mesh (``load_state``) and whole
    (``load_consolidated``), and by JAX's ``load_consolidated``."""
    rng = np.random.default_rng(0)
    arrays = {"heads": rng.normal(size=(6, 16)).astype(np.float32),
              "w": rng.normal(size=(5, 7)).astype(np.float32)}
    specs = {"heads": ("tp", None), "w": ("dp", "tp")}
    root = str(tmp_path / "empty")
    assert all(port("sp_call", "ckpt_save_blocks", root, arrays, specs,
                    dict(dp=2, tp=4)))
    regions = [get_storage(root).read_json(os.path.join(
        root, f"manifest_{r}.json"))["shards"]["/heads"]["shards"][0][
            "index"] for r in range(WORLD)]
    assert [6, 6] in [r[0] for r in regions]
    whole = port("ckpt_restore_whole", root, arrays)
    jwhole = Checkpoint(root).load_consolidated(
        {k: np.zeros_like(a) for k, a in arrays.items()})
    for k, a in arrays.items():
        np.testing.assert_array_equal(whole[k], a)
        np.testing.assert_array_equal(np.asarray(jwhole[k]), a)


def test_pipeline_state_restores_across_pp(port, tmp_path):
    """A pp 2 x fsdp 2 x tp 2 pipeline state, saved by every rank,
    restores at pp 1 (``load_consolidated`` into a whole stage-stacked
    skeleton, then ``unstack_stages``) as saved, and that single-device
    state, saved, restores into a pp 2 state (a whole layer-stacked
    skeleton, ``stack_stages``, each rank's blocks cut); each next step
    matches the one it continues within test_torch_pipeline.py's loss
    tolerance."""
    per = port("sp_call", "ckpt_pipeline", PIPE, _weights(PIPE),
               _tokens(PIPE, b=4), LR, dict(pp=2, fsdp=2, tp=2), 2,
               str(tmp_path / "pp2"), str(tmp_path / "pp1"))
    (loss_pp, loss_back), (same, loss_one, loss_one_next) = per[0][0], \
        per[0][1]
    assert same
    assert all(p[0] == per[0][0] for p in per)
    np.testing.assert_allclose(loss_one, loss_pp, rtol=PIPE_LOSS_RTOL)
    np.testing.assert_allclose(loss_back, loss_one_next,
                               rtol=PIPE_LOSS_RTOL)


# -- the snapshot, the fresh state --------------------------------------------


def test_snapshot_owns_its_bytes(port):
    """A snapshot taken before the train step's in-place AdamW update, and
    a save started before it, keep the pre-step values."""
    small = dict(SHAPE, n_heads=4, n_kv_heads=2)
    before, copy, after, from_file = port(
        "ckpt_snapshot_owns", small, _weights(small), _tokens(small, b=2),
        LR)
    assert before.keys() == copy.keys() == after.keys() == from_file.keys()
    for k in before:
        np.testing.assert_array_equal(before[k], copy[k], err_msg=k)
        np.testing.assert_array_equal(from_file[k], copy[k], err_msg=k)
    assert int(before["/1/0/0"]) == 1 and int(after["/1/0/0"]) == 2
    assert not np.array_equal(after["/0/norm"], before["/0/norm"])
    assert not np.array_equal(after["/1/0/1/norm"], before["/1/0/1/norm"])


def test_fresh_state_saves_optax_init(port):
    """An optimizer that has not stepped saves what ``optax.adamw(lr)
    .init`` holds: the same keys, zero moments and an int32 count of 0;
    restoring it builds every parameter's AdamW state."""
    small = dict(SHAPE, n_heads=4, n_kv_heads=2)
    weights = _weights(small)
    host, facts = port("ckpt_fresh_state", small, weights, LR)
    params = jax.tree.map(jnp.asarray, weights)
    want, meta = snapshot_with_meta((params, optax.adamw(LR).init(params)))
    assert meta == {} and sorted(host) == sorted(want)
    for k, w in want.items():
        assert host[k].dtype == w.dtype and host[k].shape == w.shape, k
        np.testing.assert_array_equal(host[k], w, err_msg=k)
    assert host["/1/0/0"].dtype == np.int32 and host["/1/0/0"] == 0
    assert facts == dict(built=True, steps={0.0}, zero=True,
                         dtypes={"torch.float32"}, params_equal=True)
