"""Checkpoints of the port's state in the JAX package's on-disk layout —
counterpart of ``ray_tpu/train/_checkpoint.py``.

A checkpoint is a directory holding one ``rank_<k>.npz`` per saving
process (numpy arrays under the pytree paths of ``_flatten_with_paths``)
and a ``manifest_<k>.json`` whose ``"shards"`` record, for each leaf the
process holds only a block of, the global shape and the block's [lo, hi)
in each dim. The layout is the JAX package's, so either package restores
the other's checkpoints, at the same world size (``load_state``) or at
another (``load_consolidated``).

What differs is where the sharding comes from. A jax.Array carries its
sharding; a rank's tensor is only its block. So the snapshot and the
restores take the state's specs (``P`` trees such as
``models/llama.py::param_specs``) and the mesh, and a block's index comes
from ``parallel/mesh.py::block_bounds``, the arithmetic ``shard_of`` cuts
with (GSPMD's blocks: the last short or empty; an empty block is written
and read like any other). A leaf that no axis of size > 1 splits is
written whole, as JAX writes a replicated leaf, and every replica of a
leaf writes it, as every JAX process does.

The train state in optax's layout: ``train_state_tree(params, optimizer)``
gives ``(params, ((count, mu, nu), (), ()))``, the state of
``optax.adamw`` (scale_by_adam, then two links with empty states) as plain
tuples, which is what the JAX package's ``_unflatten_from_paths`` rebuilds
too. Its keys are ``/0/...`` (the parameters), ``/1/0/0`` (the step count,
int32), ``/1/0/1/...`` (AdamW's exp_avg, optax's mu) and ``/1/0/2/...``
(exp_avg_sq, nu). ``load_train_state`` puts a restored tree back into the
parameters and the torch AdamW.

Saves are asynchronous, as in JAX: ``AsyncCheckpointWriter.save`` copies
the state to host memory before it returns (copies that own their bytes:
the train step updates parameters and moments in place meanwhile) and
writes the file on a background thread, at most one write in flight.
``CheckpointManager`` (finalize, top-K retention, recovery of an existing
run) is the JAX package's, copied.
"""

from __future__ import annotations

import io
import json
import math
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.models.convert import nest_map
from ray_tpu_torch.parallel.mesh import (P, block_bounds, global_shapes,
                                        is_split, shard_of)
from ray_tpu_torch.train._storage import get_storage


# ---------------------------------------------------------------------------
# pytree <-> npz (the JAX package's, copied)
# ---------------------------------------------------------------------------


def _flatten_with_paths(tree, prefix=""):
    """Flatten a nested dict/list/tuple pytree into {path: leaf}."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, f"{prefix}/{i}"))
    else:
        out[prefix or "/"] = tree
    return out


def _unflatten_from_paths(flat: Dict[str, Any], skeleton):
    """Rebuild `skeleton`'s structure with leaves taken from `flat`."""

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(node[k], f"{prefix}/{k}") for k in node}
        if isinstance(node, tuple):
            return tuple(
                build(v, f"{prefix}/{i}") for i, v in enumerate(node)
            )
        if isinstance(node, list):
            return [build(v, f"{prefix}/{i}") for i, v in enumerate(node)]
        return flat[prefix or "/"]

    return build(skeleton, "")


def _leaf_specs(tree, specs) -> Dict[str, Any]:
    """{path: spec} for the leaves of ``tree``. ``specs`` follows the
    nesting of ``tree`` down to each leaf, where it holds the leaf's spec
    (a ``P``); None there, or for a whole subtree, means whole, and so
    does ``specs`` None. A tensor leaf that ``specs`` has no entry for
    raises ``ValueError``: its block would pass for the whole leaf."""
    out = {}
    missing = object()

    def walk(node, spec, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec.get(k, missing) if isinstance(spec, dict)
                     else spec, f"{prefix}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, (spec[i] if i < len(spec) else missing)
                     if isinstance(spec, (list, tuple)) else spec,
                     f"{prefix}/{i}")
        elif spec is missing:
            if torch.is_tensor(node):
                raise ValueError(f"no spec for the tensor leaf "
                                 f"{prefix or '/'!r}")
            out[prefix or "/"] = None
        else:
            out[prefix or "/"] = spec

    walk(tree, specs, "")
    return out


def _split_leaves(state, specs, mesh) -> Dict[str, Any]:
    """{path: spec} of the tensor leaves of ``state`` that ``mesh`` splits
    under ``specs``: the leaves a rank holds only a block of."""
    if specs is None or mesh is None:
        return {}
    flat = _flatten_with_paths(state)
    return {path: spec for path, spec in _leaf_specs(state, specs).items()
            if spec is not None and torch.is_tensor(flat[path])
            and is_split(spec, mesh)}


def global_leaf_shapes(state, specs, mesh) -> Dict[str, tuple]:
    """{path: global shape} of the leaves of ``state`` (this rank's blocks)
    that ``mesh`` splits under ``specs``: what ``snapshot_with_meta``
    records. One all-reduce for each combination of axes
    (``parallel.mesh.global_shapes``): every rank calls it together. Pass
    the result as ``shapes`` to save from some of the ranks alone."""
    split = _split_leaves(state, specs, mesh)
    flat = _flatten_with_paths(state)
    return dict(zip(split, global_shapes([flat[p] for p in split],
                                         list(split.values()), mesh)))


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that owns its bytes: on the CPU
    ``.numpy()`` would alias a tensor that the train step updates in
    place. bf16 is widened to fp32 (numpy has no bf16), exactly."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf)


def snapshot_to_host(state, specs=None, mesh=None, shapes=None
                     ) -> Dict[str, np.ndarray]:
    """Device→host snapshot of a pytree's leaves (sync)."""
    return snapshot_with_meta(state, specs, mesh, shapes)[0]


def snapshot_with_meta(state, specs=None, mesh=None, shapes=None):
    """Host copies of the leaves of ``state`` ({path: array}, each owning
    its bytes) and the shard metadata of the leaves this rank holds only a
    block of, as the JAX package records it: {path: {"global_shape": [...],
    "shards": [{"key": path, "index": [[lo, hi], ...]}]}}.

    ``specs`` (a tree of specs that follows ``state``, None for whole
    leaves) and ``mesh`` say which leaves are blocks; without them every
    leaf is whole, as in a single-process JAX save. A rank is one mesh
    position, so it holds one block of a leaf. The global shapes come
    from ``shapes`` ({path: shape}, ``global_leaf_shapes``) or else from
    one all-reduce, for which every rank calls this together."""
    split = _split_leaves(state, specs, mesh)
    if split and shapes is None:
        shapes = global_leaf_shapes(state, specs, mesh)
    out: Dict[str, np.ndarray] = {}
    meta: Dict[str, Any] = {}
    for path, leaf in _flatten_with_paths(state).items():
        out[path] = _to_host(leaf)
        if path not in split:
            continue
        index = block_bounds(shapes[path], split[path], mesh)
        if [hi - lo for lo, hi in index] != list(out[path].shape):
            raise ValueError(
                f"leaf {path!r} of shape {tuple(out[path].shape)} is not "
                f"this rank's block {index} of {tuple(shapes[path])} under "
                f"{split[path]}")
        meta[path] = {"global_shape": list(shapes[path]),
                      "shards": [{"key": path, "index": index}]}
    return out, meta


def _place(ref_leaf, new_leaf):
    """``new_leaf`` onto the skeleton's leaf: a tensor is written in place,
    on its own device and in its own dtype (a parameter or a moment keeps
    its identity, which the optimizer holds it by); a Python number takes
    its type; anything else is the restored array."""
    if new_leaf is ref_leaf:
        return ref_leaf
    if torch.is_tensor(ref_leaf):
        new = torch.as_tensor(np.asarray(new_leaf)) \
            if not torch.is_tensor(new_leaf) else new_leaf
        if tuple(new.shape) != tuple(ref_leaf.shape):
            raise ValueError(
                f"restored leaf of shape {tuple(new.shape)} does not fit the "
                f"skeleton's {tuple(ref_leaf.shape)}")
        with torch.no_grad():
            ref_leaf.copy_(new)
        return ref_leaf
    if isinstance(ref_leaf, (int, float)):
        return type(ref_leaf)(new_leaf)
    return new_leaf


def _place_onto(skeleton, rebuilt):
    """Place restored host leaves onto the skeleton's tensors, in place."""
    flat_new = _flatten_with_paths(rebuilt)
    return _unflatten_from_paths(
        {path: _place(ref, flat_new[path])
         for path, ref in _flatten_with_paths(skeleton).items()}, skeleton)


def _block_of(whole: np.ndarray, ref_leaf, spec, mesh):
    """The skeleton's block of a whole restored leaf (``shard_of``)."""
    if not torch.is_tensor(ref_leaf) or spec is None or mesh is None:
        return whole
    return shard_of(torch.from_numpy(np.asarray(whole)), spec, mesh)


def _region_size(region) -> int:
    return math.prod(hi - lo for lo, hi in region)


def _from_regions(by_region: Dict[tuple, np.ndarray], needed):
    """The block at ``needed`` ([lo, hi) a dim) from a rank file's saved
    blocks {region: array}: the saved block of that region, or the saved
    blocks that tile it merged (a file holding several shards, as a JAX
    process driving several devices writes); None when they do not."""
    key = tuple(map(tuple, needed))
    if key in by_region:
        return by_region[key]
    inside = [(r, a) for r, a in by_region.items()
              if all(nlo <= lo and hi <= nhi
                     for (lo, hi), (nlo, nhi) in zip(r, needed))]
    if sum(_region_size(r) for r, _ in inside) != _region_size(needed):
        return None
    dtype = next(iter(by_region.values())).dtype
    out = np.empty([hi - lo for lo, hi in needed], dtype)
    for region, block in inside:
        out[tuple(slice(lo - nlo, hi - nlo) for (lo, hi), (nlo, _)
                  in zip(region, needed))] = block
    return out


def _read_rank(storage, path: str, rank: int):
    """({npz key: array}, the manifest's shard records) of one rank."""
    with np.load(io.BytesIO(storage.read_bytes(
            storage.join(path, f"rank_{rank}.npz")))) as z:
        data = {k: z[k] for k in z.files}
    try:
        shards = storage.read_json(storage.join(
            path, f"manifest_{rank}.json")).get("shards", {})
    except FileNotFoundError:  # a checkpoint without shard metadata
        shards = {}
    return data, shards


@dataclass
class Checkpoint:
    """A checkpoint directory under a StorageContext URI (reference:
    train/_checkpoint.py:56 + storage.py — `path` may be a plain local dir
    or any fsspec URI such as memory://... or gs://...)."""

    path: str
    metrics: Dict[str, Any] = field(default_factory=dict)

    def _storage(self):
        return get_storage(self.path)

    def rank_file(self, rank: int) -> str:
        return self._storage().join(self.path, f"rank_{rank}.npz")

    @property
    def step(self) -> int:
        return int(self.metrics.get("step", -1))

    def load_state(self, skeleton, rank: int = 0, specs=None, mesh=None):
        """Restore rank ``rank``'s file into ``skeleton`` (this rank's
        state: its blocks under ``specs`` on ``mesh``; none of them for a
        whole state), writing each tensor leaf in place.

        A leaf saved as blocks is served from the block of the region the
        skeleton's leaf holds (``block_bounds`` of the saved global shape),
        or from several saved blocks that tile it (a rank file holding
        several shards); a leaf saved whole is cut to the skeleton's
        block. Where the file holds no such region (the world size or the
        sharding changed) this raises ``ValueError``: that restore is
        ``load_consolidated``'s. Nothing is merged into a global-shape
        buffer, so a rank's restore holds its blocks only."""
        data, shards_meta = _read_rank(self._storage(), self.path, rank)
        flat = {k: v for k, v in data.items()
                if "#shard" not in k and k not in shards_meta}
        partial = {
            path: {tuple(map(tuple, e["index"])): data[e["key"]]
                   for e in rec["shards"]}
            for path, rec in shards_meta.items()}
        leaf_specs = _leaf_specs(skeleton, specs)
        placed: Dict[str, Any] = {}
        for path, ref_leaf in _flatten_with_paths(skeleton).items():
            spec = leaf_specs[path]
            if path not in partial:
                placed[path] = _place(ref_leaf, _block_of(
                    flat[path], ref_leaf, spec, mesh))
                continue
            needed = block_bounds(shards_meta[path]["global_shape"],
                                  spec or P(), mesh)
            block = _from_regions(partial[path], needed)
            if block is None:
                raise ValueError(
                    f"checkpoint leaf {path!r} was saved with different "
                    f"local shard regions than the restore sharding "
                    f"expects (world size or sharding changed) — use "
                    f"load_consolidated() instead of load_state()")
            placed[path] = _place(ref_leaf, block)
        return _unflatten_from_paths(placed, skeleton)

    def _rank_ids(self) -> List[int]:
        s = self._storage()
        return sorted(
            int(f[len("rank_"):-len(".npz")])
            for f in s.listdir(self.path)
            if f.startswith("rank_") and f.endswith(".npz"))

    def num_ranks(self) -> int:
        return len(self._rank_ids())

    def load_consolidated(self, skeleton, specs=None, mesh=None):
        """Cross-world-size restore: merge EVERY rank's blocks into whole
        arrays by the shard metadata the writers recorded, then cut this
        rank's blocks of ``skeleton`` (``specs`` on ``mesh``; the whole
        arrays for a whole state) and write them in place — a checkpoint
        saved at world size N restores at any world size M. Replicated
        leaves take the first rank's copy. Streams one rank file at a
        time, as JAX does: peak host memory is one whole state plus one
        rank's file."""
        s = self._storage()
        ranks = self._rank_ids()
        if not ranks:
            raise FileNotFoundError(f"no rank shards in {self.path}")
        flat: Dict[str, np.ndarray] = {}
        for pos, r in enumerate(ranks):
            data, shards_meta = _read_rank(s, self.path, r)
            for path, rec in shards_meta.items():
                if path not in flat:
                    flat[path] = np.zeros(
                        rec["global_shape"],
                        data[rec["shards"][0]["key"]].dtype)
                for e in rec["shards"]:
                    region = tuple(slice(lo, hi) for lo, hi in e["index"])
                    flat[path][region] = data[e["key"]]
            if pos == 0:
                for k, v in data.items():
                    if "#shard" in k or k in shards_meta:
                        continue
                    flat.setdefault(k, v)
            del data
        leaf_specs = _leaf_specs(skeleton, specs)
        return _unflatten_from_paths(
            {path: _place(ref, _block_of(flat[path], ref, leaf_specs[path],
                                         mesh))
             for path, ref in _flatten_with_paths(skeleton).items()},
            skeleton)

    def to_wire(self) -> dict:
        return {"path": self.path, "metrics": self.metrics}

    @classmethod
    def from_wire(cls, w: dict) -> "Checkpoint":
        return cls(path=w["path"], metrics=dict(w.get("metrics") or {}))


class AsyncCheckpointWriter:
    """Double-buffered async writer: snapshot now, write in the background.

    At most one write in flight; a second save blocks until the first lands
    (backpressure instead of unbounded host-memory growth) — the same
    discipline as orbax's async checkpointer.
    """

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-write")
        self._inflight: Optional[Future] = None
        self._lock = threading.Lock()

    def save(self, state, path: str, rank: int = 0,
             manifest: Optional[dict] = None, specs=None, mesh=None,
             shapes=None) -> Future:
        """Snapshot ``state`` (``snapshot_with_meta``: ``specs``,
        ``mesh`` and ``shapes`` as there) to host memory now, and write
        ``rank_<rank>.npz`` (and ``manifest_<rank>.json``) under ``path``
        in the background. Returns the write's future."""
        host, shard_meta = snapshot_with_meta(state, specs, mesh, shapes)
        if shard_meta:
            manifest = dict(manifest or {})
            manifest["shards"] = shard_meta
        with self._lock:
            if self._inflight is not None:
                self._inflight.result()  # backpressure

            def write():
                storage = get_storage(path)
                storage.makedirs(path)
                buf = io.BytesIO()
                np.savez(buf, **host)
                # tmp-name + rename publish: finalize counts rank_* files,
                # so the final name must never be visible mid-write (atomic
                # os.replace on local filesystems; object-store uploads are
                # atomic per object anyway)
                tmp = storage.join(path, f".rank_{rank}.tmp.npz")
                storage.write_bytes(tmp, buf.getvalue())
                # manifest FIRST: finalize promotes the dir as soon as all
                # rank_* files exist, and the (load-bearing) shard metadata
                # must already be inside when that happens
                if manifest is not None:
                    storage.write_json(
                        storage.join(path, f"manifest_{rank}.json"), manifest)
                storage.rename(tmp, storage.join(path, f"rank_{rank}.npz"))

            fut = self._pool.submit(write)
            self._inflight = fut
            return fut

    def wait(self):
        with self._lock:
            fut = self._inflight
        if fut is not None:
            fut.result()


# ---------------------------------------------------------------------------
# the train state in optax's layout
# ---------------------------------------------------------------------------


def train_state_tree(params, optimizer: torch.optim.Optimizer):
    """``(params, ((count, mu, nu), (), ()))``: the port's parameters and
    torch AdamW as ``optax.adamw``'s state pytree, so a checkpoint of it
    has the JAX package's keys (``/0/...``, ``/1/0/0``, ``/1/0/1/...``,
    ``/1/0/2/...``). The parameters and the moments are the live tensors
    (a snapshot copies them; a restore into this tree as its skeleton
    writes them in place); ``count`` is an int32 0-dim tensor. An
    optimizer that has not stepped (torch creates its state at the first
    step) gives zero moments and count 0, as ``optax.adamw(...).init``."""
    state = optimizer.state
    counts = [int(state[p]["step"]) for p in _leaves(params)
              if p in state and "step" in state[p]]
    count = torch.tensor(counts[0] if counts else 0, dtype=torch.int32)

    def moment(name):
        return nest_map(
            lambda p: state[p][name].detach() if p in state
            and name in state[p] else torch.zeros_like(p).detach(), params)

    return params, ((count, moment("exp_avg"), moment("exp_avg_sq")), (), ())


def train_state_specs(specs):
    """The specs of ``train_state_tree``'s tree from the parameters' specs
    (``param_specs(cfg)``, ``pipeline_param_specs(cfg)``): each moment
    placed as its parameter, the count whole."""
    return specs, ((P(), specs, specs), (), ())


def load_train_state(tree, params, optimizer: torch.optim.Optimizer):
    """Put a restored ``train_state_tree`` tree back: each parameter and
    its AdamW state (``step``, ``exp_avg``, ``exp_avg_sq``) copied in place
    (the optimizer holds the parameters by identity), the state built for
    every parameter where torch has not made it yet, on the parameter's
    device and in its dtype. ``step`` is fp32 on the parameter's device
    for a fused (or capturable) optimizer and on the CPU otherwise, as
    torch makes it. Returns (params, optimizer)."""
    saved, ((count, mu, nu), *_) = tree
    count = float(np.asarray(count.cpu() if torch.is_tensor(count)
                             else count))
    groups = {id(p): g for g in optimizer.param_groups for p in g["params"]}
    flat_mu, flat_nu = _flatten_with_paths(mu), _flatten_with_paths(nu)
    flat_saved = _flatten_with_paths(saved)
    with torch.no_grad():
        for path, p in _flatten_with_paths(params).items():
            group = groups[id(p)]
            if group.get("amsgrad"):
                raise ValueError("optax.adamw has no amsgrad state")
            _place(p, flat_saved[path])
            st = optimizer.state[p]
            on_device = group.get("fused") or group.get("capturable")
            st["step"] = torch.tensor(
                count, dtype=torch.float32,
                device=p.device if on_device else "cpu")
            for name, value in (("exp_avg", flat_mu[path]),
                                ("exp_avg_sq", flat_nu[path])):
                if name not in st:
                    st[name] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                _place(st[name], value)
    return params, optimizer


def _leaves(tree) -> list:
    return list(_flatten_with_paths(tree).values())


def staging_dir_name(step: int, generation: int = 0) -> str:
    """THE staging-dir name format — writers (TrainWorker's staging_fn)
    and the finalizer/purger (CheckpointManager) must agree on it, or
    shards land in dirs finalize() never looks at and checkpoints silently
    stop finalizing."""
    return f".staging_checkpoint_g{generation:04d}_{step:09d}"


class CheckpointManager:
    """Tracks finalized checkpoints; retains latest + top-K by metric.

    Reference: train/v2/_internal/execution/checkpoint/checkpoint_manager.py.
    """

    def __init__(self, storage_path: str, run_name: str,
                 num_to_keep: int = 2,
                 metric: Optional[str] = None, mode: str = "min"):
        self.storage = get_storage(storage_path)
        self.run_dir = self.storage.join(storage_path, run_name)
        self.storage.makedirs(self.run_dir)
        self.num_to_keep = max(1, num_to_keep)
        self.metric = metric
        self.mode = mode
        self.checkpoints: List[Checkpoint] = []
        self._load_existing()

    # -- paths ----------------------------------------------------------

    def staging_dir(self, step: int, generation: int = 0) -> str:
        """Staging dirs are scoped by gang GENERATION: a live resize
        purges only generations older than the committed one, so a
        joiner/survivor checkpoint write in flight at the commit can
        never race the purge of the previous layout's partial shards."""
        return self.storage.join(self.run_dir,
                                 staging_dir_name(step, generation))

    def final_dir(self, step: int) -> str:
        return self.storage.join(self.run_dir, f"checkpoint_{step:09d}")

    def _load_existing(self):
        """Recover the checkpoint list after a controller restart."""
        if not self.storage.isdir(self.run_dir):
            return
        for name in self.storage.listdir(self.run_dir):
            if not name.startswith("checkpoint_"):
                continue
            path = self.storage.join(self.run_dir, name)
            metrics = {}
            for f in self.storage.listdir(path):
                if f.startswith("manifest_"):
                    try:
                        metrics = self.storage.read_json(
                            self.storage.join(path, f)).get("metrics", {})
                        break
                    except (OSError, json.JSONDecodeError):
                        pass
            try:
                # rank manifests predate finalize and lack "step"; the
                # directory name is authoritative
                metrics.setdefault("step", int(name.rsplit("_", 1)[-1]))
            except ValueError:
                pass
            self.checkpoints.append(Checkpoint(path, metrics))

    # -- lifecycle ------------------------------------------------------

    def finalize(self, step: int, metrics: Dict[str, Any],
                 expected_ranks: int,
                 generation: int = 0) -> Optional[Checkpoint]:
        """Promote a staging dir once all ranks have written their shard.

        Idempotent per step: a step id can be REPORTED twice (a rank's
        local counter repeating across an elastic resize, or a restarted
        incarnation re-reporting its resume step) — the first promotion
        wins and the duplicate staging dir is dropped instead of crashing
        the controller on a rename-over-existing-dir."""
        staging = self.staging_dir(step, generation)
        final = self.final_dir(step)
        existing = next((c for c in self.checkpoints if c.path == final),
                        None)
        if not self.storage.isdir(staging):
            if self.storage.isdir(final):
                return existing or Checkpoint(final, dict(metrics))
            return None
        present = [f for f in self.storage.listdir(staging)
                   if f.startswith("rank_")]
        if len(present) < expected_ranks:
            return None
        if self.storage.isdir(final):
            # duplicate step: first promotion wins. Leave the staging dir
            # in place — ranks checkpoint with skew, and deleting it here
            # would race a slower rank's in-flight shard write (the purge
            # paths reap it once no writer can still target it).
            return existing or Checkpoint(final, dict(metrics))
        metrics = dict(metrics)
        metrics.setdefault("step", step)
        self.storage.rename(staging, final)
        ckpt = Checkpoint(final, metrics)
        self.checkpoints.append(ckpt)
        self._enforce_retention()
        return ckpt

    def _score(self, c: Checkpoint):
        if self.metric is None or self.metric not in c.metrics:
            return None
        v = float(c.metrics[self.metric])
        return -v if self.mode == "min" else v

    def _enforce_retention(self):
        if len(self.checkpoints) <= self.num_to_keep:
            return
        latest = self.checkpoints[-1]
        ranked = [c for c in self.checkpoints[:-1]]
        if self.metric is not None:
            ranked.sort(key=lambda c: (self._score(c) is None,
                                       -(self._score(c) or 0.0)))
        keep = {c.path for c in ranked[: self.num_to_keep - 1]}
        keep.add(latest.path)
        for c in list(self.checkpoints):
            if c.path not in keep:
                self.checkpoints.remove(c)
                self.storage.delete(c.path)

    def step_orphaned(self, step: int, generation: int = 0) -> bool:
        """Neither a staging dir nor a final dir exists for the step.
        Rank shard writes complete BEFORE the announcing report is queued
        (report() blocks on the writer future), so an orphaned step can
        only mean its staging dir was purged (resize commit / restart) —
        the pending entry will never finalize and should be dropped."""
        return (not self.storage.isdir(self.staging_dir(step, generation))
                and not self.storage.isdir(self.final_dir(step)))

    def purge_staging(self, below_generation: Optional[int] = None):
        """Drop partial staging dirs whose rank layout can no longer
        complete. With `below_generation`, only generations OLDER than it
        are purged — a live resize commit must never delete a dir the
        renumbered gang's writers are actively filling. Without it (a
        worker-group restart, where every writer is already dead), all
        staging dirs drop."""
        try:
            for name in self.storage.listdir(self.run_dir):
                if not name.startswith(".staging_checkpoint_"):
                    continue
                if below_generation is not None:
                    gen = 0
                    tail = name[len(".staging_checkpoint_"):]
                    if tail.startswith("g"):
                        try:
                            gen = int(tail[1:].split("_", 1)[0])
                        except ValueError:
                            pass
                    if gen >= below_generation:
                        continue
                self.storage.delete(self.storage.join(self.run_dir, name))
        except OSError:
            pass

    @property
    def latest(self) -> Optional[Checkpoint]:
        return self.checkpoints[-1] if self.checkpoints else None

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self.checkpoints:
            return None
        scored = [(self._score(c), c) for c in self.checkpoints]
        with_metric = [(s, c) for s, c in scored if s is not None]
        if not with_metric:
            return self.latest
        return max(with_metric, key=lambda sc: sc[0])[1]
