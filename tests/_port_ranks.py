"""One gloo process group of rank processes for the multi-rank parity tests
(``test_torch_ring_attention.py``, ``test_torch_sequence_parallel.py``,
``test_torch_model_parallel.py``, ``test_torch_vit.py``,
``test_torch_moe.py``, ``test_torch_pipeline.py``).

``_port_side`` (in the child that ``_port_proc.spawn`` starts) creates a
``Ranks`` once per test module; its processes join one gloo group through
a file store and serve ``Ranks.call(name, ...)``, which runs the function
``name`` of this module on every rank and returns the results in rank
order. Inputs and results are numpy arrays and plain Python values: each
rank cuts its own block out of the global inputs, the caller assembles the
blocks. Ranks run one CPU thread each.

With ``PORT_RANKS_TIMES=<file>`` set, ``close`` appends one JSON line to
that file: the seconds the ranks took to start and the seconds spent in
``call``, the gloo work a test module costs apart from JAX's side.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np

GLOO_TIMEOUT_S = 60   # a collective that waits on a failed rank gives up
RESULT_TIMEOUT_S = 2 * GLOO_TIMEOUT_S


class Ranks:
    def __init__(self, world: int):
        ctx = multiprocessing.get_context("spawn")
        t0 = time.monotonic()
        self.world = world
        self.dir = tempfile.mkdtemp(prefix="port_ranks_")
        store = os.path.join(self.dir, "store")
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_main, daemon=True, args=(
            r, world, store, self.tasks[r], self.results))
            for r in range(world)]
        for p in self.procs:
            p.start()
        self._call("ready", (), {})
        self.start_s, self.busy_s, self.calls = time.monotonic() - t0, 0.0, 0

    def call(self, name, *args, **kwargs):
        """``name(*args, **kwargs)`` on every rank: the results in rank
        order; raises with every failed rank's traceback."""
        t0 = time.monotonic()
        try:
            return self._call(name, args, kwargs)
        finally:
            self.busy_s += time.monotonic() - t0
            self.calls += 1

    def _call(self, name, args, kwargs):
        for q in self.tasks:
            q.put((name, args, kwargs))
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=RESULT_TIMEOUT_S)
            except queue.Empty:
                raise TimeoutError(f"{name}: a rank gave no result in "
                                   f"{RESULT_TIMEOUT_S} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise RuntimeError(f"{name} failed on {len(errors)} rank(s):\n"
                               + "\n".join(errors))
        return out

    def close(self):
        if not self.procs:
            return
        for q in self.tasks:
            q.put(None)
        procs, self.procs = self.procs, []
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self.dir, ignore_errors=True)
        if os.environ.get("PORT_RANKS_TIMES"):
            with open(os.environ["PORT_RANKS_TIMES"], "a") as f:
                f.write(json.dumps(dict(
                    world=self.world, start_s=self.start_s,
                    busy_s=self.busy_s, calls=self.calls)) + "\n")


def _main(rank, world, store, tasks, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    while True:
        item = tasks.get()
        if item is None:
            break
        name, args, kwargs = item
        try:
            results.put((rank, True, globals()[name](*args, **kwargs)))
        except Exception:  # reported to the caller, which raises
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


# -- functions the ranks run ---------------------------------------------------

_MESHES = {}


def ready():
    return True


def _mesh(dp, sp, fsdp=1, tp=1, pp=1):
    """The (pp, dp, fsdp, tp, sp) mesh over the whole group, built once
    (building one creates process groups: every rank builds them in the
    same order)."""
    from ray_tpu_torch.parallel.mesh import MeshSpec

    key = (pp, dp, fsdp, tp, sp)
    if key not in _MESHES:
        _MESHES[key] = MeshSpec(pp=pp, dp=dp, fsdp=fsdp, tp=tp,
                                sp=sp).build()
    return _MESHES[key]


def _axes_mesh(axes):
    """``_mesh`` of a dict of axis sizes (absent axes 1)."""
    return _mesh(axes.get("dp", 1), axes.get("sp", 1), axes.get("fsdp", 1),
                 axes.get("tp", 1), axes.get("pp", 1))


def _cfg(shape, impl):
    import torch

    from ray_tpu_torch.models import llama as tl

    return tl.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                          attention_impl=impl, **shape)


def _np(x):
    return x.detach().cpu().numpy()


def mesh_facts(dp, sp):
    """What ``MeshSpec(dp, sp).build()`` gives this rank."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import axis_index, mesh_shape

    mesh = _mesh(dp, sp)
    return dict(rank=dist.get_rank(), names=tuple(mesh.mesh_dim_names),
                shape=mesh_shape(mesh),
                index={a: axis_index(mesh, a) for a in ("dp", "sp")},
                sp_ranks=dist.get_process_group_ranks(mesh.get_group("sp")))


def launches():
    from ray_tpu_torch.ops import flash_attention as fa

    return (fa.flash_fwd_launches, fa.flash_bwd_dq_launches,
            fa.flash_bwd_dkv_launches, fa.flash_chunk_launches)


def sharded_attention(impl, sp, q, k, v, g, causal=True):
    """``ring_attention_sharded`` or ``ulysses_attention_sharded`` on this
    rank's sequence shard of the global (b, s, h, hd) q/k/v, and the
    gradients of <out, g>: this rank's (out, dq, dk, dv) shards."""
    import torch

    from ray_tpu_torch.parallel import mesh as pm
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    mesh = _mesh(1, sp)
    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded}[impl]
    n = q.shape[1] // sp
    cut = slice(pm.axis_index(mesh, "sp") * n, (pm.axis_index(mesh, "sp") + 1)
                * n)
    qs, ks, vs = (torch.from_numpy(np.ascontiguousarray(t[:, cut]))
                  .requires_grad_() for t in (q, k, v))
    out = fn(qs, ks, vs, mesh, causal=causal)
    out.backward(torch.from_numpy(np.ascontiguousarray(g[:, cut])))
    return tuple(_np(t) for t in (out, qs.grad, ks.grad, vs.grad))


def forward(shape, tree, tokens, impl, dp, sp, fsdp=1, tp=1, pp=1):
    """This rank's logits block of ``forward`` on the (pp, dp, fsdp, tp,
    sp) mesh from its blocks of the carried weights, and the block's (row,
    column) offsets in the global logits."""
    import torch

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel.mesh import axis_index

    mesh = _mesh(dp, sp, fsdp, tp, pp)
    cfg = _cfg(shape, impl)
    params = tl.shard_params(cfg, params_from_jax(tree, "cpu"), mesh)
    with torch.no_grad():
        logits = tl.forward(cfg, params, torch.from_numpy(tokens), mesh)
    b, s = tokens.shape
    row = axis_index(mesh, "dp") * fsdp + axis_index(mesh, "fsdp")
    return (_np(logits), row * b // (dp * fsdp),
            axis_index(mesh, "sp") * s // sp)


def loss(shape, tree, tokens, impl, dp, sp, fsdp=1, tp=1):
    """``loss_fn`` on the (dp, fsdp, tp, sp) mesh (no mesh when dp is
    None)."""
    import torch

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    cfg = _cfg(shape, impl)
    mesh = None if dp is None else _mesh(dp, sp, fsdp, tp)
    params = params_from_jax(tree, "cpu")
    if mesh is not None:
        params = tl.shard_params(cfg, params, mesh)
    with torch.no_grad():
        return float(tl.loss_fn(cfg, params, torch.from_numpy(tokens), mesh))


def train(shape, tree, tokens, impl, remat, loss_chunk, steps, lr, dp, sp,
          fsdp=1, tp=1, with_grads=False, pp=1):
    """Losses of ``steps`` steps of ``make_train_step`` on the (pp, dp,
    fsdp, tp, sp) mesh from the carried weights, and the launch counters;
    rank 0
    also returns the global parameters after them and, ``with_grads``, the
    global gradients of the first step (nested numpy; ``gather_state`` and
    ``gather_full``, which every rank runs)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel.mesh import gather_full, tree_map

    cfg = _cfg(shape, impl)
    mesh = _mesh(dp, sp, fsdp, tp, pp)
    init_state, shard_state, train_step, dev = tl.make_train_step(
        cfg, mesh, learning_rate=lr, remat=remat, loss_chunk=loss_chunk,
        device="cpu")
    state = shard_state(init_state(params_from_jax(tree, "cpu")))
    toks = torch.from_numpy(tokens).to(dev)
    losses, grads = [], None
    for _ in range(steps):
        state, loss = train_step(state, toks)
        losses.append(float(loss))
        if with_grads and grads is None:
            grads = tree_map(lambda t, spec: _np(gather_full(
                t.grad, spec, mesh)), state[0], tl.param_specs(cfg))
    params = tree_map(_np, tl.gather_state(cfg, state, mesh))
    if dist.get_rank() != 0:
        params = grads = None
    if with_grads:
        return losses, params, launches(), grads
    return losses, params, launches()


def shards(arrays, specs, dp, fsdp, tp, sp):
    """This rank's ``shard_of`` block of each global array under its spec
    (a tuple per dim), and whether ``gather_full`` of the block gives the
    array back."""
    import torch

    from ray_tpu_torch.parallel.mesh import gather_full, shard_of

    mesh = _mesh(dp, sp, fsdp, tp)
    out = []
    for a, spec in zip(arrays, specs):
        block = shard_of(torch.from_numpy(a), spec, mesh)
        back = gather_full(block.contiguous(), spec, mesh)
        out.append((_np(block), bool(np.array_equal(_np(back), a))))
    return out


def shard_global_state(shape, tree, tokens, lr, dp, sp, fsdp, tp):
    """A global state after one single-device step (parameters and AdamW
    moments), placed on the (dp, fsdp, tp, sp) mesh by ``shard_state``:
    whether every parameter and moment is now this rank's ``shard_of``
    block of the global one, with the step count kept; and the loss of one
    more step there against the single-device step's."""
    import torch

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel.mesh import shard_of, tree_leaves, tree_map

    cfg = _cfg(shape, "flash")
    mesh = _mesh(dp, sp, fsdp, tp)
    toks = torch.from_numpy(tokens)
    init_one, _, step_one, _ = tl.make_train_step(
        cfg, learning_rate=lr, loss_chunk=0, device="cpu")
    init_mesh, shard_state, step_mesh, _ = tl.make_train_step(
        cfg, mesh, learning_rate=lr, loss_chunk=0, device="cpu")
    state, _ = step_one(init_one(params_from_jax(tree, "cpu")), toks)
    specs = tl.param_specs(cfg)

    def _with_specs(params, specs):
        return tree_leaves(tree_map(lambda t, spec: (t, spec), params, specs))

    want = [(shard_of(leaf.detach(), spec, mesh).clone(),
             {k: (shard_of(v, spec, mesh).clone() if v.dim() else v.clone())
              for k, v in state[1].state[leaf].items()})
            for leaf, spec in _with_specs(state[0], specs)]
    placed = shard_state(state)
    placed_ok = all(
        torch.equal(leaf, w) and all(torch.equal(
            placed[1].state[leaf][k], m) for k, m in moments.items())
        for leaf, (w, moments) in zip(
            (leaf for leaf, _ in _with_specs(placed[0], specs)), want))
    _, loss = step_mesh(placed, toks)
    global_state, _ = step_one(init_one(params_from_jax(tree, "cpu")), toks)
    _, want_loss = step_one(global_state, toks)
    return placed_ok, float(loss), float(want_loss)


def _vit_cfg(shape, impl):
    import torch

    from ray_tpu_torch.models.vit import ViTConfig

    return ViTConfig(dtype=torch.float32, param_dtype=torch.float32,
                     attention_impl=impl, **shape)


def vit_forward(shape, tree, images, impl, dp, fsdp, tp, pp=1):
    """This rank's logits block of the ViT ``forward`` on the (pp, dp,
    fsdp, tp) mesh from its blocks of the carried weights, and the block's
    row offset."""
    import torch

    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel.mesh import axis_index

    mesh = _mesh(dp, 1, fsdp, tp, pp)
    cfg = _vit_cfg(shape, impl)
    params = tv.shard_params(cfg, params_from_jax(tree, "cpu"), mesh)
    with torch.no_grad():
        logits = tv.forward(cfg, params, torch.from_numpy(images), mesh)
    row = axis_index(mesh, "dp") * fsdp + axis_index(mesh, "fsdp")
    return _np(logits), row * images.shape[0] // (dp * fsdp)


def vit_train(shape, tree, images, labels, impl, steps, lr, dp, fsdp, tp,
              pp=1):
    """Losses of ``steps`` steps of the ViT ``make_train_step`` on the (pp,
    dp, fsdp, tp) mesh, from the carried weights (or from seed 0 where
    ``tree`` is None); rank 0 also returns the gathered parameters after
    them."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel.mesh import tree_map

    cfg = _vit_cfg(shape, impl)
    mesh = _mesh(dp, 1, fsdp, tp, pp)
    init_state, shard_state, train_step, dev = tv.make_train_step(
        cfg, mesh, learning_rate=lr, device="cpu")
    state = shard_state(init_state(
        0 if tree is None else params_from_jax(tree, "cpu")))
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, x, y)
        losses.append(float(loss))
    params = tree_map(_np, tv.gather_state(cfg, state, mesh))
    return losses, params if dist.get_rank() == 0 else None


def moe_ep(tree, x, dp, fsdp, tp, top_k, capacity_factor, aux_weight=0.0):
    """``moe_ffn_ep`` over the tp axis of the (dp, fsdp, tp) mesh from this
    rank's blocks of the carried parameters, tokens split over dp (the
    default ``tokens_spec``): this rank's y block and its row offset, aux,
    and the gradients of mean(y²) + ``aux_weight`` aux over the global y,
    summed over dp and gathered whole (rank 0 only)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import (all_reduce_sum, axis_index,
                                            gather_full, shard_of)
    from ray_tpu_torch.parallel.moe import moe_ffn_ep, moe_param_specs

    mesh = _mesh(dp, 1, fsdp, tp)
    specs = moe_param_specs("tp")
    params = {k: shard_of(torch.from_numpy(v), specs[k], mesh).clone()
              .requires_grad_() for k, v in tree.items()}
    y, aux = moe_ffn_ep(params, torch.from_numpy(x), mesh=mesh, axis="tp",
                        top_k=top_k, capacity_factor=capacity_factor)
    loss = y.square().sum() / x.size + aux_weight * aux
    loss.backward()
    grads = {k: p.grad for k, p in params.items()}
    all_reduce_sum(list(grads.values()), mesh, ("dp",))
    grads = {k: _np(gather_full(g, specs[k], mesh)) for k, g in grads.items()}
    row = axis_index(mesh, "dp") * y.shape[0]
    return (_np(y), row, float(aux),
            grads if dist.get_rank() == 0 else None)


def pipeline_train(shape, tree, tokens, impl, axes, n_micro, steps, lr,
                   remat=False):
    """``steps`` steps of ``make_pipeline_train_step`` on the mesh of axis
    sizes ``axes`` with ``n_micro`` microbatches from the carried
    (layer-stacked) weights: every rank's losses and launch counters; rank
    0 also returns the gathered stage-stacked parameters after them, the
    gathered gradients of the first step, and the losses, parameters and
    first-step gradients of the port's single-stage ``make_train_step``
    (one device, no mesh) on the same weights and batch."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel import pipeline as tpp
    from ray_tpu_torch.parallel.mesh import gather_full, tree_map

    cfg = _cfg(shape, impl)
    mesh = _axes_mesh(axes)
    specs = tpp.pipeline_param_specs(cfg)
    init_state, shard_state, train_step, dev = tpp.make_pipeline_train_step(
        cfg, mesh, n_micro, learning_rate=lr, remat=remat, device="cpu")
    state = shard_state(init_state(params_from_jax(tree, "cpu")))
    toks = torch.from_numpy(tokens).to(dev)
    before = launches()
    losses, grads = [], None
    for _ in range(steps):
        state, loss = train_step(state, toks)
        losses.append(float(loss))
        if grads is None:
            grads = tree_map(lambda t, spec: _np(gather_full(t.grad, spec,
                                                             mesh)),
                             state[0], specs)
    counts = tuple(a - b for a, b in zip(launches(), before))
    params = tree_map(lambda t, spec: _np(gather_full(t.detach(), spec,
                                                      mesh)),
                      state[0], specs)
    if dist.get_rank() != 0:
        return losses, counts, None
    init_one, _, step_one, _ = tl.make_train_step(
        cfg, learning_rate=lr, loss_chunk=0, device="cpu")
    one = init_one(params_from_jax(tree, "cpu"))
    one_losses, one_grads = [], None
    for _ in range(steps):
        one, loss = step_one(one, toks)
        one_losses.append(float(loss))
        if one_grads is None:
            one_grads = tree_map(lambda t: _np(t.grad), one[0])
    single = (one_losses, tree_map(lambda t: _np(t.detach()), one[0]),
              one_grads)
    return losses, counts, (params, grads, single)


def pipeline_refuses_batch(shape, axes, n_micro, tokens):
    """The error a pipeline train step raises on ``tokens`` whose batch
    ``n_micro`` does not divide, as (type name, text); None if it
    runs."""
    import torch

    from ray_tpu_torch.parallel import pipeline as tpp

    cfg = _cfg(shape, "xla")
    init_state, _, train_step, _ = tpp.make_pipeline_train_step(
        cfg, _axes_mesh(axes), n_micro, device="cpu")
    try:
        train_step(init_state(0), torch.from_numpy(tokens))
    except AssertionError as e:
        return type(e).__name__, str(e)
    return None


def mesh_info(axes):
    """``host_local_mesh_info`` of the mesh of axis sizes ``axes`` on this
    rank, with the rank and its coordinates by ``axis_index``."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import (AXES, axis_index,
                                            host_local_mesh_info)

    mesh = _axes_mesh(axes)
    return dict(host_local_mesh_info(mesh), rank=dist.get_rank(),
                coords=tuple(axis_index(mesh, a) for a in AXES))


# -- train/_checkpoint.py ------------------------------------------------------


def _train_tree_np(tree):
    """A ``train_state_tree`` tree as {path: numpy copy} (count an int)."""
    from ray_tpu_torch.train._checkpoint import _flatten_with_paths

    return {path: (int(leaf) if path == "/1/0/0" else _np(leaf).copy())
            for path, leaf in _flatten_with_paths(tree).items()}


def _gathered_tree(tree, specs, mesh):
    """The global arrays of a rank's ``train_state_tree`` tree, {path:
    numpy copy}, every rank taking part in the gathers (a leaf no axis
    splits comes back as the rank's own tensor: copied)."""
    import torch

    from ray_tpu_torch.parallel.mesh import gather_full
    from ray_tpu_torch.train._checkpoint import (_flatten_with_paths,
                                                 _leaf_specs)

    leaf_specs = _leaf_specs(tree, specs)
    return {path: (int(leaf) if path == "/1/0/0" else _np(gather_full(
        leaf.detach().contiguous(), leaf_specs[path], mesh)).copy())
        for path, leaf in _flatten_with_paths(tree).items()
        if torch.is_tensor(leaf)}


def ckpt_blocks(root, full, axes, spec, how, rank_file=0):
    """This rank's block of a leaf of global value ``full`` placed as
    ``spec`` on the mesh of ``axes``, restored from the checkpoint at
    ``root`` into {"w": block, "step": 0} by ``how`` ("load_state" of rank
    file ``rank_file``, or "load_consolidated"): (the block, the step, the
    block's bounds), or the ``ValueError``'s text."""
    import torch

    from ray_tpu_torch.parallel.mesh import block_bounds, shard_of
    from ray_tpu_torch.train import Checkpoint

    mesh = _axes_mesh(axes)
    skeleton = {"w": torch.zeros_like(shard_of(torch.from_numpy(full), spec,
                                               mesh)), "step": 0}
    ckpt = Checkpoint(root)
    try:
        if how == "load_state":
            out = ckpt.load_state(skeleton, rank_file, {"w": spec}, mesh)
        else:
            out = ckpt.load_consolidated(skeleton, {"w": spec}, mesh)
    except ValueError as e:
        return str(e)
    assert out["w"] is skeleton["w"]  # written in place
    return _np(out["w"]), out["step"], block_bounds(full.shape, spec, mesh)


def ckpt_snapshot(arrays, specs, axes):
    """``snapshot_with_meta`` of this rank's blocks of ``arrays`` (a dict
    of global numpy arrays, placed as ``specs``; an array without a spec
    whole) on the mesh of ``axes``: (host arrays, shard metadata)."""
    import torch

    from ray_tpu_torch.parallel.mesh import shard_of
    from ray_tpu_torch.train import snapshot_with_meta

    mesh = _axes_mesh(axes)
    blocks = {k: shard_of(torch.from_numpy(a), specs.get(k, ()),
                          mesh).contiguous() for k, a in arrays.items()}
    return snapshot_with_meta(blocks, specs, mesh)


def ckpt_save_blocks(root, arrays, specs, axes):
    """Each rank saves its blocks of ``arrays`` (global numpy, placed as
    ``specs`` on the mesh of ``axes``) as rank file ``rank`` under
    ``root``; then each restores them with ``load_state`` into zeroed
    blocks. Returns whether every restored block equals the saved one."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import shard_of
    from ray_tpu_torch.train import AsyncCheckpointWriter, Checkpoint

    mesh = _axes_mesh(axes)
    blocks = {k: shard_of(torch.from_numpy(a), specs[k], mesh).clone()
              for k, a in arrays.items()}
    rank = dist.get_rank()
    AsyncCheckpointWriter().save(blocks, root, rank=rank, specs=specs,
                                 mesh=mesh).result(60)
    dist.barrier()
    fresh = {k: torch.zeros_like(b) for k, b in blocks.items()}
    Checkpoint(root).load_state(fresh, rank, specs, mesh)
    return all(torch.equal(fresh[k], blocks[k]) for k in blocks)


def ckpt_llama_restore(shape, root, tokens, lr, axes, impl="flash"):
    """Restore the Llama train state at ``root`` (any world size) into this
    rank's blocks on the mesh of ``axes`` with ``load_consolidated`` and
    take one step on ``tokens``: (the restored global tree {path: array},
    the step's loss, the global parameters after it); rank 0 alone returns
    the arrays."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.parallel.mesh import tree_map
    from ray_tpu_torch.train import (Checkpoint, load_train_state,
                                     train_state_specs, train_state_tree)

    cfg = _cfg(shape, impl)
    mesh = _axes_mesh(axes)
    init_state, _, train_step, _ = tl.make_train_step(
        cfg, mesh, learning_rate=lr, loss_chunk=0, device="cpu")
    params, opt = init_state(1)
    specs = train_state_specs(tl.param_specs(cfg))
    tree = Checkpoint(root).load_consolidated(
        train_state_tree(params, opt), specs, mesh)
    load_train_state(tree, params, opt)
    restored = _gathered_tree(train_state_tree(params, opt), specs, mesh)
    _, loss = train_step((params, opt), torch.from_numpy(tokens))
    after = tree_map(_np, tl.gather_state(cfg, (params, opt), mesh))
    if dist.get_rank() != 0:
        return None, float(loss), None
    return restored, float(loss), after


def ckpt_llama_save(shape, tree, tokens, lr, axes, steps, root, writers,
                    impl="flash"):
    """``steps`` steps of ``make_train_step`` on the mesh of ``axes`` from
    the carried weights, then a save of the train state under ``root`` by
    the ranks ``writers`` maps to a rank-file number (each writing its
    blocks with shard metadata), then one more step. Returns (the losses,
    the global tree saved, the parameters after the last step); rank 0
    alone returns the arrays."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel.mesh import tree_map
    from ray_tpu_torch.train import (AsyncCheckpointWriter,
                                     global_leaf_shapes, train_state_specs,
                                     train_state_tree)

    cfg = _cfg(shape, impl)
    mesh = _axes_mesh(axes)
    init_state, shard_state, train_step, _ = tl.make_train_step(
        cfg, mesh, learning_rate=lr, loss_chunk=0, device="cpu")
    state = shard_state(init_state(params_from_jax(tree, "cpu")))
    toks = torch.from_numpy(tokens)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, toks)
        losses.append(float(loss))
    specs = train_state_specs(tl.param_specs(cfg))
    saved = train_state_tree(*state)
    shapes = global_leaf_shapes(saved, specs, mesh)
    rank = dist.get_rank()
    if rank in writers:
        AsyncCheckpointWriter().save(
            saved, root, rank=writers[rank], specs=specs, mesh=mesh,
            shapes=shapes, manifest={"metrics": {"step": steps}}).result(60)
    saved_np = _gathered_tree(saved, specs, mesh)
    saved_np["/1/0/0"] = steps
    dist.barrier()  # every file is written
    state, loss = train_step(state, toks)
    losses.append(float(loss))
    after = tree_map(_np, tl.gather_state(cfg, state, mesh))
    if rank != 0:
        return losses, None, None
    return losses, saved_np, after


def ckpt_same_world(shape, tree, tokens, lr, axes, root):
    """A step of ``make_train_step`` on the mesh of ``axes``, a save by
    every rank, a same-world ``load_state`` into a fresh state
    (``init_state(1)``): whether every parameter, moment and the count came
    back bitwise, and the next step's loss from the saved and the restored
    state. Rank 0 then restores the checkpoint into a single-device state
    with ``load_consolidated``: whether it equals the gathered state, and
    its next step's loss."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.train import (AsyncCheckpointWriter, Checkpoint,
                                     load_train_state, train_state_specs,
                                     train_state_tree)

    cfg = _cfg(shape, "flash")
    mesh = _axes_mesh(axes)
    init_state, shard_state, train_step, _ = tl.make_train_step(
        cfg, mesh, learning_rate=lr, loss_chunk=0, device="cpu")
    state = shard_state(init_state(params_from_jax(tree, "cpu")))
    toks = torch.from_numpy(tokens)
    state, _ = train_step(state, toks)
    specs = train_state_specs(tl.param_specs(cfg))
    rank = dist.get_rank()
    AsyncCheckpointWriter().save(train_state_tree(*state), root, rank=rank,
                                 specs=specs, mesh=mesh).result(60)
    saved = _gathered_tree(train_state_tree(*state), specs, mesh)
    dist.barrier()
    fresh = init_state(1)
    load_train_state(Checkpoint(root).load_state(
        train_state_tree(*fresh), rank, specs, mesh), *fresh)
    want = _train_tree_np(train_state_tree(*state))
    got = _train_tree_np(train_state_tree(*fresh))
    bitwise = got.keys() == want.keys() and all(
        np.array_equal(got[k], want[k]) for k in want)
    _, loss = train_step(state, toks)
    _, loss_restored = train_step(fresh, toks)
    if rank != 0:
        return bitwise, float(loss), float(loss_restored), None
    one_init, _, one_step, _ = tl.make_train_step(
        cfg, learning_rate=lr, loss_chunk=0, device="cpu")
    one = one_init(1)
    tree1 = Checkpoint(root).load_consolidated(train_state_tree(*one))
    load_train_state(tree1, *one)
    whole = _train_tree_np(train_state_tree(*one))
    same = whole.keys() == saved.keys() and all(
        np.array_equal(whole[k], saved[k]) for k in saved)
    _, loss_one = one_step(one, toks)
    return bitwise, float(loss), float(loss_restored), (same,
                                                        float(loss_one))


def ckpt_pipeline(shape, tree, tokens, lr, axes, n_micro, root_pp, root_one):
    """A pipeline state restored at pp 1 and back, as a JAX user would:
    ``load_consolidated`` into a whole skeleton, then ``unstack_stages`` /
    ``stack_stages``. One step of ``make_pipeline_train_step`` on the mesh
    of ``axes`` from the carried weights, a save under ``root_pp`` by every
    rank, one more step (its loss). Rank 0 restores the checkpoint into a
    single-device state (through a whole stage-stacked skeleton,
    unstacked), takes a step, saves under ``root_one`` and takes another.
    Then every rank restores that into a fresh pipeline state (a whole
    layer-stacked skeleton, stacked, its blocks cut) and takes a step.
    Returns (the pipeline's two losses); rank 0 also (whether the state it
    restored equals the saved one, its two losses)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models._sharded import adamw
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel import pipeline as tpp
    from ray_tpu_torch.parallel.mesh import shard_of, tree_leaves, tree_map
    from ray_tpu_torch.train import (AsyncCheckpointWriter, Checkpoint,
                                     load_train_state, train_state_specs,
                                     train_state_tree)

    cfg = _cfg(shape, "xla")
    mesh = _axes_mesh(axes)
    S = axes["pp"]
    pspecs = tpp.pipeline_param_specs(cfg)
    specs = train_state_specs(pspecs)
    init_state, shard_state, train_step, _ = tpp.make_pipeline_train_step(
        cfg, mesh, n_micro, learning_rate=lr, device="cpu")
    state = shard_state(init_state(params_from_jax(tree, "cpu")))
    toks = torch.from_numpy(tokens)
    state, _ = train_step(state, toks)
    rank = dist.get_rank()
    AsyncCheckpointWriter().save(train_state_tree(*state), root_pp,
                                 rank=rank, specs=specs,
                                 mesh=mesh).result(60)
    saved = _gathered_tree(train_state_tree(*state), specs, mesh)
    dist.barrier()
    state, loss_pp = train_step(state, toks)

    def whole_skeleton(stacked):
        """A whole train tree of the global shapes: layer-stacked, or
        stage-stacked (views of the layer-stacked tensors)."""
        p = tl.init_params(cfg, 0, device="cpu")
        opt = adamw(tree_leaves(p), lr)
        if stacked:
            p = dict(p, layers=tpp.stack_stages(p["layers"], S))
        return train_state_tree(p, opt)

    def restack(t, fn):
        params, ((count, mu, nu), *_) = t
        over = [dict(d, layers=fn(d["layers"])) for d in (params, mu, nu)]
        return over[0], ((count, over[1], over[2]), (), ())

    one = None
    if rank == 0:
        stage_tree = Checkpoint(root_pp).load_consolidated(
            whole_skeleton(True))
        same = _train_tree_np(stage_tree).keys() == saved.keys() and all(
            np.array_equal(v, saved[k])
            for k, v in _train_tree_np(stage_tree).items())
        layer_tree = restack(stage_tree, tpp.unstack_stages)
        one_init, _, one_step, _ = tl.make_train_step(
            cfg, learning_rate=lr, loss_chunk=0, device="cpu")
        one_state = one_init(layer_tree[0])
        load_train_state(layer_tree, *one_state)
        one_state, loss_one = one_step(one_state, toks)
        AsyncCheckpointWriter().save(train_state_tree(*one_state), root_one,
                                     rank=0).result(60)
        one_state, loss_one_next = one_step(one_state, toks)
        one = (same, float(loss_one), float(loss_one_next))
    dist.barrier()
    layer_tree = Checkpoint(root_one).load_consolidated(whole_skeleton(False))
    stage_tree = restack(layer_tree,
                         lambda d: tpp.stack_stages(d, S))
    params, ((count, mu, nu), *_) = stage_tree

    def cut(d):
        return tree_map(lambda t, spec: shard_of(t, spec, mesh), d, pspecs)

    fresh = init_state(1)
    load_train_state((cut(params), ((count, cut(mu), cut(nu)), (), ())),
                     *fresh)
    _, loss_back = train_step(fresh, toks)
    return (float(loss_pp), float(loss_back)), one
