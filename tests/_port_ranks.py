"""One gloo process group of rank processes for the sequence-parallel parity
tests (``test_torch_ring_attention.py``, ``test_torch_sequence_parallel.py``).

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


def _mesh(dp, sp):
    """The (dp, sp) mesh over the whole group, built once (building one
    creates process groups: every rank builds them in the same order)."""
    from ray_tpu_torch.parallel.mesh import MeshSpec

    if (dp, sp) not in _MESHES:
        _MESHES[(dp, sp)] = MeshSpec(dp=dp, sp=sp).build()
    return _MESHES[(dp, sp)]


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


def forward(shape, tree, tokens, impl, dp, sp):
    """This rank's logits block of ``forward`` on the (dp, sp) mesh, and
    its (row, column) offsets in the global logits."""
    import torch

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.parallel.mesh import axis_index

    mesh = _mesh(dp, sp)
    cfg = tl.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                         attention_impl=impl, **shape)
    with torch.no_grad():
        logits = tl.forward(cfg, params_from_jax(tree, "cpu"),
                            torch.from_numpy(tokens), mesh)
    b, s = tokens.shape
    return (_np(logits), axis_index(mesh, "dp") * b // dp,
            axis_index(mesh, "sp") * s // sp)


def train(shape, tree, tokens, impl, remat, loss_chunk, steps, lr, dp, sp):
    """Losses of ``steps`` steps of ``make_train_step`` on the (dp, sp)
    mesh from the carried weights; rank 0 also returns the parameters
    after them (nested numpy)."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import params_from_jax

    cfg = tl.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                         attention_impl=impl, **shape)
    init_state, shard_state, train_step, dev = tl.make_train_step(
        cfg, _mesh(dp, sp), learning_rate=lr, remat=remat,
        loss_chunk=loss_chunk, device="cpu")
    state = shard_state(init_state(params_from_jax(tree, "cpu")))
    toks = torch.from_numpy(tokens).to(dev)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, toks)
        losses.append(float(loss))
    params = tl._map(_np, state[0]) if dist.get_rank() == 0 else None
    return losses, params, launches()
