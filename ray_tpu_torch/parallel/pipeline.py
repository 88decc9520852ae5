"""Pipeline parallelism for the PyTorch port — counterpart of
``ray_tpu/parallel/pipeline.py``: GPipe over the mesh's "pp" axis for the
Llama family.

The layers are stage-stacked, (L, ...) -> (S, L/S, ...) (``stack_stages``),
and "pp" splits the stage axis (``pipeline_param_specs``): the rank at pp
position s holds stage s's L/S layers under its own dp, fsdp and tp split,
and ``tok_emb``, ``norm`` and ``lm_head`` whole over pp, as JAX places
them. M microbatches flow through the S stages; microbatch m is JAX's,
the global rows [m·mb, (m+1)·mb), of which each data rank takes its block
(``data_spec``).

JAX runs the schedule as T = M + S - 1 ticks of one SPMD program: every
rank computes at every tick (on clipped data in the bubble), the head and
the loss run on every rank and are masked to the last, and autodiff
through the ``ppermute`` hand-offs gives the backward pipeline. The
port's ranks each run their own program on explicit groups, so each does
only its own work: stage 0 embeds, each stage runs its layers through
the port's ``_layer`` (every collective of dp, fsdp, tp and sp on the
rank's own groups, "flash" on K1 forward and K2/K3 backward) and hands
its output to the next stage (``AxisRing`` over pp, in the activations'
dtype, through host memory on gloo), and the last stage runs the final
norm, the head and the masked NLL. The backward then runs microbatch by
microbatch in reverse order, one ``torch.autograd.backward`` each, every
stage handing its input's gradient to the previous one, so every pair of
neighbours posts its transfers in one order. That is the same function
with no bubble compute. A data rank whose block of a microbatch is empty
still runs it, with zero rows, so every rank makes the same sequence of
transfers and collectives.

The loss is the NLL summed over every position with a target, divided by
B·(seq - 1), so any grouping of rows into microbatches gives the same
loss and gradient up to summation order. Gradients of the stage layers
are summed over the data axes (dp, fsdp, sp, as ``make_train_step`` sums
them); those of ``tok_emb``, ``norm`` and ``lm_head``, whole on every pp
rank but used by stage 0 or the last stage alone, over the data axes and
pp, so every pp replica takes the same AdamW step, as JAX sums their
cotangents over pp. The actor pipeline, stages as actors of the port's
runtime, is ``train/pipeline_actors.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models._sharded import adamw, sum_gradients
from ray_tpu_torch.models.llama import (DATA_AXES, _chunk_nll, _embed, _head,
                                        _remat_layer, init_params,
                                        param_specs, rms_norm, rope_tables)
from ray_tpu_torch.parallel.mesh import (P, AxisRing, axis_index, data_spec,
                                        mesh_shape, shard_of,
                                        shard_train_state, tree_leaves,
                                        tree_map)

# the leaves every pp rank holds whole: their gradients are summed over pp
REPLICATED = ("tok_emb", "norm", "lm_head")
# p2p tags on the pp group: activations forward, their gradients back
FORWARD_TAG, BACKWARD_TAG = 0, 1


def stack_stages(layer_params: Dict[str, Any],
                 n_stages: int) -> Dict[str, Any]:
    """(L, ...) layer-stacked params -> (S, L/S, ...) stage-stacked (views)."""

    def restack(x):
        L = x.shape[0]
        assert L % n_stages == 0, (
            f"{L} layers not divisible by {n_stages} stages")
        return x.reshape(n_stages, L // n_stages, *x.shape[1:])

    return tree_map(restack, layer_params)


def unstack_stages(stage_params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``stack_stages`` (for checkpoint interchange with pp=1
    runs)."""
    return tree_map(
        lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]),
        stage_params)


def pipeline_param_specs(cfg) -> Dict[str, Any]:
    """The specs of a stage-stacked state, JAX's: ("pp", *spec) for every
    layer leaf (the stage axis over pp), the base specs
    (``models/llama.py::param_specs``) for the rest. ``gather_full`` with
    them gives the global stage-stacked parameters."""
    base = param_specs(cfg)
    return {"tok_emb": base["tok_emb"],
            "layers": {k: P("pp", *spec)
                       for k, spec in base["layers"].items()},
            "norm": base["norm"], "lm_head": base["lm_head"]}


def make_pipeline_train_step(cfg, mesh, n_microbatches: int,
                             learning_rate: float = 3e-4, remat=False,
                             device=None):
    """Build (init_state, shard_state, train_step, data_device) for a
    Llama-family model pipelined over the mesh's "pp" axis (a
    ``DeviceMesh`` of ``MeshSpec(pp, dp, fsdp, tp, sp).build()``, one
    process a position; every rank calls each function together).

    State = (params, optimizer): this rank's blocks of the stage-stacked
    parameters (``pipeline_param_specs``) and AdamW as
    ``optax.adamw(learning_rate)`` on them. ``remat`` truthy recomputes
    each layer in the backward (``jax.checkpoint`` of the whole layer).
    ``device`` defaults to CUDA. Refuses, as JAX's does, with
    ``AssertionError``: n_layers that pp does not divide, ring attention,
    and (in ``train_step``) a batch that ``n_microbatches`` does not
    divide."""
    shape = mesh_shape(mesh)
    S, M = shape["pp"], n_microbatches
    assert cfg.n_layers % S == 0, (
        f"n_layers={cfg.n_layers} must divide into pp={S} stages")
    assert M >= 1
    assert cfg.attention_impl != "ring", (
        "pipeline parallelism composes with attention_impl='xla'/'flash'; "
        "ring attention under pp is not supported, as in the JAX package")
    dev = resolve_device(device)
    specs = pipeline_param_specs(cfg)
    stage = axis_index(mesh, "pp")
    first, last = stage == 0, stage == S - 1
    split = S > 1 or shape["fsdp"] > 1 or shape["tp"] > 1
    layer = _remat_layer(cfg, mesh, bool(remat))
    ring = AxisRing(mesh, "pp") if S > 1 else None

    def init_state(seed_or_params=0):
        """(params, optimizer) from a seed (``init_params``, drawn whole on
        every rank, then cut) or from global layer-stacked parameters
        (e.g. ``params_from_jax``): stage-stacked, this rank's blocks
        copied onto the device."""
        params = seed_or_params
        if not isinstance(params, dict):
            params = init_params(cfg, params, device=dev)
        params = dict(params, layers=stack_stages(params["layers"], S))
        params = tree_map(lambda t, spec: shard_of(t.detach(), spec, mesh)
                          .to(dev, copy=True), params, specs)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return params, adamw(leaves, learning_rate)

    def shard_state(state):
        """A state of global stage-stacked parameters (and their moments)
        cut to this rank's blocks in place
        (``parallel.mesh.shard_train_state``); one from ``init_state``
        already is."""
        params, opt = state
        # a global state: tok_emb whole and every stage in the layers
        whole = (tuple(params["tok_emb"].shape) == (cfg.vocab_size, cfg.dim)
                 and params["layers"]["wq"].shape[0] == S)
        if whole and split:
            shard_train_state(params, opt, specs, mesh)
        return params, opt

    def run_stage(layers, h, cos, sin):
        """This rank's L/S layers on ``h``; one unbind a weight per
        microbatch, so no graph node is shared by two microbatches'
        backward calls."""
        stacked = {name: w[0].unbind(0) for name, w in layers.items()}
        for i in range(cfg.n_layers // S):
            h = layer(h, {name: ws[i] for name, ws in stacked.items()},
                      cos, sin)
        return h

    def train_step(state, tokens):
        """One AdamW step on the GLOBAL batch ``tokens`` (B, seq) on the
        device, B % n_microbatches == 0, by GPipe. Parameters and moments
        are updated in place. Returns (state, loss), the loss a 0-dim
        tensor, the global one on every rank, not synchronised."""
        params, opt = state
        B, seq = tokens.shape
        assert B % M == 0, f"batch {B} not divisible by {M} microbatches"
        mb = B // M
        opt.zero_grad(set_to_none=True)
        denom = float(B * (seq - 1))
        targets = torch.cat([tokens[:, 1:], torch.full(
            (B, 1), -1, dtype=tokens.dtype, device=tokens.device)], dim=1)
        positions = shard_of(torch.arange(seq, device=tokens.device),
                             P("sp"), mesh)
        cos, sin = rope_tables(cfg, positions)
        loss = torch.zeros((), device=tokens.device)
        kept, sends = [], []
        for m in range(M):
            rows = slice(m * mb, (m + 1) * mb)
            toks = shard_of(tokens[rows], data_spec(), mesh)
            if first:
                x = _embed(cfg, mesh, params["tok_emb"], toks)
            else:
                (x,) = ring.exchange(recvs=[((*toks.shape, cfg.dim),
                                             cfg.dtype, tokens.device)],
                                     tag=FORWARD_TAG).wait()
                x.requires_grad_(True)
            y = run_stage(params["layers"], x, cos, sin)
            if last:
                tgt = shard_of(targets[rows], data_spec(), mesh)
                h = rms_norm(y, params["norm"], cfg.norm_eps)
                # this microbatch's share of the loss
                y = _chunk_nll(cfg, mesh, _head(cfg, mesh, params["lm_head"]),
                               h, tgt, (tgt >= 0).float()) / denom
                loss += y.detach()
            else:
                sends.append(ring.exchange([y.detach()], tag=FORWARD_TAG))
            kept.append((x, y))
        for t in sends:
            t.wait()
        sends.clear()
        while kept:  # the microbatches in reverse order
            x, y = kept.pop()
            if last:
                torch.autograd.backward(y)
            else:
                (dy,) = ring.exchange(recvs=[(y.shape, y.dtype, y.device)],
                                      step=-1, tag=BACKWARD_TAG).wait()
                torch.autograd.backward(y, dy)
            if not first:
                sends.append(ring.exchange([x.grad], step=-1,
                                           tag=BACKWARD_TAG))
        for t in sends:
            t.wait()
        for name in REPLICATED:  # unused on this stage: a zero gradient
            if params[name].grad is None:
                params[name].grad = torch.zeros_like(params[name])
        sum_gradients(params["layers"], specs["layers"], mesh, DATA_AXES)
        sum_gradients({k: params[k] for k in REPLICATED},
                      {k: specs[k] for k in REPLICATED}, mesh,
                      ("pp",) + DATA_AXES, extra=[loss])
        opt.step()
        return state, loss

    return init_state, shard_state, train_step, dev


__all__ = [
    "make_pipeline_train_step",
    "pipeline_param_specs",
    "stack_stages",
    "unstack_stages",
]
