"""What the port's models (``llama.py``, ``vit.py``) share to run and train
on a mesh: the fsdp gather of a weight at use, attention where tp does not
split the heads, the sums of the gradients by group, and AdamW as the JAX
package's ``optax.adamw``.

The models take every mesh, as in the JAX package: dp, fsdp, tp and sp
split the work (a weight they do not split evenly is cut as GSPMD cuts it,
``parallel/mesh.py::shard_of``), and pp, which no spec of the models
names, is a replica axis: each pp slice holds the whole model under its
own dp, fsdp and tp split, sees the same data and takes the same step, and
nothing is summed over it. The pipeline schedule over pp is
``parallel/pipeline.py``."""

from __future__ import annotations

import torch

from ray_tpu_torch.parallel.mesh import (all_gather, all_reduce_sum,
                                        axis_index, block_range, copy_to,
                                        gather_from, mesh_shape, tree_leaves,
                                        tree_map)


def use(mesh, w, spec, size: int):
    """A weight at use: ``w`` is this rank's block of a weight stored as
    ``spec``; its fsdp dim (of global length ``size``) is all-gathered
    (ZeRO-3: the backward reduce-scatters the gradient over fsdp, whose
    ranks hold different batch rows) and its tp dim is kept. Nothing to
    gather when fsdp is 1 (JAX's ``_use`` is the identity when fsdp and tp
    are both 1)."""
    if mesh_shape(mesh)["fsdp"] == 1:
        return w
    return all_gather(w, mesh, "fsdp", dim=spec.index("fsdp"), size=size)


def heads_split(mesh, *heads: int) -> bool:
    """Whether tp splits each of these head counts evenly. Then a tp rank
    holds whole heads (wq/wk/wv's columns and wo's rows are head-major, so
    a contiguous block of them is a block of heads; GQA's head map holds
    locally) and runs attention on them alone, Megatron style. Otherwise
    every tp rank runs attention on all heads, as GSPMD runs it for a split
    that cuts a head (``gather_heads``, ``own_columns``)."""
    tp = mesh_shape(mesh)["tp"]
    return all(h % tp == 0 for h in heads)


def gather_heads(t: torch.Tensor, mesh, heads: int,
                 head_dim: int) -> torch.Tensor:
    """This tp rank's columns (b, s, cols) of a q, k or v projection → all
    ``heads`` (b, s, heads, head_dim), gathered over tp. The backward keeps
    the rank's columns: the gradient is whole on every rank, since the
    attention after it runs on every rank from the same inputs and
    ``own_columns`` sums o's gradient over tp."""
    b, s = t.shape[:2]
    return gather_from(t, mesh, "tp", dim=-1, size=heads * head_dim
                       ).reshape(b, s, heads, head_dim)


def own_columns(o: torch.Tensor, mesh) -> torch.Tensor:
    """o (b, s, heads·head_dim) of every head, the same on every tp rank →
    this rank's columns, which meet the rows of wo the rank holds (a
    row-parallel product follows). Each rank's product reaches only its
    columns, so o's gradient is summed over tp first (``copy_to``): whole
    on every rank."""
    start, length = block_range(o.shape[-1], mesh_shape(mesh)["tp"],
                                axis_index(mesh, "tp"))
    return copy_to(o, mesh, "tp").narrow(-1, start, length)


def sum_gradients(params, specs, mesh, data_axes, extra=()):
    """Sum every gradient of ``params`` (placed as ``specs``) and the
    tensors ``extra`` (the loss) over the ranks that hold other data, in
    place, one flat buffer a group: over ``data_axes``, less fsdp where the
    fsdp gather at use has reduce-scattered the gradient already (a leaf
    whose spec names fsdp); never over tp, on which the Megatron
    collectives leave each rank's gradient whole."""
    fsdp = mesh_shape(mesh)["fsdp"] > 1
    by_axes = {tuple(data_axes): list(extra)}
    for leaf, spec in tree_leaves(
            tree_map(lambda t, spec: (t, spec), params, specs)):
        axes = tuple(a for a in data_axes if not (
            a == "fsdp" and fsdp and "fsdp" in spec))
        by_axes.setdefault(axes, []).append(leaf.grad)
    for axes, tensors in by_axes.items():
        all_reduce_sum(tensors, mesh, axes)


# AdamW as the JAX package's ``optax.adamw(learning_rate)``: optax's defaults,
# weight decay 1e-4 on every leaf, norms included (torch's default is 1e-2)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4


def adamw(leaves, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` over ``leaves``: decoupled decay on
    every leaf; the fused kernel on CUDA (PyTorch's own optimizer kernel,
    as the JAX package left the optimizer to XLA)."""
    return torch.optim.AdamW(
        leaves, lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
        weight_decay=WEIGHT_DECAY,
        fused=True if leaves[0].is_cuda else None)
