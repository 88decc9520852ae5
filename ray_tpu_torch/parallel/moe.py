"""Expert parallelism: a mixture-of-experts FFN with token-choice routing —
counterpart of ``ray_tpu/parallel/moe.py``.

GShard-style top-k routing with capacity buckets: the dispatch and combine
are dense one-hot products (static shapes; a (token, choice) slot past its
expert's capacity is dropped and its token falls through the residual),
the experts' FFN a batched product with a tanh GELU. These are plain
products, which the JAX package leaves to XLA (no Pallas kernel): here
``torch.einsum`` and ``torch.bmm``. Where the JAX package multiplies a bf16
tensor by an fp32 one, JAX promotes the product to fp32; ``torch.einsum``
refuses mixed dtypes, so each product casts its operands to the promoted
dtype first (``_promoted``): the dispatch and combine are fp32, so are the
buckets and the experts' products.

``moe_ffn_ep`` splits the experts over one mesh axis: each rank routes its
block of tokens to all experts, an autograd all-to-all
(``parallel/mesh.py::AllToAll``) moves the [E, C, d] buckets to the ranks
that hold their experts and the outputs back, and the aux loss is averaged
over the axes that split the tokens.
"""

from __future__ import annotations

import math
from functools import reduce
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel.mesh import (P, AllToAll, all_reduce_sum,
                                        mesh_shape, shard_of)


def init_moe_params(seed: int, d_model: int, d_ff: int, num_experts: int,
                    dtype=torch.float32, device=None
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's initialisation from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default CUDA): router (d_model, E) and
    w_in (E, d_model, d_ff) N(0, 1/d_model), w_out (E, d_ff, d_model)
    N(0, 1/d_ff)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=dev)
                / math.sqrt(fan_in)).to(dtype)

    return {
        "router": normal((d_model, num_experts), d_model),
        "w_in": normal((num_experts, d_model, d_ff), d_model),
        "w_out": normal((num_experts, d_ff, d_model), d_ff),
    }


def moe_param_specs(axis: str = "tp") -> Dict[str, tuple]:
    """Where ``moe_ffn_ep`` keeps the parameters (the JAX package's
    ``shard_map`` in_specs): the router whole on every rank, the experts
    split over ``axis``. ``shard_of`` under these gives a rank's blocks."""
    return {"router": P(), "w_in": P(axis), "w_out": P(axis)}


def _promoted(*ts):
    """The tensors cast to their promoted dtype, as JAX promotes the
    operands of a product."""
    dt = reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def _capacity(tokens: int, experts: int, capacity_factor: float,
              top_k: int) -> int:
    """Slots an expert takes: ceil(T / E · cf · k), computed in float."""
    return max(1, int(math.ceil(tokens / experts * capacity_factor * top_k)))


def _route(router_logits: torch.Tensor, top_k: int, capacity: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing → (dispatch [T, E, C], combine [T, E, C],
    aux loss), fp32. The kept gates are renormalised; each (token, choice)
    takes the next slot of its expert's bucket in (choice, token) order, so
    every first choice is placed before any second one; a slot at or past
    ``capacity`` is dropped. aux is the Switch Transformer's load-balancing
    loss on the first choices."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    # lax.top_k: the larger first, the lower index first among equals
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :top_k], expert_idx[:, :top_k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    experts = torch.arange(E, device=probs.device)
    onehot = (expert_idx[..., None] == experts).long()     # [T, k, E]
    flat = onehot.transpose(0, 1).reshape(top_k * T, E)    # [(k, T), E]
    pos_flat = flat.cumsum(0) - flat                       # rank per expert
    pos = pos_flat.reshape(top_k, T, E).transpose(0, 1)    # [T, k, E]
    position = (pos * onehot).sum(-1)                      # [T, k]
    kept = position < capacity

    # jax.nn.one_hot of a slot >= capacity is all zeros, as here
    slot = (position[..., None] == torch.arange(capacity,
                                                device=probs.device))
    disp = (onehot.float()[..., None] * slot.float()[:, :, None, :]
            * kept[..., None, None])                       # [T, k, E, C]
    dispatch = disp.sum(1)
    combine = (disp * gate_vals[..., None, None]).sum(1)

    me = probs.mean(0)                                     # mean router prob
    ce = onehot[:, 0].float().mean(0)                      # top-1 load
    aux = E * (me * ce).sum()
    return dispatch, combine, aux


def _expert_ffn(w_in: torch.Tensor, w_out: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Batched expert FFN: x [E, C, d] → [E, C, d]."""
    h = F.gelu(torch.bmm(*_promoted(x, w_in)), approximate="tanh")
    return torch.bmm(*_promoted(h, w_out))


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
            top_k: int = 2, capacity_factor: float = 2.0
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-shard MoE FFN. x: [tokens, d_model] → (y in x's dtype, aux)."""
    E = params["router"].shape[1]
    capacity = _capacity(x.shape[0], E, capacity_factor, top_k)
    dispatch, combine, aux = _route(
        torch.matmul(*_promoted(x, params["router"])), top_k, capacity)
    expert_in = torch.einsum("tec,td->ecd", *_promoted(dispatch, x))
    expert_out = _expert_ffn(params["w_in"], params["w_out"], expert_in)
    y = torch.einsum("tec,ecd->td", *_promoted(combine, expert_out))
    return y.to(x.dtype), aux


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def moe_ffn_ep(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
               mesh, axis: str = "tp", tokens_spec: Optional[tuple] = None,
               top_k: int = 2, capacity_factor: float = 2.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN over the ``DeviceMesh`` axis ``axis``; every
    rank calls it together.

    ``params`` are this rank's blocks (``moe_param_specs``): the router
    whole, w_in / w_out this rank's E/ep experts. ``x`` is the GLOBAL
    [tokens, d_model], split over ``tokens_spec`` (the port's ``P``;
    default ``P("dp")``). Each rank routes its token block to all E
    experts, with a capacity of its own block's size; one all-to-all sends
    the [E, C, d] buckets to the experts' ranks, where the senders' buckets
    stand side by side along capacity ([E/ep, C·ep, d]); the reverse one
    sends each sender its tokens' outputs back. Returns (this rank's block
    of y, aux), aux averaged over the axes of ``tokens_spec``.

    Gradients follow the port's models (``models/llama.py``): each rank's
    reach its own tokens' share; summed over the axes of ``tokens_spec``
    (the router's, and the experts' over those besides ``axis``), they are
    the global loss's. Where the tokens are not split over ``axis``, every
    rank of it sends the experts the same tokens, so each expert's gradient
    arrives once from each of them and is scaled by 1/ep."""
    ep = mesh_shape(mesh)[axis]
    E = params["router"].shape[1]
    if E % ep:
        raise ValueError(f"num_experts {E} must divide by {axis}={ep}")
    if params["w_in"].shape[0] != E // ep:
        raise ValueError(
            f"w_in holds {params['w_in'].shape[0]} experts; a rank holds its "
            f"{E // ep} of {E} (shard_of under moe_param_specs)")
    tokens_spec = P("dp") if tokens_spec is None else tokens_spec
    token_axes = tuple(
        a for entry in tokens_spec if entry is not None
        for a in ((entry,) if isinstance(entry, str) else entry))
    x_local = shard_of(x, tokens_spec, mesh)
    capacity = _capacity(x_local.shape[0], E, capacity_factor, top_k)
    dispatch, combine, aux = _route(
        torch.matmul(*_promoted(x_local, params["router"])), top_k, capacity)
    buckets = torch.einsum("tec,td->ecd", *_promoted(dispatch, x_local))
    w_in, w_out = params["w_in"], params["w_out"]
    if ep > 1:
        group = mesh.get_group(axis)
        d = buckets.shape[-1]
        # chunk j (experts j·E/ep, ...) to rank j; the senders stacked first
        incoming = AllToAll.apply(buckets.reshape(ep, E // ep, capacity, d),
                                  group)
        incoming = incoming.transpose(0, 1).reshape(E // ep, ep * capacity, d)
        if axis not in token_axes:
            w_in, w_out = (_ScaleGrad.apply(w, 1.0 / ep)
                           for w in (w_in, w_out))
        outgoing = _expert_ffn(w_in, w_out, incoming)
        # capacity block j back to sender j; the experts stacked in rank order
        back = outgoing.reshape(E // ep, ep, capacity, d).transpose(0, 1)
        returned = AllToAll.apply(back, group).reshape(E, capacity, d)
    else:
        returned = _expert_ffn(w_in, w_out, buckets)
    y = torch.einsum("tec,ecd->td", *_promoted(combine, returned))
    n = math.prod(mesh_shape(mesh)[a] for a in token_axes)
    if n > 1:
        # the mean of the ranks' aux; each rank's gradient reaches its own
        total = aux.detach().clone()
        all_reduce_sum([total], mesh, token_axes)
        aux = (aux + (total - aux.detach())) / n
    return y.to(x.dtype), aux
