"""Ring attention — sequence/context parallelism over the mesh's sp axis.
Counterpart of ``ray_tpu/parallel/ring_attention.py``.

The sequence is sharded over sp: each rank holds a contiguous block of
s/sp positions of q, k and v. Each step every rank computes blockwise
attention of its local queries against the resident K/V block with an
online-softmax accumulator (running max, running denominator), then passes
K/V to its ring neighbour with ``torch.distributed.batch_isend_irecv``
(rank idx sends to idx+1 and receives from idx-1, JAX's ``ppermute``
ring). The next block's transfer is posted before the hop's compute and
awaited after it, so the transfer runs while the hop computes.

Each hop is classified by ring offset (``_dispatch_hop``):
  * FULL — the K/V block is entirely in this shard's causal past: the hop
    runs unmasked (``ops.flash_attention.flash_chunk_bhsd``, K4 on CUDA);
  * DIAG — the resident block: the hop runs with the local causal mask;
  * SKIP — entirely in the future: no work, forward or backward.

Differentiation is a ring-level autograd function (``_RingCore``): the
forward saves only (q, k, v, out, lse) — O(s·d), never the (s/sp)² score
blocks — and the backward runs a second ring pass in which the fp32 dk/dv
accumulators rotate with their K/V blocks, each hop computed by K2/K3 with
fp32 outputs (``flash_hop_bwd``, K5 on CUDA) against the saved global
lse/delta rows.

On a gloo group the blocks go through host memory (``mesh.stage``), so
several ranks can share one GPU; the hop arithmetic is the same either way.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.flash_attention import flash_chunk_bhsd, flash_hop_bwd
from ray_tpu_torch.parallel.mesh import axis_index, mesh_shape, stage, to_wire

FULL, DIAG, SKIP = 0, 1, 2


def _ring_perm(sp_size):
    return [(j, (j + 1) % sp_size) for j in range(sp_size)]


def _dispatch_hop(causal: bool, idx: int, i: int, sp_size: int) -> int:
    """The correctness-critical hop classification, shared by forward and
    backward: at step ``i`` rank ``idx`` holds the K/V block of ring
    position ``src``; FULL (in this shard's causal past), DIAG (its own
    block, local causal mask) or SKIP (future block: no work)."""
    src = (idx - i) % sp_size  # ring position this K/V block came from
    if not causal:
        return FULL
    return 2 - (src <= idx) - (src < idx)


class _Ring:
    """The sp axis of a mesh as a ring: this rank's index, its neighbours'
    global ranks, and the transfer of blocks one step around it."""

    def __init__(self, mesh):
        self.group = mesh.get_group("sp")
        self.size = mesh_shape(mesh)["sp"]
        self.idx = axis_index(mesh, "sp")
        # global ranks of the neighbours in the sp group's ring
        ranks = dist.get_process_group_ranks(self.group)
        perm = _ring_perm(self.size)
        self.next = ranks[dict(perm)[self.idx]]
        self.prev = ranks[next(j for j, d in perm if d == self.idx)]
        self.staged = stage(self.group)

    def start(self, *tensors, tag: int = 0) -> "_Transfer":
        """Post the sends of ``tensors`` to the next rank and the receives
        of the previous rank's (tags from ``tag`` up, so two transfers may
        be in flight); ``wait()`` on the result returns them."""
        sends = [to_wire(t, self.staged) for t in tensors]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, self.next, self.group, tag=tag + n)
               for n, t in enumerate(sends)]
        ops += [dist.P2POp(dist.irecv, t, self.prev, self.group, tag=tag + n)
                for n, t in enumerate(recvs)]
        return _Transfer(dist.batch_isend_irecv(ops), sends, recvs,
                         [t.device for t in tensors])


class _Transfer:
    """One posted ring transfer; the send buffers live until ``wait``."""

    def __init__(self, works, sends, recvs, devices):
        self.works, self.sends, self.recvs = works, sends, recvs
        self.devices = devices

    def wait(self):
        for w in self.works:
            w.wait()
        return tuple(t.to(d) for t, d in zip(self.recvs, self.devices))


def _ring_fwd_impl(q, k, v, ring: _Ring, causal: bool):
    """Forward ring loop. q: (b, h, sq, hd); k/v: (b, kvh, sk, hd) local
    shards. Returns (out, lse), lse (b, h, sq, 1) fp32."""
    b, h, sq, hd = q.shape
    o = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    for i in range(ring.size):
        # rotate K/V around the ring (skipped after the final block)
        pending = ring.start(k, v) if i < ring.size - 1 else None
        hop = _dispatch_hop(causal, ring.idx, i, ring.size)
        if hop != SKIP:
            o, m, l = flash_chunk_bhsd(q, k, v, o, m, l, hop == DIAG)
        if pending is not None:
            k, v = pending.wait()
    # under causal the diagonal always contributes, so l > 0 on every row
    out = (o / l).to(q.dtype)
    lse = m + torch.log(l)
    return out, lse


class _RingCore(torch.autograd.Function):
    """The JAX package's ``_ring_core`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal):
        out, lse = _ring_fwd_impl(q, k, v, ring, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal = ring, causal
        return out

    @staticmethod
    def backward(ctx, g):
        """Second ring pass: the dk/dv accumulators travel WITH their K/V
        blocks (rotated every step, so after sp hops each block's gradient
        lands back on its home shard); dq accumulates locally."""
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal = ctx.ring, ctx.causal
        g = g.contiguous()
        delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in range(ring.size):
            # k/v are never read after the final hop: no last rotation
            pending = ring.start(k, v) if i < ring.size - 1 else None
            hop = _dispatch_hop(causal, ring.idx, i, ring.size)
            if hop != SKIP:
                dq_p, dk_p, dv_p = flash_hop_bwd(q, k, v, g, lse, delta,
                                                 hop == DIAG)
                dq += dq_p
                dk += dk_p
                dv += dv_p
            # dk/dv rotate every step, the last one included
            dk, dv = ring.start(dk, dv, tag=2).wait()
            if pending is not None:
                k, v = pending.wait()
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention_sharded(q, k, v, mesh, causal: bool = True):
    """Attention with the sequence sharded over the mesh's sp axis.

    q: (batch, s/sp, heads, head_dim) and k/v: (batch, s/sp, kv_heads,
    head_dim) are this rank's shards, the layout of the JAX package's
    ``shard_map`` body: rank idx on the sp axis holds positions
    [idx·s/sp, (idx+1)·s/sp). Returns this rank's shard of the output, in
    q's shape and dtype. Every rank of the sp group calls it together."""
    # bhsd layout into the kernels
    out = _RingCore.apply(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), _Ring(mesh), causal)
    return out.transpose(1, 2)


def ring_attention_reference(q, k, v, causal: bool = True):
    """Single-device reference for testing numerical parity."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    if kvh != h:
        rep = h // kvh
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype),
                        v).to(q.dtype)
