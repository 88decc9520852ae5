"""Ulysses-style sequence parallelism: all-to-all head-scatter / seq-gather.
Counterpart of ``ray_tpu/parallel/ulysses.py``.

The second sequence-parallel strategy beside ring attention: instead of
rotating K/V, an all-to-all over the sp axis re-shards activations from
sequence-sharded to head-sharded, ordinary full-sequence attention runs
locally on 1/sp of the heads (``flash_attention``: K1 forward, K2/K3
backward on CUDA), and a second all-to-all shards the output back by
sequence. On a gloo group the all-to-alls go through host memory
(``mesh.stage``).
"""

from __future__ import annotations

from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel.mesh import AllToAll, mesh_shape


def _scatter_heads(x, group, sp):
    """(b, s/sp, h, hd) -> (b, s, h/sp, hd): scatter heads, gather seq."""
    b, sl, h, hd = x.shape
    chunks = x.reshape(b, sl, sp, h // sp, hd).permute(2, 0, 1, 3, 4)
    y = AllToAll.apply(chunks, group)  # (sp source ranks, b, sl, h/sp, hd)
    return y.permute(1, 0, 2, 3, 4).reshape(b, sp * sl, h // sp, hd)


def _gather_heads(x, group, sp):
    """(b, s, h/sp, hd) -> (b, s/sp, h, hd): scatter seq, gather heads."""
    b, s, hl, hd = x.shape
    chunks = x.reshape(b, sp, s // sp, hl, hd).permute(1, 0, 2, 3, 4)
    y = AllToAll.apply(chunks, group)  # (sp source ranks, b, s/sp, hl, hd)
    return y.permute(1, 2, 0, 3, 4).reshape(b, s // sp, sp * hl, hd)


def ulysses_attention_sharded(q, k, v, mesh, causal: bool = True):
    """q/k/v: (batch, s/sp, heads, head_dim), this rank's sequence shard
    on the mesh's sp axis (as ``ring_attention_sharded``); returns this
    rank's shard of the output.

    Requires heads % sp == 0 (and kv_heads % sp == 0 for GQA)."""
    sp = mesh_shape(mesh)["sp"]
    if q.shape[2] % sp or k.shape[2] % sp:
        raise ValueError(
            f"ulysses needs heads divisible by sp={sp}; "
            f"got q heads {q.shape[2]}, kv heads {k.shape[2]}")
    group = mesh.get_group("sp")
    ql, kl, vl = (_scatter_heads(t, group, sp) for t in (q, k, v))
    out = flash_attention(ql, kl, vl, causal=causal)
    return _gather_heads(out, group, sp)
