"""Flash attention, forward and backward, for PyTorch on Hopper.

Counterpart of ``ray_tpu/ops/flash_attention.py``. Layout is (batch, heads,
seq, head_dim) ("bhsd") end to end; a (batch, seq, heads, head_dim) wrapper
is kept for callers that use the attention-standard layout. GQA maps query
head ``hi`` to kv head ``hi // (h // kvh)``.

``flash_attention_bhsd`` is an autograd function (``_FlashAttn``) that
mirrors the JAX package's custom VJP: the forward saves q, k, v, o and lse,
the backward computes delta = rowsum(dO * o) and then dq, dk and dv.

* A CUDA tensor goes to the hand-written kernels, or the wrapper raises:
  ``csrc/flash_fwd.cu`` (K1, the port of ``_fwd_kernel``) forward and
  ``csrc/flash_bwd.cu`` (K2 ``_dq_kernel``, K3 ``_dkv_kernel``) backward.
  They take bf16, head_dim 64 or 128, ``h % kvh == 0``, contiguous
  tensors, q and k/v of one length.
* A CPU tensor takes the plain versions, ``_attention_reference`` and
  ``_flash_bwd_reference``, through the same autograd function.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30

# Kernel launches since import (or since a caller reset them): a run reads
# them to show its path went through the kernels. K1, K2, K3.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _xla_attention_bhsd(q, k, v, causal: bool):
    """q: (b, h, s, hd); k/v: (b, kvh, s, hd) → (b, h, s, hd).

    The JAX package's XLA fallback, op for op: fp32 logits, a bottom-right
    causal mask (``tril(k=sk-sq)``), probabilities cast to v's dtype."""
    b, h, sq, hd = q.shape
    kvh = k.shape[1]
    if kvh != h:
        rep = h // kvh
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        sk = k.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(
            sk - sq)
        logits = logits.masked_fill(~mask, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p.to(v.dtype), v).to(q.dtype)


def _attention_reference(q, k, v, causal: bool) -> Tuple[torch.Tensor,
                                                          torch.Tensor]:
    """The plain version of the K1 kernel: (o, lse).

    fp32 throughout, GQA by ``repeat_interleave``, a top-left causal mask
    (``q_pos >= k_pos``, as the kernel masks), o in q's dtype and lse
    (b, h, s, 1) fp32."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(q_pos < k_pos, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    o = torch.matmul(torch.exp(logits - lse), vf)
    return o.to(q.dtype), lse


def _flash_bwd_reference(q, k, v, o, lse, g, causal: bool):
    """The plain version of the K2 and K3 kernels: (dq, dk, dv).

    The kernels' own arithmetic in fp32 (as ``_flash_bwd_tpu``): delta =
    rowsum(g * o), p recomputed from lse under the top-left causal mask,
    ds = p (dp - delta); dq in q's dtype, dk/dv summed over each kv head's
    query heads and cast to k/v's dtype."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qf, gf = q.float(), g.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    delta = (gf * o.float()).sum(dim=-1, keepdim=True)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, NEG_INF)
    p = torch.exp(s - lse)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dk = dk.reshape(b, kvh, rep, sk, hd).sum(dim=2)
    dv = dv.reshape(b, kvh, rep, sk, hd).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels (K1 forward; K2, K3 backward)
# ---------------------------------------------------------------------------


def _flash_fwd_cuda(q, k, v, causal: bool):
    """Launch K1 on q's device and current stream. Returns (o, lse)."""
    global flash_fwd_launches
    b, h, s, hd = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd kernel takes bf16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in (64, 128):
        raise ValueError(f"flash_fwd kernel takes head_dim 64 or 128, got {hd}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2] != s or k.shape[3] != hd:
        raise ValueError(f"k/v must be (b, kvh, s, hd) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    kvh = k.shape[1]
    if h % kvh != 0:
        raise ValueError(f"heads {h} not a multiple of kv heads {kvh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd kernel takes contiguous q/k/v")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_fwd")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, h, kvh, s, hd, int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {rc}")
    flash_fwd_launches += 1
    return o, lse


def _flash_bwd_cuda(q, k, v, o, lse, g, causal: bool):
    """delta, then K2 and K3 on q's device and current stream. Returns
    (dq, dk, dv) in q's, k's and v's dtype."""
    b, h, s, hd = q.shape
    if any(t.dtype != torch.bfloat16 for t in (q, k, v, o, g)) \
            or lse.dtype != torch.float32:
        raise TypeError(
            f"flash_bwd kernels take bf16 q/k/v/o/dO and fp32 lse, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}/{o.dtype}/{g.dtype}/{lse.dtype}")
    if hd not in (64, 128):
        raise ValueError(f"flash_bwd kernels take head_dim 64 or 128, got {hd}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[2] != s or k.shape[3] != hd:
        raise ValueError(f"k/v must be (b, kvh, s, hd) matching q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if o.shape != q.shape or g.shape != q.shape \
            or tuple(lse.shape) != (b, h, s, 1):
        raise ValueError(f"o/dO must be {tuple(q.shape)} and lse "
                         f"{(b, h, s, 1)}; got {tuple(o.shape)}, "
                         f"{tuple(g.shape)}, {tuple(lse.shape)}")
    if h % k.shape[1] != 0:
        raise ValueError(f"heads {h} not a multiple of kv heads {k.shape[1]}")
    if not all(t.is_contiguous() for t in (q, k, v, o, lse, g)):
        raise ValueError("flash_bwd kernels take contiguous q/k/v/o/lse/dO")
    if any(t.device != q.device for t in (k, v, o, lse, g)):
        raise ValueError("q, k, v, o, lse and dO must be on one device")
    # delta = rowsum(dO * o) in fp32, outside the kernels as in the JAX
    # package
    delta = (g.float() * o.float()).sum(dim=-1)
    dq = _launch_dq(q, k, v, g, lse, delta, causal)
    dk, dv = _launch_dkv(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


def _launch_dq(q, k, v, g, lse, delta, causal: bool, dq_fp32: bool = False):
    """K2 on inputs ``_flash_bwd_cuda`` has checked; lse/delta (b, h, sq)
    rows. sq and k/v's sk may differ (the ring-hop backward's shape)."""
    global flash_bwd_dq_launches
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, dtype=torch.float32 if dq_fp32 else q.dtype)
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, kvh, sq,
            sk, hd, int(bool(causal)), int(bool(dq_fp32)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd dq kernel launch failed: cudaError {rc}")
    flash_bwd_dq_launches += 1
    return dq


def _launch_dkv(q, k, v, g, lse, delta, causal: bool):
    """K3 on inputs ``_flash_bwd_cuda`` has checked: (dk, dv) in k/v's
    dtype, summed over each kv head's query heads."""
    global flash_bwd_dkv_launches
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, kvh, sq, sk, hd, int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd dkv kernel launch failed: "
                           f"cudaError {rc}")
    flash_bwd_dkv_launches += 1
    return dk, dv


class _FlashAttn(torch.autograd.Function):
    """The JAX package's ``_flash_bhsd`` custom VJP: K1 forward, K2 and K3
    backward on CUDA; their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            o, lse = _flash_fwd_cuda(q, k, v, causal)
        else:
            o, lse = _attention_reference(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.contiguous()
        if q.is_cuda:
            dq, dk, dv = _flash_bwd_cuda(q, k, v, o, lse, g, ctx.causal)
        else:
            dq, dk, dv = _flash_bwd_reference(q, k, v, o, lse, g, ctx.causal)
        return dq, dk, dv, None


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def flash_attention_bhsd(q, k, v, causal: bool = True,
                         block_q: int = 512, block_k: int = 512):
    """q: (batch, heads, seq, head_dim); k/v: (batch, kv_heads, seq, head_dim).

    ``block_q``/``block_k`` keep the JAX signature; the Hopper kernel picks
    its own 64-row tiles."""
    if q.is_cuda or q.device.type == "cpu":
        return _FlashAttn.apply(q, k, v, causal)
    raise ValueError(f"flash attention has no path for device {q.device}")


def flash_attention(q, k, v, causal: bool = True,
                    block_q: int = 512, block_k: int = 512):
    """Layout-standard entry. q/k/v: (batch, seq, heads, head_dim)."""
    out = flash_attention_bhsd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal, block_q, block_k)
    return out.transpose(1, 2)
