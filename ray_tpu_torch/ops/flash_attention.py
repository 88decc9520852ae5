"""Flash attention forward for PyTorch on Hopper.

Counterpart of ``ray_tpu/ops/flash_attention.py``. Layout is (batch, heads,
seq, head_dim) ("bhsd") end to end; a (batch, seq, heads, head_dim) wrapper
is kept for callers that use the attention-standard layout. GQA maps query
head ``hi`` to kv head ``hi // (h // kvh)``.

* A CUDA tensor goes to the hand-written kernel ``csrc/flash_fwd.cu`` (the
  port of the TPU kernel ``_fwd_kernel``), or the wrapper raises: bf16,
  head_dim 64 or 128, ``h % kvh == 0``, contiguous, q and k/v of one length.
* A CPU tensor takes the plain version, ``_attention_reference``.

Only the forward is ported. Backward through a CUDA tensor raises: it needs
the dq/dkv kernels, which the training slice ports.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30

# K1 launches since import (or since a caller reset it): a run reads it to
# show its path went through the kernel.
flash_fwd_launches = 0


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


# ---------------------------------------------------------------------------
# the kernel (K1)
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


class _FlashFwd(torch.autograd.Function):
    """K1 under autograd: the forward is the kernel; the backward needs the
    dq/dkv kernels (K2 ``_dq_kernel``, K3 ``_dkv_kernel``), not ported yet."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        return _flash_fwd_cuda(q, k, v, causal)[0]

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash attention backward on CUDA needs kernels K2 (_dq_kernel) "
            "and K3 (_dkv_kernel), which are not ported yet")


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def flash_attention_bhsd(q, k, v, causal: bool = True,
                         block_q: int = 512, block_k: int = 512):
    """q: (batch, heads, seq, head_dim); k/v: (batch, kv_heads, seq, head_dim).

    ``block_q``/``block_k`` keep the JAX signature; the Hopper kernel picks
    its own 64-row tiles."""
    if q.is_cuda:
        return _FlashFwd.apply(q, k, v, causal)
    if q.device.type == "cpu":
        return _attention_reference(q, k, v, causal)[0]
    raise ValueError(f"flash attention has no path for device {q.device}")


def flash_attention(q, k, v, causal: bool = True,
                    block_q: int = 512, block_k: int = 512):
    """Layout-standard entry. q/k/v: (batch, seq, heads, head_dim)."""
    out = flash_attention_bhsd(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), causal, block_q, block_k)
    return out.transpose(1, 2)
