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

The ring-attention hop primitives (``parallel/ring_attention.py``) follow
the same rule: ``flash_chunk_bhsd`` runs ``csrc/flash_chunk.cu`` (K4, the
port of ``_chunk_kernel``) on CUDA and ``_chunk_xla`` on the CPU;
``flash_hop_bwd`` runs K2 and K3 with fp32 outputs (K5) on CUDA and
``_hop_bwd_xla`` on the CPU.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30

# Kernel launches since import (or since a caller reset them): a run reads
# them to show its path went through the kernels. K1, K2 (and K5a, its
# fp32-dq launch), K3 (and K5b, its fp32-dk/dv launch), K4.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
flash_chunk_launches = 0


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


def _hop_bwd_xla(q, k, v, g, lse, delta, causal: bool):
    """The plain version of the K2 and K3 kernels: (dq, dk, dv) in fp32,
    dk/dv summed over each kv head's query heads. The JAX package's
    ``_hop_bwd_xla``, op for op: the backward of one K/V block against
    lse/delta rows (b, h, sq, 1) supplied from outside (the ring's GLOBAL
    rows), p recomputed under the top-left causal mask, ds = p (dp - delta).

    q/g: (b, h, sq, hd); k/v: (b, kvh, sk, hd); sq and sk may differ."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    rep = h // kvh
    scale = 1.0 / math.sqrt(hd)
    qf, gf = q.float(), g.float()
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, NEG_INF)
    p = torch.exp(s - lse)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.reshape(b, kvh, rep, sk, hd).sum(dim=2)
    dv = dv.reshape(b, kvh, rep, sk, hd).sum(dim=2)
    return dq, dk, dv


def _flash_bwd_reference(q, k, v, o, lse, g, causal: bool):
    """The plain version of the K2 and K3 kernels as the flash backward
    calls them (as ``_flash_bwd_tpu``): delta = rowsum(g * o), then
    ``_hop_bwd_xla``; dq in q's dtype, dk/dv in k's and v's."""
    delta = (g.float() * o.float()).sum(dim=-1, keepdim=True)
    dq, dk, dv = _hop_bwd_xla(q, k, v, g, lse, delta, causal)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _chunk_xla(q, k, v, o, m, l, causal: bool):
    """The plain version of K4: online-softmax accumulation of one K/V
    chunk, op for op as the JAX package's ``_chunk_xla`` (the finite
    NEG_INF mask, ``exp(m - new_m)`` with m possibly -inf, p cast to v's
    dtype before PV).

    q: (b, h, sq, hd); k/v: (b, kvh, sk, hd); o: (b, h, sq, hd) fp32; m/l:
    (b, h, sq, 1) fp32 running max / denominator. ``causal`` masks with
    LOCAL positions (the diagonal ring hop). Returns the new (o, m, l), o
    un-normalised."""
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if kvh != h:
        rep = h // kvh
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(q_pos < k_pos, NEG_INF)
    block_max = logits.amax(dim=-1, keepdim=True)
    new_m = torch.maximum(m, block_max)
    corr = torch.exp(m - new_m)
    p = torch.exp(logits - new_m)
    new_l = l * corr + p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return o * corr + pv, new_m, new_l


# ---------------------------------------------------------------------------
# the kernels (K1 forward; K2, K3 backward; K4 the ring hop; K5 = K2 + K3
# with fp32 outputs)
# ---------------------------------------------------------------------------


def _check_inputs(kernel: str, q, k, v, same_length: bool, bf16=None,
                  fp32=None):
    """Raise on inputs the CUDA kernels do not take, before anything is
    built or launched: q (b, h, sq, hd) and k/v (b, kvh, sk, hd) in bf16,
    head_dim 64 or 128, h % kvh == 0, sq == sk where ``same_length``;
    ``bf16`` / ``fp32`` map the names of further inputs to (tensor, shape).
    Every input contiguous and on q's device; q, k and v 16-byte
    aligned."""
    extra = {**(bf16 or {}), **(fp32 or {})}
    wrong = {n: t.dtype for n, t in [("q", q), ("k", k), ("v", v)] + [
        (n, t) for n, (t, _) in (bf16 or {}).items()]
        if t.dtype != torch.bfloat16}
    wrong.update({n: t.dtype for n, (t, _) in (fp32 or {}).items()
                  if t.dtype != torch.float32})
    if wrong:
        raise TypeError(f"{kernel} takes bf16 q/k/v "
                        f"{' '.join(bf16 or ())} and fp32 "
                        f"{' '.join(fp32 or ())}; got {wrong}")
    b, h, sq, hd = q.shape
    if hd not in (64, 128):
        raise ValueError(f"{kernel} takes head_dim 64 or 128, got {hd}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != hd or (same_length and k.shape[2] != sq):
        raise ValueError(f"k/v must be (b, kvh, {'s' if same_length else 'sk'}"
                         f", hd) matching q {tuple(q.shape)}; got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if h % k.shape[1] != 0:
        raise ValueError(f"heads {h} not a multiple of kv heads {k.shape[1]}")
    bad = {n: (tuple(t.shape), shape) for n, (t, shape) in extra.items()
           if tuple(t.shape) != shape}
    if bad:
        raise ValueError(f"{kernel}: shapes (got, want) {bad}")
    tensors = [q, k, v] + [t for t, _ in extra.values()]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} takes contiguous inputs")
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{kernel}: every input must be on q's device")
    # the forward kernels read q, k and v through TMA, which needs 16-byte
    # aligned global addresses (the backward's 16-byte loads do too)
    unaligned = [n for n, t in (("q", q), ("k", k), ("v", v))
                 if t.data_ptr() % 16]
    if unaligned:
        raise ValueError(f"{kernel}: {', '.join(unaligned)} not at a 16-byte "
                         f"aligned address (data_ptr() % 16 != 0), as a view "
                         f"at an odd storage offset is")


def _flash_fwd_cuda(q, k, v, causal: bool):
    """Launch K1 on q's device and current stream. Returns (o, lse)."""
    global flash_fwd_launches
    _check_inputs("flash_fwd kernel", q, k, v, same_length=True)
    b, h, s, hd = q.shape
    kvh = k.shape[1]
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
    rows = tuple(q.shape[:3]) + (1,)
    _check_inputs("flash_bwd kernels", q, k, v, same_length=True,
                  bf16={"o": (o, tuple(q.shape)), "dO": (g, tuple(q.shape))},
                  fp32={"lse": (lse, rows)})
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


def _launch_dkv(q, k, v, g, lse, delta, causal: bool,
                dkv_fp32: bool = False):
    """K3 on inputs ``_flash_bwd_cuda`` has checked: (dk, dv) in k/v's
    dtype (fp32 when ``dkv_fp32``, the ring-hop backward's), summed over
    each kv head's query heads."""
    global flash_bwd_dkv_launches
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_bwd")
    b, h, sq, hd = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    dt = torch.float32 if dkv_fp32 else k.dtype
    dk = torch.empty_like(k, dtype=dt)
    dv = torch.empty_like(v, dtype=dt)
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, kvh, sq, sk, hd, int(bool(causal)), int(bool(dkv_fp32)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd dkv kernel launch failed: "
                           f"cudaError {rc}")
    flash_bwd_dkv_launches += 1
    return dk, dv


def _flash_chunk_cuda(q, k, v, o, m, l, causal: bool):
    """Launch K4 on q's device and current stream. Returns the new (o, m,
    l) in fresh fp32 tensors: the inputs stay as they were, since the
    chunk's backward recomputes from them."""
    global flash_chunk_launches
    b, h, sq, hd = q.shape
    rows = (b, h, sq, 1)
    _check_inputs("flash_chunk kernel", q, k, v, same_length=False,
                  fp32={"o": (o, tuple(q.shape)), "m": (m, rows),
                        "l": (l, rows)})
    kvh, sk = k.shape[1], k.shape[2]
    from ray_tpu_torch.ops import _build

    lib = _build.load("flash_chunk")
    o2, m2, l2 = torch.empty_like(o), torch.empty_like(m), torch.empty_like(l)
    with torch.cuda.device(q.device):
        rc = lib.flash_chunk_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), o2.data_ptr(), m2.data_ptr(),
            l2.data_ptr(), b, h, kvh, sq, sk, hd, int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_chunk kernel launch failed: cudaError {rc}")
    flash_chunk_launches += 1
    return o2, m2, l2


def _hop_bwd_cuda(q, k, v, g, lse, delta, causal: bool):
    """K5: K2 with an fp32 dq and K3 with fp32 dk/dv against one K/V block
    and the given lse/delta rows. Returns fp32 (dq, dk, dv)."""
    rows = tuple(q.shape[:3]) + (1,)
    _check_inputs("flash_hop_bwd kernels", q, k, v, same_length=False,
                  bf16={"dO": (g, tuple(q.shape))},
                  fp32={"lse": (lse, rows), "delta": (delta, rows)})
    dq = _launch_dq(q, k, v, g, lse, delta, causal, dq_fp32=True)
    dk, dv = _launch_dkv(q, k, v, g, lse, delta, causal, dkv_fp32=True)
    return dq, dk, dv


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


class _FlashChunk(torch.autograd.Function):
    """The JAX package's ``flash_chunk_bhsd`` custom VJP: K4 forward on
    CUDA, ``_chunk_xla`` on the CPU. The residuals are the six inputs, and
    the backward is autograd of ``_chunk_xla`` on them
    (``_chunk_bwd_rule``)."""

    @staticmethod
    def forward(ctx, q, k, v, o, m, l, causal):
        if q.is_cuda:
            out = _flash_chunk_cuda(q, k, v, o, m, l, causal)
        else:
            out = _chunk_xla(q, k, v, o, m, l, causal)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, go, gm, gl):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _chunk_xla(*inputs, ctx.causal)
        return torch.autograd.grad(out, inputs, (go, gm, gl)) + (None,)


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


def flash_chunk_bhsd(q, k, v, o, m, l, causal: bool = False,
                     block_q: int = 512, block_k: int = 512):
    """One online-softmax accumulation hop with carried (o, m, l) state,
    the ring-attention primitive. q: (b, h, sq, hd); k/v: (b, kvh, sk, hd);
    o (b, h, sq, hd), m/l (b, h, sq, 1) fp32 (m = -inf, l = o = 0 is a
    fresh state). Returns the new (o, m, l), o un-normalised.

    K4 on CUDA (no (sq, sk) scores in device memory); the backward
    recomputes the hop in plain PyTorch, so the residuals are the six
    inputs. ``block_q``/``block_k`` keep the JAX signature."""
    if q.is_cuda or q.device.type == "cpu":
        return _FlashChunk.apply(q, k, v, o, m, l, causal)
    raise ValueError(f"flash_chunk_bhsd has no path for device {q.device}")


def flash_hop_bwd(q, k, v, g, lse, delta, causal: bool,
                  block_q: int = 512, block_k: int = 512):
    """Backward of one ring-attention hop given the GLOBAL lse/delta rows
    (b, h, sq, 1) fp32 that the ring forward saved: (dq, dk, dv) in fp32,
    dk/dv at k's kv heads. K2 and K3 with fp32 outputs (K5) on CUDA,
    ``_hop_bwd_xla`` on the CPU. ``block_q``/``block_k`` keep the JAX
    signature."""
    if q.is_cuda:
        return _hop_bwd_cuda(q, k, v, g, lse, delta, causal)
    if q.device.type == "cpu":
        return _hop_bwd_xla(q, k, v, g, lse, delta, causal)
    raise ValueError(f"flash_hop_bwd has no path for device {q.device}")
