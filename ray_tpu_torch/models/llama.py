"""Llama-family decoder in PyTorch — counterpart of ``ray_tpu/models/llama.py``.

Plain functions on a parameter dict with the JAX package's keys, shapes and
``(L, in, out)`` orientation: ``tok_emb``, stacked ``layers`` {ln1, ln2, wq,
wk, wv, wo, w1, w2, w3}, ``norm``, ``lm_head``. Weights therefore move 1:1
between the two packages (``models/convert.py``). The layer stack runs as a
Python loop over the leading layer axis where JAX scans it. bf16
activations, fp32 RMSNorm statistics and softmax; RoPE, GQA and SwiGLU
follow Llama-2/3.

``attention_impl``: "xla" is plain PyTorch attention (the name is the JAX
package's); "flash" projects straight to (b, h, s, hd) and calls the K1
kernel on CUDA. "ring" and "ulysses" need the sequence-parallel slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    # attention implementation: "xla" (plain torch), "flash" (K1 kernel on
    # CUDA); "ring" / "ulysses" are not ported yet
    attention_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                   ffn_dim=11008, **kw)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, ffn_dim=14336, rope_theta=500000.0, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test/CI-size config."""
        return cls(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_dim=256, max_seq_len=256, **kw)

    def num_params(self) -> int:
        hd = self.head_dim
        per_layer = (
            self.dim * self.n_heads * hd          # wq
            + 2 * self.dim * self.n_kv_heads * hd  # wk, wv
            + self.n_heads * hd * self.dim         # wo
            + 3 * self.dim * self.ffn_dim          # w1, w2, w3 (w2 transposed)
            + 2 * self.dim                         # ln1, ln2
        )
        return (
            self.vocab_size * self.dim             # tok_emb
            + self.n_layers * per_layer
            + self.dim                             # final norm
            + self.dim * self.vocab_size           # lm_head
        )


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random weights N(0, 1/fan_in) from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default CUDA). Stacked layer weights are drawn
    one layer at a time, so the fp32 draw never holds more than one layer."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    hd = cfg.head_dim
    pd = cfg.param_dtype
    L = cfg.n_layers

    def dense(fan_in, shape):
        out = torch.empty(shape, dtype=pd, device=dev)
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                       * (1.0 / math.sqrt(fan_in)))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=dev)

    return {
        "tok_emb": dense(cfg.dim, (cfg.vocab_size, cfg.dim)),
        "layers": {
            "ln1": ones((L, cfg.dim)),
            "ln2": ones((L, cfg.dim)),
            "wq": dense(cfg.dim, (L, cfg.dim, cfg.n_heads * hd)),
            "wk": dense(cfg.dim, (L, cfg.dim, cfg.n_kv_heads * hd)),
            "wv": dense(cfg.dim, (L, cfg.dim, cfg.n_kv_heads * hd)),
            "wo": dense(cfg.n_heads * hd, (L, cfg.n_heads * hd, cfg.dim)),
            "w1": dense(cfg.dim, (L, cfg.dim, cfg.ffn_dim)),
            "w3": dense(cfg.dim, (L, cfg.dim, cfg.ffn_dim)),
            "w2": dense(cfg.ffn_dim, (L, cfg.ffn_dim, cfg.dim)),
        },
        "norm": ones((cfg.dim,)),
        "lm_head": dense(cfg.dim, (cfg.dim, cfg.vocab_size)),
    }


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {name: w[i] for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    # fp32 statistics even under bf16 activations
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight.to(x.dtype)


def rope_tables(cfg: LlamaConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., seq) int → cos/sin (..., seq, head_dim/2), fp32."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, hd); cos/sin: (b, s, hd/2) or (s, hd/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope_bhsd(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """x: (b, h, s, hd); cos/sin: (s, hd/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = cos[None, None, :, :], sin[None, None, :, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _attention_xla(q, k, v, causal: bool = True):
    """Plain attention; fp32 softmax. q: (b, s, h, hd), k/v (b, s, kv, hd)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    if kv != h:  # GQA: repeat kv heads
        rep = h // kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(hd)
    # bf16 operands are exact in fp32, so this is JAX's
    # preferred_element_type=float32 product
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sk = k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(
            sk - sq)
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(cfg: LlamaConfig, q, k, v):
    if cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} needs the sequence-"
            "parallel slice (ring attention / Ulysses), not ported yet")
    if cfg.attention_impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True)
    return _attention_xla(q, k, v, causal=True)


def _ffn(cfg: LlamaConfig, h, p):
    dt = cfg.dtype
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    gate = F.silu(x @ p["w1"].to(dt))
    up = x @ p["w3"].to(dt)
    return (gate * up) @ p["w2"].to(dt)


def _layer(cfg: LlamaConfig, h, layer_params, cos, sin):
    p = layer_params
    hd = cfg.head_dim
    b, s, _ = h.shape
    dt = cfg.dtype

    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if cfg.attention_impl == "flash":
        # bhsd hot path: projections emit (b, h, s, hd) directly, the
        # kernel's layout
        from ray_tpu_torch.ops.flash_attention import flash_attention_bhsd

        wq = p["wq"].to(dt).reshape(cfg.dim, cfg.n_heads, hd)
        wk = p["wk"].to(dt).reshape(cfg.dim, cfg.n_kv_heads, hd)
        wv = p["wv"].to(dt).reshape(cfg.dim, cfg.n_kv_heads, hd)
        q = torch.einsum("bsd,dhk->bhsk", x, wq)
        k = torch.einsum("bsd,dhk->bhsk", x, wk)
        v = torch.einsum("bsd,dhk->bhsk", x, wv)
        q = apply_rope_bhsd(q, cos, sin)
        k = apply_rope_bhsd(k, cos, sin)
        o = flash_attention_bhsd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
        wo = p["wo"].to(dt).reshape(cfg.n_heads, hd, cfg.dim)
        attn = torch.einsum("bhsk,hkd->bsd", o, wo)
    else:
        q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
        k = (x @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
        v = (x @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attention(cfg, q, k, v)
        attn = attn.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(dt)
    h = h + attn
    return h + _ffn(cfg, h, p)


def forward(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (b, s) int → logits (b, s, vocab) in fp32."""
    dt = cfg.dtype
    h = params["tok_emb"].to(dt)[tokens]
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        h = _layer(cfg, h, layer_params(params, i), cos, sin)
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    return (h @ params["lm_head"].to(dt)).float()


def loss_fn(cfg: LlamaConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy; tokens (b, s)."""
    logits = forward(cfg, params, tokens[:, :-1])
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.mean()
