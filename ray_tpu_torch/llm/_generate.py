"""Autoregressive generation with a KV cache for the Llama model family —
PyTorch port of ``ray_tpu/llm/_generate.py``.

A prefill over the whole (LEFT-padded) prompt, then single-token decode
steps in a Python loop. KV caches are preallocated [layers, B, max_len,
kv_heads, head_dim] tensors written in place, and attention masks the
left-pad slots and the acausal cache positions. Left padding keeps every
row's decode positions contiguous and puts the final prompt logit at one
index.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.models.llama import (
    LlamaConfig,
    apply_rope,
    layer_params,
    rms_norm,
    rope_tables,
)


def _cached_attention(cfg: LlamaConfig, q, k_cache, v_cache, kv_len, invalid):
    """q [b, sq, h, hd] over caches [b, L, kv, hd]; `invalid` [b, L] marks
    left-pad slots that must never be attended; cache indices beyond kv_len
    and acausal ones are masked by index comparison."""
    b, sq, h, hd = q.shape
    L = k_cache.shape[1]
    kv = k_cache.shape[2]
    if kv != h:
        rep = h // kv
        k_cache = k_cache.repeat_interleave(rep, dim=2)
        v_cache = v_cache.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_cache.float()) * scale
    pos_k = torch.arange(L, device=q.device)[None, :]
    pos_q = (kv_len - sq) + torch.arange(sq, device=q.device)[:, None]
    causal = (pos_k <= pos_q)[None, None]              # [1,1,sq,L]
    ok = causal & ~invalid[:, None, None, :]           # [b,1,sq,L]
    logits = logits.masked_fill(~ok, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_cache)


def _layer_with_cache(cfg: LlamaConfig, h, p, cos, sin, k_cache, v_cache,
                      start: int, invalid):
    """One layer over tokens at cache slots [start, start + s); writes their
    K/V into this layer's caches in place."""
    dt = cfg.dtype
    b, s, _ = h.shape
    hd = cfg.head_dim
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
    k = (x @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (x @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    k_cache[:, start:start + s] = k.to(k_cache.dtype)
    v_cache[:, start:start + s] = v.to(v_cache.dtype)
    o = _cached_attention(cfg, q, k_cache, v_cache, start + s, invalid)
    h = h + o.reshape(b, s, -1) @ p["wo"].to(dt)
    x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    gate = F.silu(x2 @ p["w1"].to(dt))
    up = x2 @ p["w3"].to(dt)
    return h + (gate * up) @ p["w2"].to(dt)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               device) -> Dict[str, Any]:
    hd = cfg.head_dim
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _block_forward(cfg: LlamaConfig, params, tokens, positions, cache,
                   start: int, invalid):
    """tokens [b, s] at per-row `positions` [b, s] → logits; the cache is
    written in place."""
    dt = cfg.dtype
    h = params["tok_emb"].to(dt)[tokens]
    cos, sin = rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        h = _layer_with_cache(cfg, h, layer_params(params, i), cos, sin,
                              cache["k"][i], cache["v"][i], start, invalid)
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    return (h @ params["lm_head"].to(dt)).float()


def _sampler(temperature: float, seed: int, device):
    """lg [..., vocab] → token ids: argmax at temperature 0, else a draw
    from a torch generator seeded with ``seed`` (not jax.random's stream)."""
    if temperature == 0.0:
        return lambda lg: torch.argmax(lg, dim=-1)
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def sample(lg):
        probs = torch.softmax(lg / max(temperature, 1e-6), dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=gen).reshape(
            probs.shape[:-1])

    return sample


@torch.no_grad()
def generate_stream(cfg: LlamaConfig, params, prompt_ids, *,
                    max_new_tokens: int = 16, temperature: float = 0.0,
                    seed: int = 0, eos_id: Optional[int] = None):
    """Single-sequence INCREMENTAL generation: yields one token id at a
    time as soon as it is sampled. Prompt length buckets to powers of two
    and the cache length to a power of two of the token budget, as in the
    JAX version."""
    dev = params["tok_emb"].device
    p = list(prompt_ids) or [0]
    plen = len(p)
    S = max(8, 1 << (plen - 1).bit_length())
    total = S + max(16, 1 << (max_new_tokens - 1).bit_length())
    pad = S - plen
    prompt = np.zeros((1, S), dtype=np.int64)
    prompt[0, pad:] = p  # left-pad
    invalid = torch.from_numpy(np.arange(total) < pad)[None].to(dev)
    positions = torch.clamp(torch.arange(S, device=dev)[None] - pad, min=0)
    cache = init_cache(cfg, 1, total, dev)
    logits = _block_forward(cfg, params, torch.from_numpy(prompt).to(dev),
                            positions, cache, 0, invalid)
    sample = _sampler(temperature, seed, dev)
    tok = int(sample(logits[0, -1]))
    for i in range(max_new_tokens):
        if eos_id is not None and tok == eos_id:
            return
        yield tok
        if i == max_new_tokens - 1:
            return
        logits = _block_forward(
            cfg, params, torch.tensor([[tok]], device=dev),
            torch.tensor([[plen + i]], device=dev), cache, S + i, invalid)
        tok = int(sample(logits[0, 0]))


@torch.no_grad()
def generate(cfg: LlamaConfig, params, prompts, *, max_new_tokens: int = 16,
             temperature: float = 0.0, seed: int = 0,
             eos_id: Optional[int] = None) -> list:
    """Batch generation. prompts: list of int lists → list of int lists."""
    dev = params["tok_emb"].device
    b = len(prompts)
    S = max(1, max(len(p) for p in prompts))
    prompt = np.zeros((b, S), dtype=np.int64)
    plen = np.zeros((b,), dtype=np.int64)
    for i, p in enumerate(prompts):
        if p:
            prompt[i, S - len(p):] = p  # left-pad
        plen[i] = len(p)
    prompt_len = torch.from_numpy(plen).to(dev)
    total = S + max_new_tokens
    pad = (S - prompt_len)[:, None]                        # [b,1]
    invalid = torch.arange(total, device=dev)[None, :] < pad  # left-pad slots
    cache = init_cache(cfg, b, total, dev)
    positions = torch.clamp(torch.arange(S, device=dev)[None, :] - pad, min=0)
    logits = _block_forward(cfg, params, torch.from_numpy(prompt).to(dev),
                            positions, cache, 0, invalid)
    sample = _sampler(temperature, seed, dev)
    tok = sample(logits[:, -1])  # left-padded: last real token at S-1
    toks = [tok]
    for i in range(max_new_tokens - 1):
        logits = _block_forward(cfg, params, tok[:, None],
                                (prompt_len + i)[:, None], cache, S + i,
                                invalid)
        tok = sample(logits[:, 0])
        toks.append(tok)
    out = torch.stack(toks, dim=1).cpu().numpy()
    results = []
    for i in range(b):
        row = out[i].tolist()
        if eos_id is not None and eos_id in row:
            row = row[: row.index(eos_id)]
        results.append(row)
    return results
