"""Continuous-batching LLM engine with a paged KV cache — PyTorch port of
``ray_tpu/llm/_engine.py``.

- **Paged KV cache**: one shared pool of fixed-size KV blocks
  ([layers, num_blocks, block_size, kv_heads, head_dim]); each decode slot
  owns a block table (physical block ids). Finished sequences return their
  blocks to the pool and a new request reuses them immediately.
- **In-place pool updates**: where the JAX engine donates the pool to each
  jitted step and gets a new one back, the steps here write K/V into the
  pool with in-place ``index_put_``. Inactive decode slots and padded
  prompt positions write to the reserved trash block 0, so duplicate
  indices in one write land only there.
- **Steps stay eager**: the decode step runs over the fixed slot count
  (inactive slots masked), the prefill per pow-2 length bucket.
- **Prompt attention**: a full prefill (prompt from position 0) computes
  its causal attention with ``flash_attention_bhsd``, which is the K1
  kernel on CUDA. For every query row below the prompt length that equals
  the JAX engine's ``(q >= k) & (k < plen)`` mask; rows at or past it only
  feed trash-block K/V and discarded logits. The suffix prefill and the
  decode keep plain masked attention over the paged gather, as in JAX.
- **Continuous batching and streaming**: requests arriving mid-decode join
  the running batch at the next step boundary; tokens flow to callers
  through per-request async queues.
- **Two threads**: the asyncio loop owns the host state, the request
  queues and the metrics; the model steps (admission's prefill and the
  decode step) run on one worker thread, which hands its results back to
  the loop and touches no queue.
- **Spans** (``util/tracing.py``, recorded while tracing is on or a
  profiler runs): on the loop ``engine.turn``, ``engine.wait``,
  ``engine.idle`` (which tile its time), ``engine.emit`` and each
  request's ``engine.queue``; on the worker ``engine.step`` (holding
  ``engine.launch`` and ``engine.sync``) and ``engine.admit`` (holding
  ``engine.prefill`` and ``engine.first_token``).
"""

from __future__ import annotations

import asyncio
import collections
import concurrent.futures
import math
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.llama import (LlamaConfig, layer_params, rms_norm,
                                        rope_tables)
from ray_tpu_torch.util import tracing

__all__ = ["EngineConfig", "PagedEngine"]


@dataclass
class EngineConfig:
    """Sizing knobs (reference: vLLM engine_kwargs max_num_seqs /
    block_size / gpu_memory_utilization → num blocks)."""

    max_num_seqs: int = 4          # decode batch slots
    kv_block_size: int = 16        # tokens per KV block
    num_kv_blocks: int = 64        # pool size (excl. the trash block)
    max_model_len: int = 256       # prompt + generation cap per sequence
    # None = follow the llm_prefix_cache_enabled config flag
    prefix_cache: Optional[bool] = None


# ---------------------------------------------------------------------------
# model steps (paged attention)
# ---------------------------------------------------------------------------


def _apply_rope_q(x, cos, sin):
    x1, x2 = x.float().chunk(2, dim=-1)
    # cos/sin [b, s, hd/2] → broadcast over heads
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _masked_attention(cfg: LlamaConfig, q, k_all, v_all, valid):
    """q [B, S, H, hd] over gathered k/v [B, Lk, KV, hd]; valid [B, S, Lk]."""
    if cfg.n_kv_heads != cfg.n_heads:
        rep = cfg.n_heads // cfg.n_kv_heads
        k_all = k_all.repeat_interleave(rep, dim=2)
        v_all = v_all.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    lg = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_all.float()) * scale
    lg = lg.masked_fill(~valid[:, None], -1e30)
    probs = torch.softmax(lg, dim=-1).to(cfg.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v_all)


def _mlp(cfg: LlamaConfig, h, p):
    dt = cfg.dtype
    x2 = rms_norm(h, p["ln2"], cfg.norm_eps)
    gate = F.silu(x2 @ p["w1"].to(dt))
    up = x2 @ p["w3"].to(dt)
    return h + (gate * up) @ p["w2"].to(dt)


def _qkv(cfg: LlamaConfig, h, p, cos, sin):
    """Roped q [B, S, H, hd] and k, v [B, S, KV, hd] of one layer."""
    dt = cfg.dtype
    B, S, _ = h.shape
    hd = cfg.head_dim
    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    q = (x @ p["wq"].to(dt)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p["wk"].to(dt)).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p["wv"].to(dt)).reshape(B, S, cfg.n_kv_heads, hd)
    return (_apply_rope_q(q, cos, sin).to(dt), _apply_rope_q(k, cos, sin).to(dt),
            v)


def _logits(cfg: LlamaConfig, params, h):
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    return (h @ params["lm_head"].to(cfg.dtype)).float()


def _make_decode_step(cfg: LlamaConfig, ecfg: EngineConfig):
    """Build the whole-batch single-token decode step."""
    bs = ecfg.kv_block_size
    max_blocks = -(-ecfg.max_model_len // bs)
    Lmax = max_blocks * bs

    def step(params, kc, vc, tables, lens, active, last_tok, gens, temps):
        """kc/vc [L, NB, BS, KV, HD], written in place; tables
        [B, max_blocks], lens/active/last_tok [B] on the pool's device;
        gens: per-slot torch.Generator (or None); temps: host [B].
        Returns next_tok [B] (int64, on the device)."""
        dt = cfg.dtype
        B = last_tok.shape[0]
        hd = cfg.head_dim
        dev = kc.device
        h = params["tok_emb"].to(dt)[last_tok][:, None]          # [B,1,D]
        cos, sin = rope_tables(cfg, lens[:, None])
        # inactive slots write into the reserved trash block 0
        blk = torch.clamp(lens // bs, 0, max_blocks - 1)
        phys = torch.where(active, tables[torch.arange(B, device=dev), blk],
                           0)
        off = lens % bs
        idx = torch.arange(Lmax, device=dev)
        valid = ((idx[None, :] <= lens[:, None])
                 & active[:, None])[:, None, :]                 # [B,1,Lmax]

        for i in range(cfg.n_layers):
            p = layer_params(params, i)
            q, k, v = _qkv(cfg, h, p, cos, sin)
            kc[i].index_put_((phys, off), k[:, 0])
            vc[i].index_put_((phys, off), v[:, 0])
            # paged gather: [B, max_blocks, BS, KV, HD] → [B, Lmax, KV, HD]
            k_all = kc[i][tables].reshape(B, Lmax, cfg.n_kv_heads, hd)
            v_all = vc[i][tables].reshape(B, Lmax, cfg.n_kv_heads, hd)
            o = _masked_attention(cfg, q, k_all, v_all, valid)
            h = h + o.reshape(B, 1, -1) @ p["wo"].to(dt)
            h = _mlp(cfg, h, p)
        logits = _logits(cfg, params, h[:, 0])

        out = torch.argmax(logits, dim=-1)
        for b in np.flatnonzero(temps > 0):
            if gens[b] is None:
                continue  # released slot: its temperature is stale
            probs = torch.softmax(logits[b] / max(float(temps[b]), 1e-6), -1)
            out[b] = torch.multinomial(probs, 1, generator=gens[b])[0]
        return out

    return step


def _make_prefill(cfg: LlamaConfig, ecfg: EngineConfig):
    """Single-request prefill at a padded length S: causal attention over
    the prompt through K1, KV scattered into the request's blocks; returns
    the last prompt position's logits."""
    from ray_tpu_torch.ops.flash_attention import flash_attention_bhsd

    bs = ecfg.kv_block_size

    def prefill(S, params, kc, vc, table, prompt, plen):
        """prompt [S] right-padded; table [max_blocks]; plen int."""
        dt = cfg.dtype
        dev = kc.device
        h = params["tok_emb"].to(dt)[prompt][None]   # [1,S,D]
        idx = torch.arange(S, device=dev)
        cos, sin = rope_tables(cfg, idx[None])
        # scatter destinations; padded positions go to the trash block 0
        phys = torch.where(idx < plen, table[torch.clamp(
            idx // bs, 0, table.shape[0] - 1)], 0)
        off = idx % bs

        for i in range(cfg.n_layers):
            p = layer_params(params, i)
            q, k, v = _qkv(cfg, h, p, cos, sin)
            kc[i].index_put_((phys, off), k[0])
            vc[i].index_put_((phys, off), v[0])
            o = flash_attention_bhsd(q.transpose(1, 2).contiguous(),
                                     k.transpose(1, 2).contiguous(),
                                     v.transpose(1, 2).contiguous(),
                                     causal=True)
            h = h + o.transpose(1, 2).reshape(1, S, -1) @ p["wo"].to(dt)
            h = _mlp(cfg, h, p)
        return _logits(cfg, params, h[0, min(max(plen - 1, 0), S - 1)])

    return prefill


def _make_suffix_prefill(cfg: LlamaConfig, ecfg: EngineConfig):
    """Prefill of a prompt SUFFIX over a cached prefix: the first
    ``cached_len`` tokens' KV already sit in the request's table blocks
    (spliced in from the prefix cache), so only the suffix runs through the
    model. Suffix K/V scatter at their absolute positions into the
    request's fresh blocks; attention gathers the WHOLE table (decode's
    paged-gather pattern) so suffix queries see the cached prefix keys."""
    bs = ecfg.kv_block_size
    max_blocks = -(-ecfg.max_model_len // bs)
    Lmax = max_blocks * bs

    def prefill_suffix(S, params, kc, vc, table, suffix, cached_len, slen):
        """suffix [S] right-padded tokens at absolute positions
        cached_len..cached_len+slen; table [max_blocks] the FULL row."""
        dt = cfg.dtype
        hd = cfg.head_dim
        dev = kc.device
        h = params["tok_emb"].to(dt)[suffix][None]   # [1,S,D]
        qidx = torch.arange(S, device=dev)
        qpos = cached_len + qidx                      # absolute
        cos, sin = rope_tables(cfg, qpos[None])
        in_range = qidx < slen
        # padded suffix positions scatter into the trash block 0
        phys = torch.where(in_range, table[torch.clamp(
            qpos // bs, 0, max_blocks - 1)], 0)
        off = qpos % bs
        kidx = torch.arange(Lmax, device=dev)
        # causal over ABSOLUTE positions: cached prefix keys are visible to
        # every live query; anything past the prompt is masked out
        valid = ((kidx[None, None, :] <= qpos[None, :, None])
                 & in_range[None, :, None])            # [1,S,Lmax]

        for i in range(cfg.n_layers):
            p = layer_params(params, i)
            q, k, v = _qkv(cfg, h, p, cos, sin)
            kc[i].index_put_((phys, off), k[0])
            vc[i].index_put_((phys, off), v[0])
            # paged gather AFTER the scatter: suffix keys join the cached
            # prefix keys already resident in the table's blocks
            k_all = kc[i][table].reshape(1, Lmax, cfg.n_kv_heads, hd)
            v_all = vc[i][table].reshape(1, Lmax, cfg.n_kv_heads, hd)
            o = _masked_attention(cfg, q, k_all, v_all, valid)
            h = h + o.reshape(1, S, -1) @ p["wo"].to(dt)
            h = _mlp(cfg, h, p)
        return _logits(cfg, params, h[0, min(max(slen - 1, 0), S - 1)])

    return prefill_suffix


@dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_tokens: int
    temperature: float
    seed: int
    queue: asyncio.Queue = None  # type: ignore[assignment]
    slot: int = -1
    produced: int = 0
    admitted_mid_decode: bool = False
    # consumer walked away (client disconnect / stream cancel): the engine
    # loop drops it from the waiting queue or releases its slot + blocks
    # at the next step boundary instead of decoding for nobody
    aborted: bool = False
    t_start: float = 0.0  # monotonic enqueue time (TTFT signal)
    # disaggregated serving: prefill ran on ANOTHER worker; admission
    # injects the transferred KV blocks instead of running _prefill
    prefilled: Optional[tuple] = None  # (k [L,nb,bs,kvh,hd], v, last_logits)
    # the caller's span at enqueue (the request's spans chain to it) and
    # the open engine.queue span
    trace_parent: Optional[dict] = None
    queue_span: Optional[dict] = None


class PagedEngine:
    """The continuous-batching scheduler around the model steps.

    Host-side state (block free list, slot table, request queues) is plain
    Python owned by ONE engine loop task; device state (block pool) lives
    on ``device`` (default CUDA), where ``params`` must already be. Call
    ``generate_stream`` concurrently — requests arriving mid-decode are
    admitted at the next step boundary."""

    def __init__(self, cfg: LlamaConfig, params,
                 ecfg: Optional[EngineConfig] = None,
                 eos_id: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        if params["tok_emb"].device.type != self.device.type:
            raise ValueError(f"params live on {params['tok_emb'].device}, "
                             f"engine device is {self.device}")
        self.cfg = cfg
        self.ecfg = ecfg or EngineConfig()
        self.params = params
        self.eos_id = eos_id
        e = self.ecfg
        self.bs = e.kv_block_size
        self.max_blocks = -(-e.max_model_len // self.bs)
        B = e.max_num_seqs
        self.tables = np.zeros((B, self.max_blocks), np.int64)
        self.lens = np.zeros((B,), np.int64)
        self.active = np.zeros((B,), bool)
        self.last_tok = np.zeros((B,), np.int64)
        self.temps = np.zeros((B,), np.float32)
        self.slot_req: List[Optional[_Request]] = [None] * B
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        enabled = e.prefix_cache
        if enabled is None:
            enabled = GLOBAL_CONFIG.get("llm_prefix_cache_enabled")
        self._prefix_cache = None
        if enabled:
            from ray_tpu_torch.llm._prefix_cache import PrefixCache

            self._prefix_cache = PrefixCache(
                self.bs, GLOBAL_CONFIG.get("llm_prefix_cache_max_entries"))
        # the KV pool; block 0 is the trash block
        NB = e.num_kv_blocks + 1
        self.kc = torch.zeros(
            (cfg.n_layers, NB, self.bs, cfg.n_kv_heads, cfg.head_dim),
            dtype=cfg.dtype, device=self.device)
        self.vc = torch.zeros_like(self.kc)
        self.free_blocks = list(range(1, NB))
        self._decode = _make_decode_step(cfg, e)
        self._prefill = _make_prefill(cfg, e)
        self._suffix_prefill = _make_suffix_prefill(cfg, e)
        self._pending: "asyncio.Queue[_Request]" = None  # type: ignore
        self._loop_task = None
        # every prefill and decode step runs on this one worker thread, so
        # per-thread device-library state (cuBLAS handles and workspaces)
        # is made once, not on each new thread of a default executor
        self._worker = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="paged-engine")
        self._rid = 0
        # per-slot sampling generators, seeded at admission
        self._gens: List[Optional[torch.Generator]] = [None] * B
        self.steps = 0
        self.tokens_out = 0
        self.mid_decode_admissions = 0
        self._ttfts = collections.deque(maxlen=256)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- admission ------------------------------------------------------

    def _blocks_needed(self, req: _Request) -> int:
        total = min(len(req.prompt) + req.max_tokens, self.ecfg.max_model_len)
        return -(-total // self.bs)

    def _free_with_eviction(self, want: int) -> bool:
        """True if the free list holds ``want`` blocks, evicting zero-ref
        prefix-cache blocks (LRU) to get there — cached-but-unused blocks
        are capacity, never a reason to refuse admission."""
        short = want - len(self.free_blocks)
        if short > 0 and self._prefix_cache is not None:
            self.free_blocks.extend(self._prefix_cache.evict(short))
        return len(self.free_blocks) >= want

    def _try_admit(self, req: _Request) -> Optional[tuple]:
        """Admission's device half, on the worker thread: blocks, the
        prefill and the first token. Returns (slot, first token, prefix
        blocks hit) for the loop to activate, or None when the head must
        wait for a slot or blocks. A request that cannot be admitted at
        all raises."""
        with tracing.span("engine.admit", parent=req.trace_parent,
                          attrs={"rid": req.rid}) as sp:
            return self._admit(req, sp)

    def _admit(self, req: _Request, sp: Optional[dict]) -> Optional[tuple]:
        need = self._blocks_needed(req)
        try:
            slot = next(i for i, r in enumerate(self.slot_req) if r is None)
        except StopIteration:
            return None
        free0 = len(self.free_blocks)
        if req.prefilled is not None:
            if not self._free_with_eviction(need):
                return None
            tracing.set_attrs(sp, hit_blocks=0, new_blocks=need,
                              evicted=len(self.free_blocks) - free0)
            return self._admit_prefilled(req, slot, need)
        cache = self._prefix_cache
        plen = len(req.prompt)
        hits: List[int] = []
        keys: List[bytes] = []
        if cache is not None:
            from ray_tpu_torch.llm._prefix_cache import chain_keys

            keys = chain_keys(req.prompt, self.bs)
            # reuse is capped one token short of the prompt: the LAST
            # prompt token must run through prefill locally or there are
            # no logits to sample the first generated token from
            hits = cache.match(keys[: (plen - 1) // self.bs])
        need_new = need - len(hits)
        if not self._free_with_eviction(need_new):
            if cache is not None:
                cache.cancel_match(hits)
            return None
        tracing.set_attrs(sp, hit_blocks=len(hits), new_blocks=need_new,
                          evicted=len(self.free_blocks) - free0)
        blocks = [self.free_blocks.pop() for _ in range(need_new)]
        row_blocks = hits + blocks
        try:
            row = np.zeros((self.max_blocks,), np.int64)
            row[: len(row_blocks)] = row_blocks
            self.tables[slot] = row
            cached_len = len(hits) * self.bs
            # with a cached prefix only the suffix runs, over its blocks
            slen = plen - cached_len
            S = max(8, 1 << (slen - 1).bit_length())  # pow-2 bucket
            toks = np.zeros((S,), np.int64)
            toks[:slen] = req.prompt[cached_len:]
            with torch.no_grad():
                with tracing.span("engine.prefill", on=sp is not None, attrs={
                        "rid": req.rid, "tokens": slen, "padded": S,
                        "cached_len": cached_len}):
                    if cached_len:
                        logits = self._suffix_prefill(
                            S, self.params, self.kc, self.vc, self._dev(row),
                            self._dev(toks), cached_len, slen)
                    else:
                        logits = self._prefill(
                            S, self.params, self.kc, self.vc, self._dev(row),
                            self._dev(toks), plen)
                tok = self._sample_first(req, slot, logits)
        except BaseException:
            # any failure between the block pop and slot activation must
            # hand the blocks back, or a few failing requests drain
            # free_blocks and admission deadlocks
            self.free_blocks.extend(blocks)
            if cache is not None:
                cache.cancel_match(hits)
            self.tables[slot] = 0
            raise
        if cache is not None and keys:
            # every FULL prompt block (matched prefix + freshly prefilled)
            # is now cacheable; this request holds one ref on each until
            # release. Cap-evicted zero-ref blocks return to the pool.
            full = plen // self.bs
            self.free_blocks.extend(
                cache.register(keys[:full], row_blocks[:full]))
        return slot, tok, len(hits)

    def _emit(self, req: _Request, tok: int):
        req.produced += 1
        self.tokens_out += 1
        if req.produced == 1 and req.t_start:
            self._ttfts.append(time.monotonic() - req.t_start)
        done = (
            (self.eos_id is not None and tok == self.eos_id)
            or req.produced >= req.max_tokens
            or len(req.prompt) + req.produced >= self.ecfg.max_model_len
        )
        if self.eos_id is not None and tok == self.eos_id:
            req.queue.put_nowait(None)
        else:
            req.queue.put_nowait(tok)
            if done:
                req.queue.put_nowait(None)
        if done and req.slot >= 0:
            self._release(req)

    def _release(self, req: _Request):
        slot = req.slot
        need = self._blocks_needed(req)
        cache = self._prefix_cache
        for b in self.tables[slot][:need]:
            b = int(b)
            if b == 0:
                continue
            if cache is not None and cache.decref_block(b):
                continue  # cache-owned: stays resident, evictable at 0 refs
            self.free_blocks.append(b)
        self.tables[slot] = 0
        self.active[slot] = False
        self.slot_req[slot] = None
        self._gens[slot] = None
        req.slot = -1
        self._publish_metrics()

    def _sample_first(self, req: _Request, slot: int, logits):
        """Sample the first generated token and seed the slot's decode
        generator — shared by local and prefilled admission. Greedy is the
        argmax, as in JAX; temperature sampling draws from a torch
        generator and cannot reproduce jax.random's stream."""
        with tracing.span("engine.first_token", attrs={"rid": req.rid}):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(req.seed * 1000003 + req.rid)
            if req.temperature > 0:
                probs = torch.softmax(logits / max(req.temperature, 1e-6), -1)
                tok = int(torch.multinomial(probs, 1, generator=gen)[0])
            else:
                tok = int(torch.argmax(logits))
            self._gens[slot] = gen
            return tok

    def _activate_slot(self, req: _Request, slot: int, tok: int, hits: int):
        """Final admission bookkeeping shared by both admission paths, on
        the loop's thread: the slot goes live and the first token out."""
        if hits:
            from ray_tpu_torch.util.metrics import Counter

            Counter("rt_llm_prefix_hits_total",
                    "KV blocks reused from the prompt-prefix cache "
                    "instead of re-prefilled.").inc(hits)
        self.slot_req[slot] = req
        if req.admitted_mid_decode:
            self.mid_decode_admissions += 1
        req.slot = slot
        self.lens[slot] = len(req.prompt)
        self.active[slot] = True
        self.last_tok[slot] = tok
        self.temps[slot] = req.temperature
        self._publish_metrics()
        self._emit(req, tok)

    def _admit_prefilled(self, req: _Request, slot: int, need: int) -> tuple:
        """Admit a request whose prefill ran on ANOTHER worker: scatter the
        transferred KV block contents into this engine's pool and seed the
        first token from the transferred last-position logits — the decode
        side of prefill/decode disaggregation."""
        k_in, v_in, last_logits = req.prefilled
        nb = k_in.shape[1]
        expect = -(-len(req.prompt) // self.bs)
        if nb != expect or nb > need:
            # malformed transfer: failing the REQUEST (not returning None,
            # which _run_loop reads as "wait for resources") keeps the
            # admission queue moving
            raise ValueError(
                f"transferred KV has {nb} blocks; prompt of "
                f"{len(req.prompt)} tokens needs {expect} "
                f"(budget {need})")
        blocks = [self.free_blocks.pop() for _ in range(need)]
        try:
            row = np.zeros((self.max_blocks,), np.int64)
            row[: len(blocks)] = blocks
            self.tables[slot] = row
            phys = self._dev(np.asarray(blocks[:nb], np.int64))
            self.kc[:, phys] = torch.as_tensor(
                k_in, dtype=self.kc.dtype).to(self.device)
            self.vc[:, phys] = torch.as_tensor(
                v_in, dtype=self.vc.dtype).to(self.device)
            tok = self._sample_first(
                req, slot, torch.as_tensor(last_logits).to(self.device))
        except BaseException:
            self.free_blocks.extend(blocks)
            self.tables[slot] = 0
            raise
        return slot, tok, 0

    # -- engine loop ----------------------------------------------------

    async def _ensure_loop(self):
        if self._pending is None:
            self._pending = asyncio.Queue()
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(
                self._run_loop())

    def _run_step(self) -> np.ndarray:
        on = tracing.recording()
        attrs = None
        if on:
            act = self.active
            attrs = {"step": self.steps, "active": int(act.sum()),
                     "cached": int(self.lens[act].sum()),
                     "gathered": self.ecfg.max_num_seqs * self.max_blocks
                     * self.bs}
        with tracing.span("engine.step", attrs=attrs, on=on), \
                torch.no_grad():
            with tracing.span("engine.launch", on=on):
                toks = self._decode(
                    self.params, self.kc, self.vc, self._dev(self.tables),
                    self._dev(self.lens), self._dev(self.active),
                    self._dev(self.last_tok), self._gens, self.temps)
            with tracing.span("engine.sync", on=on):
                return toks.cpu().numpy()

    async def _on_worker(self, fn, args, what: str, on: bool):
        """``fn(*args)`` on the worker thread; the loop waits in an
        ``engine.wait`` span from the submit until it resumes."""
        with tracing.span("engine.wait", attrs={"what": what}, on=on):
            return await asyncio.get_running_loop().run_in_executor(
                self._worker, fn, *args)

    async def _admit_waiting(self, waiting, mid_decode: bool, on: bool):
        """Admit in arrival order while slots + blocks allow — requests
        landing here while slots decode are the "admitted mid-decode"
        continuous-batching case."""
        while waiting:
            req = waiting[0]
            if req.aborted:
                waiting.popleft()  # consumer gone before admission
                continue
            if self._blocks_needed(req) > self.ecfg.num_kv_blocks:
                # can never fit even a drained pool: surface an ERROR,
                # not a silently empty completion
                waiting.popleft()
                req.queue.put_nowait(ValueError(
                    f"request needs {self._blocks_needed(req)} KV "
                    f"blocks but the pool has "
                    f"{self.ecfg.num_kv_blocks}"))
                continue
            req.admitted_mid_decode = mid_decode
            t_try = time.perf_counter_ns()  # the queue span ends here
            try:
                got = await self._on_worker(self._try_admit, (req,),
                                            "admit", on)
            except Exception as e:  # noqa: BLE001 — prefill failed
                # the pool is updated in place and stays valid: only
                # this request fails
                waiting.popleft()
                tracing.end_manual_span(req.queue_span, end_ns=t_try)
                req.queue.put_nowait(e)
                continue
            if got is None:
                break  # head waits for blocks/slots to free
            waiting.popleft()
            tracing.end_manual_span(req.queue_span, end_ns=t_try)
            self._activate_slot(req, *got)

    async def _run_loop(self):
        waiting: "collections.deque[_Request]" = collections.deque()
        while True:
            # one check an iteration: the loop's spans follow it
            on = tracing.recording()
            step = self.steps
            with tracing.span("engine.turn", attrs={"step": step}, on=on):
                mid_decode = bool(self.active.any())
                while not self._pending.empty():
                    waiting.append(self._pending.get_nowait())
                # disconnect sweep: a consumer that walked away (client
                # abort, SSE timeout) releases its slot + KV blocks at this
                # step boundary — BEFORE admission, so the freed blocks
                # admit the waiting head this same tick instead of leaking
                # until OOM
                for r in list(self.slot_req):
                    if r is not None and r.aborted and r.slot >= 0:
                        self._release(r)
                await self._admit_waiting(waiting, mid_decode, on)
                busy = bool(self.active.any())
                if busy:
                    await self._decode_and_emit(step, waiting, on)
            if not busy:
                # idle: block until a request arrives
                with tracing.span("engine.idle", on=on):
                    req = await self._pending.get()
                waiting.append(req)
                continue
            # let admissions and the consumers interleave
            with tracing.span("engine.wait", attrs={"what": "yield"}, on=on):
                await asyncio.sleep(0)

    async def _decode_and_emit(self, step: int, waiting, on: bool):
        """One decode step for every active slot, then its tokens out."""
        try:
            toks = await self._on_worker(self._run_step, (), "step", on)
        except Exception as e:  # noqa: BLE001 — decode step failed
            # the device state is suspect: fail every in-flight and
            # queued request (callers must never hang on a dead loop)
            for req in list(self.slot_req):
                if req is not None:
                    req.queue.put_nowait(e)
                    self._release(req)
            while waiting:
                waiting.popleft().queue.put_nowait(e)
            while not self._pending.empty():
                self._pending.get_nowait().queue.put_nowait(e)
            raise
        self.steps = step + 1
        with tracing.span("engine.emit", on=on,
                          attrs={"step": step}) as sp:
            n = 0
            for slot, req in enumerate(list(self.slot_req)):
                if req is None or not self.active[slot]:
                    continue
                self.lens[slot] += 1
                tok = int(toks[slot])
                self.last_tok[slot] = tok
                self._emit(req, tok)
                n += 1
            tracing.set_attrs(sp, tokens=n)

    # -- public API -----------------------------------------------------

    async def generate_stream(self, prompt_ids: List[int], *,
                              max_tokens: int = 32,
                              temperature: float = 0.0, seed: int = 0,
                              prefilled: Optional[tuple] = None):
        """Async generator of token ids. Engine-side failures raise into the
        consumer (queue items: int token | None end | Exception).
        `prefilled=(k, v, last_logits)` admits with KV transferred from a
        remote prefill worker instead of running prefill here."""
        if len(prompt_ids) + 1 > self.ecfg.max_model_len:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens exceeds "
                f"max_model_len={self.ecfg.max_model_len}")
        await self._ensure_loop()
        self._rid += 1
        req = _Request(self._rid, list(prompt_ids), int(max_tokens),
                       float(temperature), int(seed),
                       queue=asyncio.Queue(), prefilled=prefilled,
                       t_start=time.monotonic())
        if tracing.recording():
            req.trace_parent = tracing.current_span()
            req.queue_span = tracing.start_manual_span(
                "engine.queue", parent=req.trace_parent,
                attrs={"rid": req.rid}, on=True)
        self._pending.put_nowait(req)
        try:
            while True:
                tok = await req.queue.get()
                if tok is None:
                    return
                if isinstance(tok, Exception):
                    raise tok
                yield tok
        finally:
            # consumer gone — clean finish, exception, OR an abandoned
            # generator (client disconnect). The engine loop releases the
            # slot + blocks at its next step boundary.
            req.aborted = True

    def _publish_metrics(self):
        """Engine telemetry on the metrics plane, the JAX engine's two
        gauges (constructors are idempotent — re-construction returns the
        registered instrument)."""
        from ray_tpu_torch.util.metrics import Gauge

        e = self.ecfg
        evictable = (self._prefix_cache.evictable_blocks()
                     if self._prefix_cache is not None else 0)
        in_use = e.num_kv_blocks - len(self.free_blocks) - evictable
        Gauge("rt_llm_kv_blocks_in_use",
              "KV pool blocks held by in-flight sequences (zero-ref "
              "prefix-cache blocks count as free capacity).").set(in_use)
        Gauge("rt_llm_batch_occupancy",
              "Fraction of decode batch slots active.").set(
            float(self.active.sum()) / max(1, e.max_num_seqs))

    def stats(self) -> Dict[str, Any]:
        cache = self._prefix_cache
        evictable = cache.evictable_blocks() if cache is not None else 0
        ttfts = sorted(self._ttfts)
        out = {
            "steps": self.steps,
            "tokens_out": self.tokens_out,
            # free = immediately allocatable + reclaimable-by-eviction:
            # zero-ref cached blocks are capacity
            "free_blocks": len(self.free_blocks) + evictable,
            "blocks_in_use": (self.ecfg.num_kv_blocks
                              - len(self.free_blocks) - evictable),
            "active_slots": int(self.active.sum()),
            "mid_decode_admissions": self.mid_decode_admissions,
            "prefix_cache": cache.stats() if cache is not None else None,
        }
        if ttfts:
            out["ttft_p50_s"] = ttfts[len(ttfts) // 2]
        return out
