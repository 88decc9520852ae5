"""LLM serving patterns: prefill/decode disaggregation, KV-aware routing,
data-parallel engine gangs.

Reference surface:
- python/ray/llm/_internal/serve/serving_patterns/prefill_decode/
  builder.py:236-238 — separate prefill and decode deployments with KV
  transfer between them;
- python/ray/llm/_internal/serve/routing_policies/kv_aware/ — route
  requests sharing a prompt prefix to the replica most likely to hold its
  KV state;
- python/ray/llm/_internal/serve/serving_patterns/data_parallel/
  dp_server.py:247-276 — a ranked gang of engine replicas behind one
  ingress.

The port's counterpart of ``ray_tpu/llm/serving_patterns.py``: the
routing, ingress and gang classes are copies; ``PrefillWorker`` computes
the prompt's KV on its device (CUDA unless the caller passes
``device="cpu"``), its full-prompt attention through the K1 kernel
(``_engine._make_prefill``), and ships the block CONTENTS as CPU tensors
(host-staged through the object plane, protocol-5 buffers) to a decode
engine, which copies them into its paged pool on its own device and
admits the request mid-decode — prefill compute and decode batching scale
independently. The PD ingress additionally memoizes whole-prompt
prefills (LRU), so repeated prompts skip prefill entirely — the
measurable form of KV reuse the router's prefix affinity is aiming at.
"""

from __future__ import annotations

import collections
import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.llm import EOS, ByteTokenizer, LLMConfig
from ray_tpu_torch.llm._engine import EngineConfig


@ray_tpu_torch.remote
class PrefillWorker:
    """Computes a prompt's KV cache into a minimal block pool and returns
    the block contents + last-position logits (the prefill side of P/D
    disaggregation). The model and the pool live on ``device`` (default
    CUDA)."""

    def __init__(self, config: LLMConfig, engine_config: Optional[dict] = None,
                 device=None):
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.llm._engine import _make_prefill

        self.config = config
        self.ecfg = EngineConfig(**(engine_config or {}))
        self.device = resolve_device(device)
        self.cfg, self.params = config.build_model(self.device)
        self._prefill = _make_prefill(self.cfg, self.ecfg)
        self._served = 0

    def prefill(self, prompt_ids: List[int]) -> Dict[str, Any]:
        import torch

        p = list(prompt_ids) or [0]
        plen = len(p)
        bs = self.ecfg.kv_block_size
        nb = -(-plen // bs)
        S = max(8, 1 << (plen - 1).bit_length())
        # pool sized to exactly this prompt (+ trash block 0)
        hd = self.cfg.head_dim
        kc = torch.zeros((self.cfg.n_layers, nb + 1, bs, self.cfg.n_kv_heads,
                          hd), dtype=self.cfg.dtype, device=self.device)
        vc = torch.zeros_like(kc)
        table = torch.zeros((max(nb, 1),), dtype=torch.long)
        table[:nb] = torch.arange(1, nb + 1)
        prompt = torch.zeros((S,), dtype=torch.long)
        prompt[:plen] = torch.tensor(p)
        with torch.no_grad():
            logits = self._prefill(
                S, self.params, kc, vc, table.to(self.device),
                prompt.to(self.device), plen)
        self._served += 1
        return {
            "k": kc[:, 1:nb + 1].cpu(),
            "v": vc[:, 1:nb + 1].cpu(),
            "last_logits": logits.cpu(),
        }

    def stats(self) -> Dict[str, Any]:
        return {"prefills": self._served}


def _prefix_key(prompt_ids: List[int], block: int) -> str:
    """Block-aligned prefix fingerprint for KV-aware routing."""
    head = prompt_ids[: max(block, 1)]
    return hashlib.blake2b(np.asarray(head, np.int32).tobytes(),
                           digest_size=8).hexdigest()


class KvAwareRouter:
    """Prefix-affinity replica choice (reference: routing_policies/
    kv_aware/): requests sharing a block-aligned prompt prefix route to the
    same decode engine, maximizing pool-local KV/prefill-cache reuse;
    unseen prefixes go to the least-loaded engine."""

    def __init__(self, n: int, block: int):
        self.n = n
        self.block = block
        self._affinity: "collections.OrderedDict[str, int]" = (
            collections.OrderedDict())
        self.load = [0] * n

    def pick(self, prompt_ids: List[int]) -> Tuple[int, str]:
        key = _prefix_key(prompt_ids, self.block)
        i = self._affinity.get(key)
        if i is None:
            i = min(range(self.n), key=lambda j: self.load[j])
            self._affinity[key] = i
            while len(self._affinity) > 4096:
                self._affinity.popitem(last=False)
        else:
            self._affinity.move_to_end(key)
        self.load[i] += 1
        return i, key

    def done(self, i: int):
        self.load[i] = max(0, self.load[i] - 1)


class PrefillDecodeIngress:
    """Serve deployment: routes each completion through the prefill pool
    then a KV-aware-chosen decode engine, streaming tokens back
    (reference: prefill_decode/builder.py)."""

    def __init__(self, config: LLMConfig, *, num_prefill: int = 1,
                 num_decode: int = 1, engine_config: Optional[dict] = None,
                 prefill_cache_size: int = 32, device=None):
        from ray_tpu_torch.llm import LLMEngine

        self.config = config
        self.tokenizer = ByteTokenizer()
        ecfg = dict(engine_config or {})
        self.block = int(ecfg.get("kv_block_size", 16))
        self.prefill_workers = [
            PrefillWorker.remote(config, ecfg, device=device)
            for _ in range(num_prefill)]
        self.decoders = [
            LLMEngine.remote(config, EngineConfig(**ecfg), device=device)
            for _ in range(num_decode)]
        self.router = KvAwareRouter(num_decode, self.block)
        self._pf_rr = 0
        # whole-prompt prefill memo: repeated prompts skip prefill entirely
        self._pf_cache: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        self._pf_cache_size = prefill_cache_size
        self.prefill_cache_hits = 0

    async def __call__(self, payload: Dict[str, Any]):
        prompt = payload.get("prompt", "")
        if not isinstance(prompt, str):
            prompt = prompt[0] if prompt else ""
        ids = self.tokenizer.encode(prompt)
        max_new = int(payload.get("max_tokens", self.config.max_new_tokens))
        temperature = float(
            payload.get("temperature", self.config.temperature))
        full_key = hashlib.blake2b(
            np.asarray(ids, np.int32).tobytes(), digest_size=8).hexdigest()
        # the cache holds the prefill task's REF, never the blocks: the KV
        # moves prefill-worker -> decode-engine over the object plane
        # (zero-copy shm when co-located, chunked pull across nodes)
        # without ever materializing in this ingress process — the r4
        # review's "full KV through the host plane per request" hop is gone
        kv_ref = self._pf_cache.get(full_key)
        if kv_ref is not None:
            self._pf_cache.move_to_end(full_key)
            self.prefill_cache_hits += 1
        else:
            pf = self.prefill_workers[
                self._pf_rr % len(self.prefill_workers)]
            self._pf_rr += 1
            kv_ref = pf.prefill.remote(ids)
            self._pf_cache[full_key] = kv_ref
            while len(self._pf_cache) > self._pf_cache_size:
                self._pf_cache.popitem(last=False)
        i, _ = self.router.pick(ids)
        try:
            toks: List[int] = []
            gen = self.decoders[i].completions_stream_prefilled.options(
                num_returns="streaming").remote(
                ids, kv_ref,
                max_tokens=max_new, temperature=temperature,
                seed=self.config.seed)
            async for ref in gen:
                toks.append(await ref)
        except Exception:
            # a failed prefill ref must not poison the cache: retries of
            # the SAME prompt would keep hitting the dead ref until 32
            # other prompts evicted it
            self._pf_cache.pop(full_key, None)
            raise
        finally:
            self.router.done(i)
        return {
            "object": "text_completion",
            "model": self.config.model_id,
            "choices": [{"index": 0, "text": self.tokenizer.decode(toks),
                         "finish_reason": "stop" if len(toks) < max_new
                         else "length"}],
            "usage": {"completion_tokens": len(toks),
                      "prefill_cache_hits": self.prefill_cache_hits,
                      "decode_replica": i},
        }

    def stats(self) -> Dict[str, Any]:
        return {"prefill_cache_hits": self.prefill_cache_hits,
                "router_load": list(self.router.load)}


def build_pd_app(config: LLMConfig, *, num_prefill: int = 1,
                 num_decode: int = 1, deployment_name: str = "pd",
                 engine_config: Optional[dict] = None, device=None):
    """Deploy the prefill/decode-disaggregated completions endpoint;
    returns the serve handle (reference: prefill_decode/builder.py). The
    prefill workers' and decode engines' models live on ``device``
    (default CUDA)."""
    from ray_tpu_torch import serve

    deployment = serve.Deployment(
        PrefillDecodeIngress, deployment_name, num_replicas=1,
        init_args=(config,),
        init_kwargs={"num_prefill": num_prefill, "num_decode": num_decode,
                     "engine_config": engine_config, "device": device},
    )
    return serve.run(deployment)


class DPEngineGroup:
    """A RANKED data-parallel gang of engine actors behind one ingress
    (reference: serving_patterns/data_parallel/dp_server.py:247-276 +
    GangContext): every engine knows its rank/world, requests spread by
    least-in-flight, and the group exposes aggregate stats."""

    def __init__(self, config: LLMConfig, dp_size: int,
                 engine_config: Optional[dict] = None, device=None):
        from ray_tpu_torch.llm import LLMEngine

        self.config = config
        self.tokenizer = ByteTokenizer()
        ecfg = EngineConfig(**(engine_config or {}))
        self.engines = [
            LLMEngine.options(runtime_env={"env_vars": {
                "RT_DP_RANK": str(r), "RT_DP_SIZE": str(dp_size)}},
            ).remote(config, ecfg, device=device)
            for r in range(dp_size)
        ]
        self.load = [0] * dp_size

    async def __call__(self, payload: Dict[str, Any]):
        prompt = payload.get("prompt", "")
        if not isinstance(prompt, str):
            prompt = prompt[0] if prompt else ""
        max_new = int(payload.get("max_tokens", self.config.max_new_tokens))
        i = min(range(len(self.engines)), key=lambda j: self.load[j])
        self.load[i] += 1
        try:
            toks: List[int] = []
            gen = self.engines[i].completions_stream.options(
                num_returns="streaming").remote(
                prompt, max_tokens=max_new,
                temperature=float(payload.get(
                    "temperature", self.config.temperature)))
            async for ref in gen:
                toks.append(await ref)
        finally:
            self.load[i] = max(0, self.load[i] - 1)
        text = self.tokenizer.decode(toks)
        return {
            "object": "text_completion",
            "model": self.config.model_id,
            "choices": [{"index": 0, "text": text,
                         "finish_reason": "stop" if len(toks) < max_new
                         else "length"}],
            "usage": {"completion_tokens": len(toks), "dp_rank": i},
        }


def build_dp_app(config: LLMConfig, *, dp_size: int = 2,
                 deployment_name: str = "dp",
                 engine_config: Optional[dict] = None, device=None):
    """Deploy a data-parallel engine gang behind one route (reference:
    data_parallel/dp_server.py). Each engine's model lives on ``device``
    (default CUDA)."""
    from ray_tpu_torch import serve

    deployment = serve.Deployment(
        DPEngineGroup, deployment_name, num_replicas=1,
        init_args=(config, dp_size),
        init_kwargs={"engine_config": engine_config, "device": device},
    )
    return serve.run(deployment)


__all__ = [
    "DPEngineGroup",
    "KvAwareRouter",
    "PrefillDecodeIngress",
    "PrefillWorker",
    "build_dp_app",
    "build_pd_app",
]
