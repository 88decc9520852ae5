"""ray_tpu_torch.llm — LLM serving on the PyTorch port.

Counterpart of ``ray_tpu/llm``: the byte tokenizer, ``LLMConfig`` and the
``LLMServer`` replica (an OpenAI-completions-shaped dict in and out), over
the port's Llama model with a KV-cache decode loop (``_generate.py``) and
the continuous-batching paged engine (``_engine.py``), and the cluster
side: ``LLMEngine`` (an async actor around ``PagedEngine``) and
``build_openai_app`` (``LLMServer`` as a serve deployment). Every model
lives on ``device``, CUDA unless the caller passes ``device="cpu"``: the
one difference in signature from the JAX package's entries.
``batch_completions`` maps ``LLMServer`` over a ``data`` Dataset.
"""

from __future__ import annotations

import codecs
import collections
import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.llm._generate import generate, generate_stream, init_cache

BOS, EOS = 256, 257


class ByteTokenizer:
    """Dependency-free byte-level tokenizer (ids 0-255 = bytes, 256=BOS,
    257=EOS)."""

    vocab_size = 258

    def encode(self, text: str) -> List[int]:
        return [BOS] + list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")


@dataclass
class LLMConfig:
    """Reference: llm LLMConfig (model_loading_config + engine_kwargs)."""

    model_id: str = "llama-tiny-random"
    model: str = "tiny"            # LlamaConfig preset name
    model_overrides: Dict[str, Any] = field(default_factory=dict)
    # pickled nested-numpy params (jax.tree.map(np.asarray, params))
    checkpoint_path: Optional[str] = None
    max_new_tokens: int = 32
    temperature: float = 0.0
    num_replicas: int = 1
    seed: int = 0

    def build_model(self, device=None):
        """(LlamaConfig, params) on ``device`` (default CUDA)."""
        from ray_tpu_torch.models.llama import LlamaConfig, init_params

        preset = getattr(LlamaConfig, self.model)
        cfg = preset(**self.model_overrides)
        if cfg.vocab_size < ByteTokenizer.vocab_size:
            raise ValueError("model vocab must cover the byte tokenizer's "
                             "258 ids")
        if self.checkpoint_path:
            from ray_tpu_torch.models.convert import params_from_jax

            with open(self.checkpoint_path, "rb") as f:
                params = params_from_jax(pickle.load(f), device)
        else:
            params = init_params(cfg, self.seed, device=device)
        return cfg, params


class LLMServer:
    """One serving replica; __call__ speaks an OpenAI-completions-shaped
    dict. The model lives on ``device`` (default CUDA)."""

    def __init__(self, config: LLMConfig, device=None):
        self.config = config
        self.tokenizer = ByteTokenizer()
        self.cfg, self.params = config.build_model(device)
        # rolling latency/throughput signals for an autoscaler
        self._tps = collections.deque(maxlen=32)
        self._ttfts = collections.deque(maxlen=64)

    def autoscaling_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self._ttfts:
            s = sorted(self._ttfts)
            out["ttft_p50_s"] = s[len(s) // 2]
        if self._tps:
            out["tokens_per_s"] = sum(self._tps) / len(self._tps)
        return out

    def __call__(self, payload: Dict[str, Any]) -> Any:
        if isinstance(payload, dict) and payload.get("stream"):
            # OpenAI-style streaming: a generator of completion chunks
            return self._stream_chunks(payload)
        prompts = payload.get("prompt", "")
        single = isinstance(prompts, str)
        if single:
            prompts = [prompts]
        max_new = int(payload.get("max_tokens", self.config.max_new_tokens))
        temperature = float(
            payload.get("temperature", self.config.temperature))
        t0 = time.monotonic()
        token_prompts = [self.tokenizer.encode(p) for p in prompts]
        outs = generate(
            self.cfg, self.params, token_prompts,
            max_new_tokens=max_new, temperature=temperature,
            seed=self.config.seed, eos_id=EOS,
        )
        elapsed = time.monotonic() - t0
        total = sum(len(t) for t in outs)
        if total:
            self._tps.append(total / max(elapsed, 1e-9))
        choices = [
            {"index": i, "text": self.tokenizer.decode(toks),
             "finish_reason": "stop" if len(toks) < max_new else "length"}
            for i, toks in enumerate(outs)
        ]
        return {
            "id": f"cmpl-{int(t0 * 1000)}",
            "object": "text_completion",
            "model": self.config.model_id,
            "choices": choices,
            "usage": {
                "completion_tokens": total,
                "tokens_per_s": round(total / max(elapsed, 1e-9), 2),
            },
        }

    def _stream_chunks(self, payload: Dict[str, Any]):
        prompt = payload.get("prompt", "")
        if not isinstance(prompt, str):
            prompt = prompt[0] if prompt else ""
        max_new = int(payload.get("max_tokens", self.config.max_new_tokens))
        temperature = float(
            payload.get("temperature", self.config.temperature))
        cid = f"cmpl-{int(time.monotonic() * 1000)}"
        t0 = time.monotonic()
        n = 0
        # byte-level tokens: decode incrementally so multi-byte UTF-8
        # characters flush only at valid boundaries
        dec = codecs.getincrementaldecoder("utf-8")(errors="replace")
        for tok in generate_stream(
                self.cfg, self.params, self.tokenizer.encode(prompt),
                max_new_tokens=max_new, temperature=temperature,
                seed=self.config.seed, eos_id=EOS):
            n += 1
            if n == 1:
                self._ttfts.append(time.monotonic() - t0)
            text = dec.decode(bytes([tok])) if tok < 256 else ""
            if not text:
                continue  # mid-character: fold into the next chunk
            yield {
                "id": cid,
                "object": "text_completion.chunk",
                "model": self.config.model_id,
                "choices": [{"index": 0, "text": text}],
            }
        tail = dec.decode(b"", final=True)
        if tail:
            yield {
                "id": cid,
                "object": "text_completion.chunk",
                "model": self.config.model_id,
                "choices": [{"index": 0, "text": tail}],
            }
        yield {
            "id": cid,
            "object": "text_completion.chunk",
            "model": self.config.model_id,
            "choices": [{"index": 0, "text": "",
                         "finish_reason": "stop" if n < max_new
                         else "length"}],
        }


import ray_tpu_torch as _rt


@_rt.remote
class LLMEngine:
    """Async actor wrapping the continuous-batching paged-KV engine
    (reference: the vLLM engine actor inside LLMServer —
    vllm_engine.py:283). Many callers stream completions concurrently;
    requests landing mid-decode join the running batch at the next step
    boundary. The model and the KV pool live on ``device`` (default
    CUDA)."""

    def __init__(self, config: LLMConfig, engine_config=None, device=None):
        from ray_tpu_torch.llm._engine import EngineConfig, PagedEngine

        self.config = config
        self.tokenizer = ByteTokenizer()
        cfg, params = config.build_model(device)
        self.engine = PagedEngine(
            cfg, params, engine_config or EngineConfig(), eos_id=EOS,
            device=device)
        self._t0 = None

    @_rt.method(num_returns="streaming")
    async def completions_stream(self, prompt: str,
                                 max_tokens: Optional[int] = None,
                                 temperature: Optional[float] = None,
                                 seed: Optional[int] = None):
        """Stream token ids for one completion (text via the byte
        tokenizer is a pure client-side decode). Per-call overrides fall
        back to the LLMConfig, like the non-streaming LLMServer path."""
        if self._t0 is None:
            self._t0 = time.monotonic()
        ids = self.tokenizer.encode(prompt)
        gen = self.engine.generate_stream(
            ids,
            max_tokens=(self.config.max_new_tokens
                        if max_tokens is None else max_tokens),
            temperature=(self.config.temperature
                         if temperature is None else temperature),
            seed=self.config.seed if seed is None else seed,
        )
        async for tok in gen:
            yield int(tok)

    @_rt.method(num_returns="streaming")
    async def completions_stream_prefilled(self, prompt_ids, kv,
                                           max_tokens: Optional[int] = None,
                                           temperature: Optional[float] = None,
                                           seed: Optional[int] = None):
        """Decode side of prefill/decode disaggregation: admit with KV
        block contents transferred from a remote PrefillWorker (reference:
        serving_patterns/prefill_decode + vLLM KV transfer connectors).

        `kv` may be the PrefillWorker's result dict (the ingress passes
        the prefill task's REF, so the blocks move owner -> this engine
        over the object plane directly, without materializing in the
        ingress process) or a bare (k, v, last_logits) tuple: CPU tensors
        or numpy arrays, copied into this engine's pool on its device."""
        if isinstance(kv, dict):
            kv = (kv["k"], kv["v"], kv["last_logits"])
        if self._t0 is None:
            self._t0 = time.monotonic()
        gen = self.engine.generate_stream(
            list(prompt_ids),
            max_tokens=(self.config.max_new_tokens
                        if max_tokens is None else max_tokens),
            temperature=(self.config.temperature
                         if temperature is None else temperature),
            seed=self.config.seed if seed is None else seed,
            prefilled=tuple(kv),
        )
        async for tok in gen:
            yield int(tok)

    async def stats(self) -> Dict[str, Any]:
        # a coroutine method: it makes this an async actor, so concurrent
        # streams interleave (async generators alone do not)
        s = self.engine.stats()
        elapsed = max(time.monotonic() - (self._t0 or time.monotonic()),
                      1e-9)
        s["tokens_per_s"] = round(s["tokens_out"] / elapsed, 2)
        return s

    async def autoscaling_stats(self) -> Dict[str, Any]:
        s = await self.stats()
        return {k: s[k] for k in ("ttft_p50_s", "tokens_per_s") if k in s}


def engine_actor_class():
    """Back-compat accessor; the class is a plain module attribute now."""
    return LLMEngine


def build_openai_app(config: LLMConfig, *, deployment_name: str = "v1",
                     device=None):
    """Deploy the completions endpoint; returns the serve handle
    (reference: build_openai_app core/ingress/builder.py:213 — the HTTP
    route is POST /<deployment_name>, our proxy's path convention). Each
    replica's model lives on ``device`` (default CUDA)."""
    from ray_tpu_torch import serve

    deployment = serve.Deployment(
        LLMServer, deployment_name,
        num_replicas=config.num_replicas,
        init_args=(config,),
        init_kwargs={"device": device},
    )
    return serve.run(deployment)


def batch_completions(config: LLMConfig, ds, *, prompt_column: str = "prompt",
                      output_column: str = "completion",
                      batch_size: int = 8, device=None):
    """Batch inference over a ray_tpu_torch.data Dataset (reference: llm
    batch processor vllm_engine_stage.py). One model instance per map
    task's process, on ``device`` (default CUDA)."""

    def infer_batch(block):
        server = _server_singleton(config, device)
        prompts = [str(p) for p in block[prompt_column].tolist()]
        result = server({"prompt": prompts})
        import numpy as np

        out = dict(block)
        out[output_column] = np.array(
            [c["text"] for c in result["choices"]], dtype=object)
        return out

    return ds.map_batches(infer_batch)


_SINGLETON: Dict[tuple, LLMServer] = {}


def _server_singleton(config: LLMConfig, device=None) -> LLMServer:
    # keyed on everything that changes the loaded model — model_id alone
    # would silently serve the wrong weights when two configs share it —
    # and on the device, so a CPU server and a CUDA one never share a slot
    key = (config.model_id, config.model, config.checkpoint_path,
           config.seed, tuple(sorted(config.model_overrides.items())),
           str(device))
    if key not in _SINGLETON:
        _SINGLETON[key] = LLMServer(config, device=device)
    return _SINGLETON[key]


__all__ = [
    "BOS",
    "EOS",
    "ByteTokenizer",
    "LLMConfig",
    "LLMEngine",
    "LLMServer",
    "batch_completions",
    "build_openai_app",
    "engine_actor_class",
    "generate",
    "generate_stream",
    "init_cache",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu("llm")
del _rlu
