"""ray_tpu_torch.llm — LLM serving on the PyTorch port.

Counterpart of ``ray_tpu/llm``: the byte tokenizer, ``LLMConfig`` and the
``LLMServer`` replica (an OpenAI-completions-shaped dict in and out), over
the port's Llama model with a KV-cache decode loop (``_generate.py``) and
the continuous-batching paged engine (``_engine.py``). The actor and
serve-deployment wrappers (``LLMEngine``, ``build_openai_app``,
``batch_completions``) need the runtime, which a later slice ports.
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


__all__ = [
    "BOS",
    "EOS",
    "ByteTokenizer",
    "LLMConfig",
    "LLMServer",
    "generate",
    "generate_stream",
    "init_cache",
]
