"""The port's LLM apps on its serve library, held to the JAX package's
in-process server and engine: ``build_openai_app`` over HTTP (batched and
SSE-streamed), ``build_pd_app`` (a prefill worker's KV handed to a decode
engine), ``build_dp_app`` (a gang of two engines) and the ``LLMEngine``
actor, all on the CPU (``device="cpu"``), on a tiny Llama whose weights
are JAX's ``init_params``, pickled and read by both packages'
``checkpoint_path``. Greedy decoding: every text and token list must equal
JAX's. Then the trace of one served request (``list_spans``), and
``batch_completions`` over a ``data`` Dataset.

The port's side runs in a spawned child (``_port_proc``): its driver
imports torch. The child starts the port's cluster; HTTP requests go from
the pytest worker to the ingress it bound on port 0.
"""

import asyncio
import json
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _port_proc import spawn
from ray_tpu.llm import EOS, ByteTokenizer
from ray_tpu.llm import LLMConfig as JLLMConfig
from ray_tpu.llm import LLMServer as JLLMServer
from ray_tpu.llm._engine import EngineConfig as JEngineConfig
from ray_tpu.llm._engine import PagedEngine as JPagedEngine
from ray_tpu.models import llama as jl

MAX_NEW = 6
ECFG = dict(max_num_seqs=4, kv_block_size=4, num_kv_blocks=64,
            max_model_len=64)
PROMPTS = ["hello", "a b", "the paged cache", "xyz"]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    params = jl.init_params(jl.LlamaConfig.tiny(dtype=jnp.float32),
                            jax.random.PRNGKey(1))
    path = str(tmp_path_factory.mktemp("llm") / "params.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return path


@pytest.fixture(scope="module")
def port():
    with spawn(timeout=300) as call:
        call("apps_start", 10)
        yield call
        call("apps_stop")


@pytest.fixture(scope="module")
def jserver(ckpt):
    return JLLMServer(JLLMConfig(max_new_tokens=MAX_NEW, checkpoint_path=ckpt,
                                 model_overrides=dict(dtype=jnp.float32)))


@pytest.fixture(scope="module")
def jengine_tokens(jserver):
    """JAX's paged engine (what ``LLMEngine`` wraps) on the same weights:
    each prompt's greedy tokens, the prompts decoded at once."""
    eng = JPagedEngine(jserver.cfg, jserver.params, JEngineConfig(**ECFG),
                       eos_id=EOS)
    tok = ByteTokenizer()

    async def one(p):
        return [int(t) async for t in eng.generate_stream(
            tok.encode(p), max_tokens=MAX_NEW, temperature=0.0)]

    async def main():
        return await asyncio.gather(*[one(p) for p in PROMPTS])

    return dict(zip(PROMPTS, asyncio.run(main())))


@pytest.fixture(scope="module")
def base(port, ckpt):
    return port("openai_app", ckpt, MAX_NEW)


def _post(url, payload):
    import httpx

    deadline = time.time() + 60
    while True:
        try:
            return httpx.post(url, json=payload, timeout=180)
        except httpx.TransportError:
            if time.time() > deadline:
                raise
            time.sleep(0.3)


def _sse(url, payload):
    import httpx

    events = []
    with httpx.stream("POST", url, json=payload, timeout=180) as r:
        assert r.status_code == 200
        assert r.headers["content-type"].startswith("text/event-stream")
        for line in r.iter_lines():
            if line.startswith("data: "):
                events.append(line[len("data: "):])
    return events


def test_openai_app_over_http_matches_jax(base, jserver):
    batch = {"prompt": PROMPTS, "max_tokens": MAX_NEW}
    r = _post(f"{base}/v1", batch)
    assert r.status_code == 200, r.text
    got = r.json()["result"]
    want = jserver(batch)
    assert got["object"] == "text_completion"
    assert [c["text"] for c in got["choices"]] == [
        c["text"] for c in want["choices"]]
    assert [c["finish_reason"] for c in got["choices"]] == [
        c["finish_reason"] for c in want["choices"]]
    assert got["usage"]["completion_tokens"] == \
        want["usage"]["completion_tokens"]
    assert any(c["text"] for c in got["choices"])  # bytes were decoded


def test_openai_app_sse_matches_jax(base, jserver):
    payload = {"prompt": "hello", "max_tokens": MAX_NEW, "stream": True}
    events = _sse(f"{base}/v1", payload)
    assert events and events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert all(c["object"] == "text_completion.chunk" for c in chunks)
    want = list(jserver(payload))
    assert "".join(c["choices"][0]["text"] for c in chunks) == "".join(
        c["choices"][0]["text"] for c in want)
    assert chunks[-1]["choices"][0].get("finish_reason") == \
        want[-1]["choices"][0].get("finish_reason")
    # the streamed text is the batched one
    batched = _post(f"{base}/v1", {"prompt": "hello",
                                   "max_tokens": MAX_NEW}).json()["result"]
    assert "".join(c["choices"][0]["text"] for c in chunks) == \
        batched["choices"][0]["text"]


def test_served_request_stitches_one_trace(port, base):
    """``list_spans`` (through ``util/state``) shows one SSE request's
    ingress, routing, replica admission and stream spans in one trace."""
    n = len(_sse(f"{base}/v1", {"prompt": "trace me", "max_tokens": 3,
                                "stream": True})) - 1
    wanted = ("ingress:v1", "handle:pick:v1", "replica:admit:v1",
              "replica:stream:v1")
    deadline = time.time() + 30
    done, by_trace = [], {}
    while time.time() < deadline:
        by_trace = {}
        for s in port("spans"):
            by_trace.setdefault(s["trace_id"], set()).add(s["name"])
        done = [t for t, names in by_trace.items()
                if all(any(x.startswith(p) for x in names) for p in wanted)
                and any(x.startswith("replica:stream:v1")
                        and f"chunks={n}" in x for x in names)]
        if done:
            break
        time.sleep(0.5)
    assert done, {t: sorted(x) for t, x in by_trace.items() if len(x) > 2}


def test_pd_app_matches_jax_engine(port, ckpt, jengine_tokens):
    tok = ByteTokenizer()
    prompts = PROMPTS + [PROMPTS[0]]  # the last is a prefill-cache hit
    outs, stats, reaped = port("pd_app", ckpt, MAX_NEW, ECFG, prompts)
    for p, o in zip(prompts, outs):
        assert o["choices"][0]["text"] == tok.decode(jengine_tokens[p]), p
        assert o["usage"]["completion_tokens"] == len(jengine_tokens[p])
    assert [o["usage"]["prefill_cache_hits"] for o in outs] == [0, 0, 0, 0, 1]
    # KV-aware routing: the repeated prompt goes to the same decode engine
    assert outs[-1]["usage"]["decode_replica"] == \
        outs[0]["usage"]["decode_replica"]
    assert stats["prefill_cache_hits"] == 1
    # as in the JAX package, serve.delete ends the replica, and the actors
    # its ingress made live on until they are killed
    assert reaped == ([(False, "ALIVE"), (True, "DEAD")], ["DEAD"]), reaped


def test_dp_app_matches_jax_engine(port, ckpt, jengine_tokens):
    tok = ByteTokenizer()
    outs, reaped = port("dp_app", ckpt, MAX_NEW, ECFG, PROMPTS)
    for p, o in zip(PROMPTS, outs):
        assert o["choices"][0]["text"] == tok.decode(jengine_tokens[p]), p
        assert o["usage"]["completion_tokens"] == len(jengine_tokens[p])
    assert {o["usage"]["dp_rank"] for o in outs} == {0, 1}
    assert reaped == ([(False, "ALIVE"), (True, "DEAD")], ["DEAD"]), reaped


def test_llm_engine_completions_stream_matches_jax(port, ckpt,
                                                   jengine_tokens):
    toks, stats = port("engine_streams", ckpt, MAX_NEW, ECFG, PROMPTS)
    assert toks == [jengine_tokens[p] for p in PROMPTS]
    assert stats["tokens_out"] == sum(len(t) for t in toks)
    assert stats["active_slots"] == 0


def test_batch_completions_matches_jax(port, ckpt, jserver):
    """JAX's ``test_batch_completions_over_data`` program (6 prompts,
    ``from_items(parallelism=2)``, 3 new tokens) through the port's
    ``batch_completions`` on its cluster: each row's completion is the one
    JAX's ``LLMServer`` gives the block that row is in, as JAX's map task
    computes it, on the same weights."""
    prompts = [f"p{i}" for i in range(6)]
    rows = port("batch_completions", ckpt, 3, prompts, 2)
    want = []
    for block in (prompts[:3], prompts[3:]):
        res = jserver({"prompt": block, "max_tokens": 3})
        want += [c["text"] for c in res["choices"]]
    assert rows == list(zip(prompts, want))
    assert any(want), "every JAX completion is empty: the test shows nothing"


def test_public_names_match_the_jax_package(port):
    import ray_tpu.llm as jllm
    from ray_tpu.llm import serving_patterns as jsp

    names, patterns = port("llm_names")
    assert patterns == jsp.__all__
    assert set(jllm.__all__) <= set(names)
    assert {"LLMEngine", "engine_actor_class", "build_openai_app",
            "batch_completions"} <= set(names)


def test_app_models_default_to_cuda(port):
    """Without ``device="cpu"`` an engine and a prefill worker build on
    CUDA, and raise where there is none: no app falls back to the CPU."""
    got = port("apps_cuda_default_errors")
    if got["cuda_available"]:
        pytest.skip("this machine has CUDA: the default device is valid")
    for name in ("LLMEngine", "PrefillWorker"):
        assert got[name] is not None and "CUDA" in got[name], name
