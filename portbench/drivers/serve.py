"""Serving driver: ``PagedEngine.generate_stream`` under a closed loop of
clients, checked against the plain reference after the window.

Set-up: the weights drawn on the card from the seed (bfloat16), the engine
with the cell's sizes (its KV pool as a deployment sizes it), one warm-up
request per prefill shape that the mix's prompts use, then the clients'
first requests, all admitted before the window opens. In the window each
client sends its next request when the last one ends. After it: the
clients stop, the engine's loop and worker end, the peak is read, the pool
is freed, and a sample of the finished requests (the longest among them)
is run through the reference: the widest gap by which a served token's
logit lies below the reference's best is the number compared. The KV
blocks that the engine holds (live or cached) are sampled through the
window; their peak goes to the run's extra readings, beside the pool.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import os
import sys
import time
from typing import Dict, List

import torch

import port
import traffic as T
import weights as W
from reference.llama import Reference

PREFILL_SPAN = "portbench.prefill."
DECODE_SPAN = "portbench.decode."
LEAD_S = 0.3   # from the profiler's start to the traced stretch's
HELD_EVERY_S = 0.25


def _bucketed(prompts: List[List[int]]) -> List[List[int]]:
    """One prompt for each padded prefill length the engine will use (its
    power-of-two buckets): the longest prompt of each."""
    best: Dict[int, List[int]] = {}
    for p in prompts:
        b = max(8, 1 << (len(p) - 1).bit_length())
        if len(p) > len(best.get(b, [])):
            best[b] = p
    return [best[b] for b in sorted(best)]


class _Probe:
    """The traced run's wrappers around the engine's two model steps: a
    span each (the prefill's carries its padded length) and the slot
    counts read from the engine's host state at each decode step (the
    decode span's name carries its active slots and their cached tokens)."""

    def __init__(self, eng):
        self.decodes: List[tuple] = []    # (t, active, cached tokens)
        rf = torch.profiler.record_function
        decode, prefill = eng._decode, eng._prefill

        def traced_decode(*a):
            act = eng.active.copy()
            n, cached = int(act.sum()), int(eng.lens[act].sum())
            self.decodes.append((time.perf_counter(), n, cached))
            with rf(f"{DECODE_SPAN}{n}.{cached}"):
                return decode(*a)

        def traced_prefill(S, *a):
            with rf(f"{PREFILL_SPAN}{S}"):
                return prefill(S, *a)

        eng._decode, eng._prefill = traced_decode, traced_prefill


async def _drive(run, eng, pool, warm) -> Dict:
    mix = run.mix
    n = mix["clients"]
    loop = asyncio.get_running_loop()
    temp = float(mix.get("temperature", 0.0))

    async def consume(prompt, k):
        async with contextlib.aclosing(eng.generate_stream(
                prompt, max_tokens=k, temperature=temp)) as s:
            return [t async for t in s]

    await asyncio.gather(*(consume(p, 2) for p in warm))
    if run.trace:
        import devtrace

        await loop.run_in_executor(eng._worker, devtrace.warm)

    records: List[Dict] = []
    stop = asyncio.Event()
    all_in = asyncio.Event()
    started = [0]
    order = iter(range(1 << 62))

    def first_in():
        started[0] += 1
        if started[0] == n:
            all_in.set()

    async def client(c):
        first = True
        while not stop.is_set():
            req = pool[next(order) % len(pool)]
            k = req.max_tokens
            if first and mix.get("first_request_phase"):
                k = T.first_request_tokens(k, c, n)
            rec = dict(send=time.perf_counter(), prompt=req.prompt,
                       max_tokens=k, tokens=[], times=[], error=None)
            try:
                async with contextlib.aclosing(eng.generate_stream(
                        req.prompt, max_tokens=k, temperature=temp)) as s:
                    async for tok in s:
                        rec["times"].append(time.perf_counter())
                        rec["tokens"].append(int(tok))
                        if first and len(rec["tokens"]) == 1:
                            first_in()
                        if stop.is_set():
                            break
            except Exception as e:  # noqa: BLE001 — a failed request counts
                rec["error"] = repr(e)
            if first and not rec["tokens"]:
                first_in()
            records.append(rec)
            first = False

    async def sample_held():
        total = eng.ecfg.num_kv_blocks
        while not stop.is_set():
            held[0] = max(held[0], total - len(eng.free_blocks))
            await asyncio.sleep(HELD_EVERY_S)

    tasks = [loop.create_task(client(c)) for c in range(n)]
    await asyncio.wait_for(all_in.wait(), timeout=600)
    t_open = time.perf_counter()
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_close = t_open + run.seconds
    held = [0]
    sampler = loop.create_task(sample_held())
    prof = None
    t_prof = None
    if run.trace:
        await asyncio.sleep(max(0.0, t_close - run.cell["trace_seconds"]
                                - LEAD_S - time.perf_counter()))
        t_prof = time.perf_counter()
        path = os.path.join(run.tmpdir, "trace.json")
        prof = await loop.run_in_executor(eng._worker, devtrace.Profile, path)
        await asyncio.sleep(LEAD_S)
        await loop.run_in_executor(eng._worker, prof.open)
    await asyncio.sleep(max(0.0, t_close - time.perf_counter()))
    stop.set()
    t_close = time.perf_counter()
    if prof is not None:
        await loop.run_in_executor(eng._worker, prof.stop)
    await asyncio.gather(*tasks, sampler)
    eng._loop_task.cancel()
    with contextlib.suppress(asyncio.CancelledError):
        await eng._loop_task
    return dict(records=records, t_open=t_open, t_close=t_close,
                t_prof=t_prof, held=held[0],
                trace_path=prof.path if prof else None)


def _sample(records, want_tokens: int, seed: int) -> List[Dict]:
    """Finished requests drawn from the seed: the longest first, then
    others until ``want_tokens`` served tokens."""
    done = [r for r in records if r["error"] is None
            and len(r["tokens"]) == r["max_tokens"]]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r["prompt"]) + len(r["tokens"]),
                                       r["send"]))
    rest = [r for r in done if r is not longest]
    pick, total = [longest], len(longest["tokens"])
    for i in T.rng(seed, 3).permutation(len(rest)):
        if total >= want_tokens:
            break
        pick.append(rest[i])
        total += len(rest[i]["tokens"])
    return pick


def widest_gaps(mc, params, sample, control: bool = False) -> Dict:
    """The reference's widest gap below its best logit: of the served
    tokens, and with ``control`` of the tokens that the fp8 reference
    puts first at the same positions."""
    ref = Reference(mc)
    low = Reference(mc, "fp8") if control else None
    gap, gap_ctl, n = 0.0, 0.0, 0
    for r in sample:
        plen, toks = len(r["prompt"]), r["tokens"]
        seq = r["prompt"] + toks[:-1]
        rows = list(range(plen - 1, plen - 1 + len(toks)))
        lg = ref.logits_rows(params, seq, rows)
        best = lg.max(-1).values
        served = torch.as_tensor(toks, device=lg.device)
        gap = max(gap, float((best - lg.gather(1, served[:, None])[:, 0]).max()))
        n += len(toks)
        if low is not None:
            first = low.logits_rows(params, seq, rows).argmax(-1)
            gap_ctl = max(gap_ctl, float(
                (best - lg.gather(1, first[:, None])[:, 0]).max()))
        del lg
    return {"widest_gap": gap, "control_gap": gap_ctl if control else None,
            "tokens": n}


def run(r) -> Dict:
    from ray_tpu_torch.llm._engine import EngineConfig, PagedEngine

    mc, e = r.mc, r.cell["engine"]
    cfg = port.llama_config(mc, torch.bfloat16,
                               max_seq_len=e["max_model_len"])
    params = W.draw(mc, r.seed, r.device, torch.bfloat16)
    sums = W.checksum(params)
    eng = PagedEngine(cfg, params, EngineConfig(**e), device=r.device)
    pool = T.closed_loop_requests(r.mix, r.seed, cfg.vocab_size,
                                  e["max_model_len"])
    probe = _Probe(eng) if r.trace else None
    out = asyncio.run(_drive(r, eng, pool,
                             _bucketed([q.prompt for q in pool])))
    eng._worker.shutdown(wait=True)
    if r.device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    setup_s = out["t_open"] - r.t0
    print(f"portbench: KV blocks held at peak {out['held']} of "
          f"{e['num_kv_blocks']}", file=sys.stderr)
    del eng
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    records = out["records"]
    chk = r.cell["check"]
    sample = _sample(records, chk["served_tokens"], r.seed)
    gaps = widest_gaps(mc, params, sample, control=bool(r.extra.get("control")))
    changed = sum(a != b for a, b in zip(sums.values(),
                                         W.checksum(params).values()))
    checks = {"widest_gap": (gaps["widest_gap"], "<=", chk["widest_gap"]),
              "compared_tokens": (gaps["tokens"], ">=",
                                  chk["min_compared_tokens"]),
              "weights_changed": (changed, "<=", 0)}
    correct = bool(sample) and port.passes(checks)
    # the host's tails in a traced run end where the profiler starts
    ctx = dict(records=records, t_open=out["t_open"],
               t_close=out["t_close"], setup_s=setup_s,
               t_host_close=out["t_prof"] or out["t_close"],
               probe=probe, engine=e)
    return dict(correct=correct, attempted=len(records),
                failed=sum(x["error"] is not None for x in records),
                memory_peak_bytes=peak, checks=checks, ctx=ctx,
                trace_path=out["trace_path"],
                extra=dict(gaps=gaps, sampled=len(sample),
                           kv_blocks_held=out["held"],
                           finished=sum(x["error"] is None and len(x["tokens"])
                                        == x["max_tokens"] for x in records)))
