"""Drives the PyTorch / CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase; needs one CUDA card
    python3 chip_smoke.py --phases k23,train # a subset

Builds every kernel of the serving and training paths from
``ray_tpu_torch/csrc`` with nvcc (sm_90a), all sources at once, then runs
five phases and fails (exit 1) if any check fails:

* k1      — the flash-attention forward kernel against its plain PyTorch
            version at the serving and training shapes, bf16, causal and
            not, GQA and MHA: max abs error of o and lse, kernel / plain /
            SDPA ms (CUDA events after warm-up; SDPA is the yardstick only,
            the port never calls it) and the least time the card could take.
* k23     — the backward kernels (K2 dq, K3 dk/dv) against their plain
            version on the same o and lse, at the training flagship's shape,
            Llama-3-8B's heads, a ragged s and an MHA hd-64 shape, causal
            and not: relative error of each gradient, kernel / plain ms, the
            bound, and SDPA's backward as the yardstick.
* forward — ``forward`` at llama3_8b (full width, full depth, random bf16
            weights from a seed) on 1 x 2048 tokens with
            attention_impl="flash" against "xla": 32 kernel launches, top-1
            agreement, max abs difference of the log-softmax.
* serve   — a ``PagedEngine`` at llama3_8b answers 4 concurrent greedy
            requests (one admitted mid-decode); every first token must equal
            the argmax of the "xla" forward at the last prompt position; then
            ``LLMServer`` answers one batched and one streamed completion.
* train   — ``make_train_step`` on the repo's training flagship (317M, full
            width and depth, fp32 params, bf16 compute, remat "dots") takes
            10 timed AdamW steps on one seeded 8 x 2048 batch: finite,
            falling loss, K1/K2/K3 launches per step, tokens/s, MFU, peak
            memory, one profiled step; then flash against xla on one step's
            loss and gradients.

The line before the last is the ``kernels`` JSON record, the last line
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
TOL_O = 2e-2               # o, absolute, plus TOL_O_REL of |o|: bf16
TOL_O_REL = 1e-2           # rounds the output once (2^-8 relative)
TOL_LSE = 1e-3             # lse is kept in fp32
SEED = 0

# (b, h, kvh, s, hd): the serving path's prompt buckets and the forward's
# 2048, at Llama-3-8B's heads; one MHA shape at head_dim 64; the training
# flagship's shape
K1_SHAPES = [(1, 32, 8, s, 128) for s in (64, 200, 256, 512, 2048)] + [
    (2, 8, 8, 384, 64), (8, 8, 4, 2048, 128)]
K1_MAIN_SHAPE = (1, 32, 8, 512, 128)  # the serve phase's largest bucket


def _fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _check(cond: bool, msg: str):
    if not cond:
        _fail(msg)


HOLD_CYCLES = 100_000_000  # ~50 ms of a spin kernel at the H100's clocks


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # hold the stream so the host has queued every launch before the device
    # reaches the first: the events then time the device, not the Python
    # wrapper's per-call overhead
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _k1_bound(b, h, kvh, s, hd, causal):
    """(bound_ms, bound_by, flops, bytes) for one K1 call: each input read
    once, each output written once; causal counts the s(s+1)/2 pairs the
    mask keeps."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4.0 * b * h * hd * pairs
    nbytes = 2.0 * (2 * b * h * s * hd + 2 * b * kvh * s * hd) + 4.0 * b * h * s
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def phase_k1(dev):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for (b, h, kvh, s, hd) in K1_SHAPES:
        q = torch.randn((b, h, s, hd), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, kvh, s, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, kvh, s, hd), generator=gen, device=dev).bfloat16()
        for causal in (True, False):
            o, lse = fa._flash_fwd_cuda(q, k, v, causal)
            torch.cuda.synchronize()
            ro, rlse = fa._attention_reference(q, k, v, causal)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_lse = (lse - rlse).abs().max().item()
            finite = bool(torch.isfinite(o).all()) and bool(
                torch.isfinite(lse).all())
            ms = _time_ms(lambda: fa._flash_fwd_cuda(q, k, v, causal))
            plain_ms = _time_ms(
                lambda: fa._attention_reference(q, k, v, causal), iters=5)
            sdpa_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=kvh != h))
            bound_ms, bound_by, flops, nbytes = _k1_bound(
                b, h, kvh, s, hd, causal)
            row = dict(b=b, h=h, kvh=kvh, s=s, hd=hd, causal=causal,
                       err_o=err_o, err_lse=err_lse, ms=ms,
                       plain_ms=plain_ms, sdpa_ms=sdpa_ms, bound_ms=bound_ms,
                       bound_by=bound_by, tflops=flops / (ms * 1e-3) / 1e12,
                       gbytes=nbytes / 1e9)
            rows.append(row)
            print(json.dumps({"k1": row}), flush=True)
            _check(finite, f"K1 output not finite at {row}")
            # o: |err| <= TOL_O + TOL_O_REL |ref| (bf16 rounds o once)
            o_ok = bool(((o.float() - ro.float()).abs()
                         <= TOL_O + TOL_O_REL * ro.float().abs()).all())
            _check(o_ok and err_lse <= TOL_LSE,
                   f"K1 disagrees with _attention_reference beyond "
                   f"o {TOL_O} + {TOL_O_REL}|o| / lse {TOL_LSE}: {row}")
    return rows


# (b, h, kvh, s, hd) of the K2/K3 check: the training flagship's heads and
# batch first (the main path's shape), Llama-3-8B's (rep 4), a ragged s, and
# one MHA shape at head_dim 64
K23_SHAPES = [(8, 8, 4, 2048, 128), (1, 32, 8, 2048, 128),
              (1, 32, 8, 200, 128), (2, 8, 8, 384, 64)]
K23_MAIN_SHAPE = K23_SHAPES[0]
# each gradient is accumulated in fp32 and rounded to bf16 once (2^-8
# relative): per tensor, ||err|| / ||ref|| and max|err| / max|ref|
TOL_GRAD_NORM = 1e-2
TOL_GRAD_MAX = 2e-2


def _k23_bounds(b, h, kvh, s, hd, causal):
    """{kernel: (bound_ms, bound_by, flops, bytes)} for K2 and K3: the JAX
    cost estimates' 3 and 4 products of 2 b h hd per (q, k) pair, over the
    s(s+1)/2 pairs the causal mask keeps; q, k, v, dO, lse and delta read
    once, the gradients written once."""
    pairs = s * (s + 1) / 2 if causal else s * s
    qbytes, kvbytes, rows = 2.0 * b * h * s * hd, 2.0 * b * kvh * s * hd, \
        4.0 * b * h * s
    read = 2 * qbytes + 2 * kvbytes + 2 * rows
    out = {}
    for name, products, written in (("k2", 3, qbytes), ("k3", 4, 2 * kvbytes)):
        flops = 2.0 * products * b * h * hd * pairs
        t_ops = flops / PEAK_BF16_FLOPS
        t_bytes = (read + written) / PEAK_HBM_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     read + written)
    return out


def _grad_errors(got, want):
    """(max|err|, ||err|| / ||ref||, max|err| / max|ref|) in fp32."""
    got, want = got.float(), want.float()
    err = got - want
    return (err.abs().max().item(), (err.norm() / want.norm()).item(),
            (err.abs().max() / want.abs().max()).item())


def phase_k23(dev):
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for (b, h, kvh, s, hd) in K23_SHAPES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).bfloat16()

        q, k, v, g = (randn(b, h, s, hd), randn(b, kvh, s, hd),
                      randn(b, kvh, s, hd), randn(b, h, s, hd))
        for causal in (True, False):
            # o and lse from the plain forward, fed to both sides, so the
            # backward kernels are held alone
            o, lse = fa._attention_reference(q, k, v, causal)
            dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, g, causal)
            torch.cuda.synchronize()
            ref = fa._flash_bwd_reference(q, k, v, o, lse, g, causal)
            row = dict(b=b, h=h, kvh=kvh, s=s, hd=hd, causal=causal)
            ok = True
            for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                finite = bool(torch.isfinite(got).all())
                mx, rel_norm, rel_max = _grad_errors(got, want)
                row[f"err_{name}"] = mx
                row[f"rel_norm_{name}"] = rel_norm
                row[f"rel_max_{name}"] = rel_max
                ok = ok and finite and rel_norm <= TOL_GRAD_NORM \
                    and rel_max <= TOL_GRAD_MAX
            if (b, h, kvh, s, hd) == K23_MAIN_SHAPE and causal:
                # the fp32-dq variant (the ring-hop backward's) at one shape
                delta = (g.float() * o.float()).sum(-1)
                dq32 = fa._launch_dq(q, k, v, g, lse, delta, causal,
                                     dq_fp32=True)
                ref32 = fa._flash_bwd_reference(q.float(), k, v, o, lse, g,
                                                causal)[0]
                _, rel_norm, rel_max = _grad_errors(dq32, ref32)
                row["rel_norm_dq_fp32"] = rel_norm
                ok = ok and dq32.dtype == torch.float32 and bool(
                    torch.isfinite(dq32).all()) and rel_norm <= TOL_GRAD_NORM \
                    and rel_max <= TOL_GRAD_MAX
            delta = (g.float() * o.float()).sum(-1)
            row["k2_ms"] = _time_ms(
                lambda: fa._launch_dq(q, k, v, g, lse, delta, causal))
            row["k3_ms"] = _time_ms(
                lambda: fa._launch_dkv(q, k, v, g, lse, delta, causal))
            row["plain_ms"] = _time_ms(lambda: fa._flash_bwd_reference(
                q, k, v, o, lse, g, causal), iters=3, warmup=1)
            # the library yardstick: SDPA's backward (K2 + K3 together) on a
            # retained graph; the port never calls it
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            out = F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=kvh != h)
            row["sdpa_bwd_ms"] = _time_ms(lambda: torch.autograd.grad(
                out, (qs, ks, vs), g, retain_graph=True))
            del out, qs, ks, vs
            for name, (bms, by, flops, nbytes) in _k23_bounds(
                    b, h, kvh, s, hd, causal).items():
                row[f"{name}_bound_ms"] = bms
                row[f"{name}_bound_by"] = by
                row[f"{name}_tflops"] = flops / (row[f"{name}_ms"] * 1e-3) \
                    / 1e12
            rows.append(row)
            print(json.dumps({"k23": row}), flush=True)
            _check(ok, f"K2/K3 outside ||err||/||ref|| <= {TOL_GRAD_NORM}, "
                   f"max|err| <= {TOL_GRAD_MAX} max|ref| or not finite: {row}")
    return rows


FWD_TOKENS = 2048
SERVE_PROMPTS = (37, 130, 300, 511)
SERVE_MAX_TOKENS = 32
# flash vs xla forward top-1 agreement: two correct bf16 paths agree on
# ~95% of positions through 32 random layers (this script, H100); a broken
# kernel agrees on almost none
TOP1_MIN = 0.9


def phase_model(dev, phases):
    """The forward and serve phases on one set of llama3_8b weights, then
    LLMServer on its own."""
    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, forward, init_params
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16,
                                attention_impl="flash")
    xcfg = LlamaConfig.llama3_8b(param_dtype=torch.bfloat16)
    out = {}
    t0 = time.monotonic()
    params = init_params(cfg, SEED)  # the default device: CUDA
    torch.cuda.synchronize()
    out["init_s"] = time.monotonic() - t0
    print(f"init: llama3_8b {cfg.num_params() / 1e9:.3f}B params bf16 in "
          f"{out['init_s']:.2f} s", flush=True)

    if "forward" in phases:
        toks = torch.from_numpy(np.random.RandomState(SEED).randint(
            0, cfg.vocab_size, size=(1, FWD_TOKENS))).to(dev)
        with torch.no_grad():
            forward(cfg, params, toks[:, :64])  # warm-up: cuBLAS, kernel
            torch.cuda.synchronize()
            fa.flash_fwd_launches = 0
            t = time.monotonic()
            lf = forward(cfg, params, toks)
            torch.cuda.synchronize()
            flash_s = time.monotonic() - t
            launches = fa.flash_fwd_launches
            forward(xcfg, params, toks[:, :64])
            torch.cuda.synchronize()
            t = time.monotonic()
            lx = forward(xcfg, params, toks)
            torch.cuda.synchronize()
            xla_s = time.monotonic() - t
            top1 = (lf.argmax(-1) == lx.argmax(-1)).float().mean().item()
            dls = (torch.log_softmax(lf, -1) - torch.log_softmax(lx, -1)
                   ).abs().max().item()
            finite = bool(torch.isfinite(lf).all())
        del lf, lx
        fwd = dict(tokens=FWD_TOKENS, k1_launches=launches,
                   flash_ms=flash_s * 1e3, xla_ms=xla_s * 1e3,
                   top1_agreement=top1, max_abs_logsoftmax_diff=dls)
        out["forward"] = fwd
        print(json.dumps({"forward": fwd}), flush=True)
        _check(finite, "flash forward logits not finite")
        _check(launches == cfg.n_layers,
               f"forward launched K1 {launches} times, want {cfg.n_layers}")
        _check(top1 >= TOP1_MIN,
               f"flash vs xla forward top-1 agreement {top1} < {TOP1_MIN}")

    if "serve" in phases:
        out["serve"] = _serve(dev, cfg, xcfg, params)
    del params
    torch.cuda.empty_cache()
    if "serve" in phases:
        out["llm_server"] = _llm_server()
    return out


def _serve(dev, cfg, xcfg, params):
    import asyncio

    import numpy as np
    import torch

    from ray_tpu_torch.llm._engine import EngineConfig, PagedEngine
    from ray_tpu_torch.models.llama import forward
    from ray_tpu_torch.ops import flash_attention as fa

    ecfg = EngineConfig(max_num_seqs=4, kv_block_size=16, num_kv_blocks=256,
                        max_model_len=1024)
    eng = PagedEngine(cfg, params, ecfg)
    rng = np.random.RandomState(SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in SERVE_PROMPTS]
    warm_prompt = rng.randint(0, cfg.vocab_size, size=100).tolist()
    submit, stamps, outs, base = {}, {}, {}, {}

    async def one(i):
        submit[i] = time.monotonic()
        toks, ts = [], []
        async for t in eng.generate_stream(prompts[i],
                                           max_tokens=SERVE_MAX_TOKENS):
            ts.append(time.monotonic())
            toks.append(t)
        outs[i], stamps[i] = toks, ts

    async def main():
        # warm-up: the engine's worker thread makes its cuBLAS state here,
        # outside the measured window
        async for _ in eng.generate_stream(warm_prompt, max_tokens=4):
            pass
        base.update(eng.stats())
        cache = base["prefix_cache"]
        base["misses"] = cache["misses"] if cache is not None else 0
        fa.flash_fwd_launches = 0
        base["t0"] = time.monotonic()
        tasks = [asyncio.create_task(one(i)) for i in range(3)]
        # the last request arrives mid-decode
        while eng.steps == base["steps"] and not all(t.done() for t in tasks):
            await asyncio.sleep(0.001)
        tasks.append(asyncio.create_task(one(3)))
        await asyncio.gather(*tasks)
        base["wall"] = time.monotonic() - base["t0"]

    asyncio.run(main())
    launches = fa.flash_fwd_launches
    st = eng.stats()
    cache = st["prefix_cache"]
    full_prefills = (cache["misses"] - base["misses"] if cache is not None
                     else len(prompts))
    wall = base["wall"]
    n_tokens = sum(len(o) for o in outs.values())
    ttft = {SERVE_PROMPTS[i]: stamps[i][0] - submit[i] for i in stamps}
    itl = [(ts[-1] - ts[0]) / (len(ts) - 1) for ts in stamps.values()
           if len(ts) > 1]
    serve = dict(requests=len(prompts), prompt_tokens=list(SERVE_PROMPTS),
                 tokens_out=n_tokens, wall_s=wall,
                 tokens_per_s=n_tokens / wall, ttft_s=ttft,
                 ttft_p50_s=sorted(ttft.values())[len(ttft) // 2],
                 mean_inter_token_ms=1e3 * sum(itl) / len(itl),
                 decode_steps=st["steps"] - base["steps"],
                 mid_decode_admissions=(st["mid_decode_admissions"]
                                        - base["mid_decode_admissions"]),
                 free_blocks=st["free_blocks"],
                 blocks_in_use=st["blocks_in_use"],
                 full_prefills=full_prefills, k1_launches=launches)
    _check(all(len(outs.get(i, [])) == SERVE_MAX_TOKENS
               for i in range(len(prompts))),
           f"not every request got {SERVE_MAX_TOKENS} tokens: "
           f"{ {i: len(o) for i, o in outs.items()} }")
    # every first token is the plain-attention forward's argmax; the top-1
    # margin of that forward says how far bf16 noise is from a flip
    margins = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            ref = forward(xcfg, params, torch.tensor([p], device=dev))[0, -1]
            top2 = torch.topk(ref, 2).values
            margins.append(float(top2[0] - top2[1]))
            want = int(torch.argmax(ref))
            _check(outs[i][0] == want,
                   f"request {i} ({len(p)} tokens): first token "
                   f"{outs[i][0]} != xla forward argmax {want} (top-1 "
                   f"margin {margins[-1]:.4f}, engine token's logit "
                   f"{float(ref[outs[i][0]]):.4f} vs {float(top2[0]):.4f})")
    serve["first_token_top1_margins"] = margins
    serve["decode_profile"] = _decode_profile(eng, dev)
    print(json.dumps({"serve": serve}), flush=True)
    _check(serve["mid_decode_admissions"] >= 1, "no mid-decode admission")
    _check(st["free_blocks"] == ecfg.num_kv_blocks
           and st["blocks_in_use"] == 0, f"KV blocks leaked: {st}")
    _check(launches == cfg.n_layers * full_prefills,
           f"K1 launches {launches} != {cfg.n_layers} x {full_prefills} "
           f"full prefills")
    return serve


def _decode_profile(eng, dev, n_steps: int = 4):
    """One full-batch decode step (4 active slots at the served prompts'
    lengths): host wall time against the device time of its kernels
    (torch.profiler), so the device's idle share and kernels per step."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    B = eng.ecfg.max_num_seqs
    tables = torch.arange(1, 1 + B * eng.max_blocks, device=dev).reshape(
        B, eng.max_blocks)
    lens = torch.tensor(SERVE_PROMPTS, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    last = torch.zeros(B, dtype=torch.long, device=dev)
    temps, gens = np.zeros(B, np.float32), [None] * B

    def step():
        eng._decode(eng.params, eng.kc, eng.vc, tables, lens, active, last,
                    gens, temps)
        torch.cuda.synchronize()

    with torch.no_grad():
        step()
        t = time.monotonic()
        for _ in range(n_steps):
            step()
        host_ms = (time.monotonic() - t) * 1e3 / n_steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                step()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n_steps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(host_ms_per_step=host_ms,
               device_ms_per_step=dev_ms if dev_ms > 0 else "not measured",
               kernels_per_step=sum(e.count for e in kernels) / n_steps,
               top_kernels_ms_per_step={
                   e.key[:60]: e.self_device_time_total / 1e3 / n_steps
                   for e in top})
    if dev_ms > 0:
        out["device_idle_share"] = 1.0 - dev_ms / host_ms
    return out


def _llm_server():
    import torch

    from ray_tpu_torch.llm import LLMConfig, LLMServer

    server = LLMServer(LLMConfig(
        model_id="llama3-8b-random", model="llama3_8b",
        model_overrides={"param_dtype": torch.bfloat16}, seed=SEED))
    t = time.monotonic()
    res = server({"prompt": ["The H100 is", "Paged attention"],
                  "max_tokens": 16})
    batch_s = time.monotonic() - t
    t = time.monotonic()
    chunks = list(server({"prompt": "Hello", "max_tokens": 16,
                          "stream": True}))
    stream_s = time.monotonic() - t
    info = dict(batch_choices=len(res["choices"]),
                completion_tokens=res["usage"]["completion_tokens"],
                batch_s=batch_s, stream_chunks=len(chunks),
                stream_s=stream_s,
                finish_reason=chunks[-1]["choices"][0].get("finish_reason"))
    print(json.dumps({"llm_server": info}), flush=True)
    _check(res["object"] == "text_completion" and len(res["choices"]) == 2,
           f"bad batched completion: {res}")
    _check(0 < res["usage"]["completion_tokens"] <= 32,
           f"bad completion token count: {res['usage']}")
    _check(chunks and chunks[-1]["choices"][0].get("finish_reason")
           in ("stop", "length"), f"bad stream: {chunks[-1:]}")
    return info


# the repo's training flagship (bench.py, __graft_entry__.py) at full width
# and depth: 317.2M parameters, hd 128, GQA rep 2
TRAIN_CFG = dict(vocab_size=32000, dim=1024, n_layers=16, n_heads=8,
                 n_kv_heads=4, ffn_dim=4096, max_seq_len=2048)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2048, 10
TRAIN_LR = 1e-4            # bench.py's
TRAIN_REMAT = "dots"       # recomputes K1 in the backward: 2 launches a layer
# flash vs xla, one step at b1 s2048 on the same weights: two correct bf16
# paths differ in rounding only
TOL_LOSS_REL = 1e-2
GRAD_COS_MIN = 0.99


def _palm_flops_per_token(cfg, seq):
    """bench.py's PaLM-style count: 6N + 12 L dim s."""
    return 6.0 * cfg.num_params() + 12.0 * cfg.n_layers * cfg.dim * seq


def phase_train(dev):
    import numpy as np
    import torch

    from ray_tpu_torch.models.llama import (LlamaConfig, compute_loss,
                                            make_train_step)
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0)
    t0 = time.monotonic()
    state = shard_state(init_state(SEED))
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    # one fixed seeded batch, reused every step (as bench.py does)
    tokens = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, cfg.vocab_size, size=(TRAIN_BATCH, TRAIN_SEQ))).to(data_dev)
    state, loss = train_step(state, tokens)  # warm-up: cuBLAS, kernels
    losses = [float(loss)]
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    t = time.monotonic()
    step_losses = []
    for _ in range(TRAIN_STEPS):
        state, loss = train_step(state, tokens)
        step_losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.monotonic() - t) / TRAIN_STEPS
    launches = dict(k1=fa.flash_fwd_launches, k2=fa.flash_bwd_dq_launches,
                    k3=fa.flash_bwd_dkv_launches)
    losses += [float(x) for x in step_losses]
    peak = torch.cuda.max_memory_allocated()
    tokens_per_s = TRAIN_BATCH * TRAIN_SEQ / dt
    out = dict(
        config=dict(TRAIN_CFG, attention_impl="flash", remat=TRAIN_REMAT,
                    loss_chunk=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    num_params=cfg.num_params(), lr=TRAIN_LR),
        init_s=init_s, losses=losses, step_ms=dt * 1e3,
        tokens_per_s=tokens_per_s,
        mfu_palm=_palm_flops_per_token(cfg, TRAIN_SEQ) * tokens_per_s
        / PEAK_BF16_FLOPS,
        peak_memory_gb=peak / 1e9,
        launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
        launches=launches)
    out["profile"] = _train_profile(train_step, state, tokens)
    _check(all(np.isfinite(losses)), f"train losses not finite: {losses}")
    _check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    n = cfg.n_layers * TRAIN_STEPS
    _check(launches["k2"] == n and launches["k3"] == n,
           f"K2/K3 launched {launches['k2']}/{launches['k3']} times in "
           f"{TRAIN_STEPS} steps, want {cfg.n_layers} per step")
    _check(launches["k1"] == 2 * n,
           f"K1 launched {launches['k1']} times in {TRAIN_STEPS} steps, want "
           f"{cfg.n_layers} x (1 + 1 recompute) per step")

    # flash vs xla: one step's loss and gradients on the trained weights
    params = state[0]
    del state
    torch.cuda.empty_cache()
    one = tokens[:1]
    leaves = [(f"layers.{k}", w) for k, w in params["layers"].items()] + [
        (k, params[k]) for k in ("tok_emb", "norm", "lm_head")]
    grads = {}
    for impl in ("flash", "xla"):
        icfg = LlamaConfig(**TRAIN_CFG, attention_impl=impl)
        loss = compute_loss(icfg, params, one, remat=TRAIN_REMAT,
                            loss_chunk=0)
        g = torch.autograd.grad(loss, [w for _, w in leaves])
        grads[impl] = (float(loss.detach()), g)
    cos = {}
    for (name, _), gf, gx in zip(leaves, grads["flash"][1], grads["xla"][1]):
        cos[name] = torch.nn.functional.cosine_similarity(
            gf.flatten().double(), gx.flatten().double(), dim=0).item()
    lf, lx = grads["flash"][0], grads["xla"][0]
    out["flash_vs_xla"] = dict(tokens=TRAIN_SEQ, loss_flash=lf, loss_xla=lx,
                               loss_rel_diff=abs(lf - lx) / abs(lx),
                               grad_cosine=cos, grad_cosine_min=min(
                                   cos.values()))
    print(json.dumps({"train": out}), flush=True)
    _check(abs(lf - lx) <= TOL_LOSS_REL * abs(lx),
           f"flash vs xla loss {lf} vs {lx} beyond {TOL_LOSS_REL} relative")
    _check(min(cos.values()) >= GRAD_COS_MIN,
           f"flash vs xla gradient cosine below {GRAD_COS_MIN}: {cos}")
    return out


def _train_profile(train_step, state, tokens):
    """One train step under torch.profiler: host wall time against the
    device time of its kernels, so the device's idle share, and the top
    kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        train_step(state, tokens)
        torch.cuda.synchronize()
        host_ms = (time.monotonic() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    out = dict(host_ms=host_ms,
               device_ms=dev_ms if dev_ms > 0 else "not measured",
               kernels=sum(e.count for e in kernels),
               top_kernels_ms={e.key[:60]: e.self_device_time_total / 1e3
                               for e in top},
               # K1, K2, K3 (and their launches) in this step
               flash_kernels={e.key[:60]: [e.self_device_time_total / 1e3,
                                           e.count]
                              for e in kernels if "flash_" in e.key})
    if dev_ms > 0:
        out["device_idle_share"] = 1.0 - dev_ms / host_ms
    return out


def kernels_line(report):
    """The kernels record: each kernel at its main path's shape, with the
    launches of that path's run (K1: the serve phase; K2/K3: the train
    phase's timed steps)."""
    line = []
    if "k1" in report and "serve" in report:
        row = next(r for r in report["k1"] if r["causal"] and (
            r["b"], r["h"], r["kvh"], r["s"], r["hd"]) == K1_MAIN_SHAPE)
        line.append({
            "name": "flash_fwd (K1)", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "ray_tpu/ops/flash_attention.py:122",
            "launches": report["serve"]["k1_launches"],
            "max_abs_err": max(r["err_o"] for r in report["k1"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["sdpa_ms"],
        })
    if "k23" in report and "train" in report:
        row = next(r for r in report["k23"] if r["causal"] and (
            r["b"], r["h"], r["kvh"], r["s"], r["hd"]) == K23_MAIN_SHAPE)
        for key, name, line_no, errs in (
                ("k2", "flash_bwd_dq (K2)", 275, ("err_dq",)),
                ("k3", "flash_bwd_dkv (K3)", 320, ("err_dk", "err_dv"))):
            line.append({
                "name": name, "route": "cuda",
                "source": "ray_tpu_torch/csrc/flash_bwd.cu",
                "replaces": f"ray_tpu/ops/flash_attention.py:{line_no}",
                "launches": report["train"]["launches"][key],
                "max_abs_err": max(r[e] for r in report["k23"] for e in errs),
                "ms": row[f"{key}_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row[f"{key}_bound_ms"],
                "bound_by": row[f"{key}_bound_by"],
                # SDPA's backward computes K2's and K3's work in one call
                "library_ms": row["sdpa_bwd_ms"],
            })
    return line


PHASES = ("k1", "k23", "forward", "serve", "train")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases)}")

    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA "
              "card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ray_tpu_torch.ops import _build
    except ImportError as e:
        _fail(f"ray_tpu_torch is not beside chip_smoke.py: {e}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    _check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    print(card, flush=True)  # name, power limit: as nvidia-smi gives them
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.monotonic()
    _build.build_all()
    build_s = time.monotonic() - t0
    print(f"build: {build_s:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})",
          flush=True)

    report = {"card": card, "build_s": build_s}
    if "k1" in phases:
        report["k1"] = phase_k1(dev)
    if "k23" in phases:
        report["k23"] = phase_k23(dev)
    if phases & {"forward", "serve"}:
        report.update(phase_model(dev, phases))
    if "train" in phases:
        report["train"] = phase_train(dev)
    report["kernels"] = kernels_line(report)
    if report["kernels"]:
        print(json.dumps({"kernels": report["kernels"]}), flush=True)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
