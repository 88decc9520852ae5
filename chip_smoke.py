"""Drives the PyTorch / CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Builds every kernel of the serving path from ``ray_tpu_torch/csrc`` with
nvcc (sm_90a), then runs three phases and fails (exit 1) if any check
fails:

* k1      — the flash-attention forward kernel against its plain PyTorch
            version at the serving path's shapes, bf16, causal and not, GQA
            and MHA: max abs error of o and lse, kernel / plain / SDPA ms
            (CUDA events after warm-up; SDPA is the yardstick only, the port
            never calls it) and the least time the card could take.
* forward — ``forward`` at llama3_8b (full width, full depth, random bf16
            weights from a seed) on 1 x 2048 tokens with
            attention_impl="flash" against "xla": 32 kernel launches, top-1
            agreement, max abs difference of the log-softmax.
* serve   — a ``PagedEngine`` at llama3_8b answers 4 concurrent greedy
            requests (one admitted mid-decode); every first token must equal
            the argmax of the "xla" forward at the last prompt position; then
            ``LLMServer`` answers one batched and one streamed completion.

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
# 2048, at Llama-3-8B's heads; one MHA shape at head_dim 64
K1_SHAPES = [(1, 32, 8, s, 128) for s in (64, 200, 256, 512, 2048)] + [
    (2, 8, 8, 384, 64)]
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


def kernels_line(report):
    row = next(r for r in report["k1"] if r["causal"] and (
        r["b"], r["h"], r["kvh"], r["s"], r["hd"]) == K1_MAIN_SHAPE)
    return [{
        "name": "flash_fwd (K1)", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:122",
        "launches": report["serve"]["k1_launches"],
        "max_abs_err": max(r["err_o"] for r in report["k1"]),
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": row["sdpa_ms"],
    }]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="k1,forward,serve",
                    help="comma-separated subset of k1,forward,serve")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= {"k1", "forward", "serve"}:
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
    if phases & {"forward", "serve"}:
        report.update(phase_model(dev, phases))
    if "k1" in phases and "serve" in phases:
        report["kernels"] = kernels_line(report)
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
