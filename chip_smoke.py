"""Drives the PyTorch / CUDA port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase; one CUDA card
    python3 chip_smoke.py --phases k4,k5,ring   # a subset

Builds every kernel of the serving, training and sequence-parallel paths
from ``ray_tpu_torch/csrc`` with nvcc (sm_90a), all sources at once, then
runs thirteen phases and fails (exit 1) if any check fails:

* k1      — the flash-attention forward kernel against its plain PyTorch
            version at the serving and training shapes, bf16, causal and
            not, GQA and MHA: max abs error of o and lse, kernel / plain /
            SDPA ms (CUDA events after warm-up; SDPA is the yardstick only,
            the port never calls it) and the least time the card could take.
* k23     — the backward kernels (K2 dq, K3 dk/dv) against their plain
            version on the same o and lse, at the training flagship's shape,
            Llama-3-8B's heads, a ragged s and an MHA hd-64 shape, causal
            and not: relative error of each gradient and of the delta K2
            writes, two K2 launches bitwise equal, kernel / plain ms, the
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
            memory, one profiled step, the kernels of one flash backward
            (K2 and K3 alone); then flash against xla on one step's loss
            and gradients.
* k4      — the ring-hop kernel (K4) against its plain version
            (``_chunk_xla``) at the training ring's hop (b1 h8 kvh4 s2048
            hd128) and Llama-3-8B's heads (s512), unmasked and diagonal
            hops, from a fresh and a carried state: o/l, m and l, kernel /
            plain / SDPA-forward ms and the bound.
* k5      — the ring-hop backward (K5: K2 with an fp32 dq, K3 with fp32
            dk/dv) against ``_hop_bwd_xla`` at the same shapes, causal and
            not, with the global lse/delta of a two-hop forward.
* route   — the three public entries on CUDA inputs the kernels do not
            take (fp32; bf16 at head_dim 32), forward and backward: no
            kernel launch, and the plain versions' results on the card;
            an empty bf16 batch launches nothing either.
* ring    — the sequence-parallel path on sp 4: four processes on the one
            card over a gloo group (NCCL refuses two ranks on one GPU), every
            collective staged through host memory. Ring and Ulysses attention
            forward and backward at b1 h8 kvh4 hd128 over s 32768 against the
            whole-sequence flash attention, K4 / K2 / K3 launches counted;
            then ``make_train_step`` on the flagship with "ring" at b1 s8192
            (2048 a rank), one warm-up and 3 steps, losses against a
            single-process "flash" run. Its times are not the ring's speed:
            the ranks time-slice the card.
* shard   — sharded training on fsdp 2 x tp 2: four processes on the card
            over gloo as in ``ring``. ``make_train_step`` on the flagship
            ("flash", remat "dots") at b8 x 2048 from one seed, each rank
            holding a quarter of the parameters and AdamW moments: one
            warm-up and 2 timed steps, each loss against the single-device
            "flash" step, the gathered gradients of the first step and the
            parameters after it against its, K1 32 / K2 16 / K3 16
            launches a step a rank at the rank's shape (b4 h4 kvh2 s2048
            hd128), the step's seconds and each rank's peak memory. Its
            times measure time-slicing too.
* pipe    — GPipe over pp 4 (``parallel/pipeline.py``): four processes
            on the card over gloo, as in ``shard``, each a stage of 4 of
            the flagship's 16 layers ("flash", no remat) at full width;
            8 microbatches of one sequence of the b8 x 2048 train batch,
            one warm-up and 2 timed steps. Gates: each loss within 1e-2 of
            the single-device "flash" step; each rank's step-one
            gradients and parameters against the reference's layers
            [4s, 4s + 4), tok_emb, norm and lm_head (the shard phase's
            tolerances); K1 = K2 = K3 = 32 launches a step a rank, all at
            (1, 8, 4, 2048, 128) causal, K4 none; 201 MB of hand-offs a
            step. Step ms and peak memory a rank, the bubble share 3/11;
            its times measure time-slicing too. ``k1``/``k23`` hold K1-K3
            at that shape.
* vit     — ViT-B/16 (86.5M parameters, 224² images, patch 16, 12 layers,
            12 heads of 64) at full width and depth: fp32 parameters, bf16
            compute, "flash", no remat, one seeded batch of 128 NHWC
            images; one warm-up and 10 timed AdamW steps. Gates: finite,
            falling loss; K1, K2 and K3 12 a step each, every launch at
            (128, 12, 12, 196, 64) and unmasked; flash against xla on the
            loss after 3 steps (1e-2), the step-one head gradients (cosine
            >= 0.99) and the forward of converted weights with a nonzero
            head (top-1 agreement). Step ms, images/s, peak memory, one
            profiled step. ``k1``/``k23`` hold K1-K3 at that shape.
* moe     — ``moe_ffn`` at Mixtral-8x7B's FFN widths (d_model 4096, d_ff
            14336, 8 experts, top-2; the JAX package's GELU pair) on 4096
            bf16 tokens at capacity factor 2 against a per-token reference
            on the card (1e-2), its dropped slots and its combine weights;
            then ``moe_ffn_ep`` over tp 4 (four processes on the card over
            gloo, as in ``shard``) on 1024 tokens at capacity factor 8,
            its outputs and router / w_in / w_out gradients against the
            single shard's. ms a call, tokens/s, the exchange's bytes; the
            plain products run no kernel of the port.

The line before the last is the ``kernels`` JSON record, the last line
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bytes/s
TOL_O = 2e-2               # o, absolute, plus TOL_O_REL of |o|: bf16
TOL_O_REL = 1e-2           # rounds the output once (2^-8 relative)
TOL_LSE = 1e-3             # lse is kept in fp32
SEED = 0

# (b, h, kvh, s, hd): the serving path's prompt buckets and the forward's
# 2048, at Llama-3-8B's heads; one MHA shape at head_dim 64; the training
# flagship's shape, and a rank's share of it in the shard phase (half the
# rows over fsdp, half the heads over tp); ViT-B/16's at the vit phase's
# batch (196 patches: every 64-row tile of it a tail tile); the pipe
# phase's microbatch
VIT_SHAPE = (128, 12, 12, 196, 64)
# a pipe-phase microbatch: one sequence of the flagship, all 8 heads
PIPE_SHAPE = (1, 8, 4, 2048, 128)
K1_SHAPES = [(1, 32, 8, s, 128) for s in (64, 200, 256, 512, 2048)] + [
    (2, 8, 8, 384, 64), (8, 8, 4, 2048, 128), (4, 4, 2, 2048, 128),
    VIT_SHAPE, PIPE_SHAPE]
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


# SASS opcodes that show a library's design: HGMMA is wgmma, UTMALDG a TMA
# load, LDGSTS a cp.async copy, HMMA mma.sync
SASS_OPS = ("HGMMA", "UTMALDG", "LDGSTS", "HMMA")


def _demangle(names):
    """Kernels' C++ names, template arguments and all, from their symbols
    (``cu++filt`` beside nvcc; the symbols themselves where that fails)."""
    from ray_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    try:
        out = subprocess.run([tool, *names], capture_output=True, text=True)
    except OSError:
        return list(names)
    lines = out.stdout.splitlines()
    return lines if len(lines) == len(names) else list(names)


def build_info(paths):
    """For each built library: the SASS opcode counts of ``SASS_OPS``
    (``cuobjdump --dump-sass``) and ptxas's report of each kernel's
    registers and spills. Printed, not gated."""
    import re

    from ray_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    info = {}
    for lib, path in paths.items():
        entry = {}
        sass = subprocess.run([cuobjdump, "--dump-sass", path],
                              capture_output=True, text=True)
        if sass.returncode == 0:
            entry["sass"] = {op: len(re.findall(rf"\b{op}\b", sass.stdout))
                             for op in SASS_OPS}
        else:
            entry["sass"] = f"not measured: {sass.stderr.strip()[:200]}"
        log = _build.log_path(lib)
        if os.path.exists(log):
            with open(log) as f:
                text = f.read()
            # per kernel: "Used N registers" and its spill line
            chunks = text.split("Compiling entry function '")[1:]
            names = _demangle([c.split("'", 1)[0] for c in chunks])
            kernels = {}
            for name, chunk in zip(names, chunks):
                regs = re.search(r"Used (\d+) registers", chunk)
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                                  r"spill loads", chunk)
                kernels[name] = dict(
                    registers=int(regs.group(1)) if regs else None,
                    spill_bytes=int(spill.group(1)) + int(spill.group(2))
                    if spill else None)
            entry["kernels"] = kernels
            entry["warnings"] = sorted({line.strip() for line in
                                        text.splitlines()
                                        if "warning" in line.lower()
                                        or "Performance Loss" in line})
        info[lib] = entry
    return info


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
                       bound_by=bound_by, frac_of_bound=bound_ms / ms,
                       x_library=ms / sdpa_ms,
                       tflops=flops / (ms * 1e-3) / 1e12,
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
# batch first (the main path's shape), Llama-3-8B's (rep 4), a ragged s,
# one MHA shape at head_dim 64, a shard-phase rank's share of the flagship
# (its grid is a quarter of the flagship's), ViT-B/16's and a pipe-phase
# microbatch's
K23_SHAPES = [(8, 8, 4, 2048, 128), (1, 32, 8, 2048, 128),
              (1, 32, 8, 200, 128), (2, 8, 8, 384, 64), (4, 4, 2, 2048, 128),
              VIT_SHAPE, PIPE_SHAPE]
K23_MAIN_SHAPE = K23_SHAPES[0]
# each gradient is accumulated in fp32 and rounded to bf16 once (2^-8
# relative): per tensor, ||err|| / ||ref|| and max|err| / max|ref|
TOL_GRAD_NORM = 1e-2
TOL_GRAD_MAX = 2e-2
# the delta K2 writes against torch's fp32 rowsum of the same bf16 values:
# the same sum in another order, ||err|| / ||ref||
TOL_DELTA = 1e-5


def _k23_bounds(b, h, kvh, s, hd, causal, grad_bytes=2, fused_delta=True):
    """{kernel: (bound_ms, bound_by, flops, bytes)} for K2 and K3: the JAX
    cost estimates' 3 and 4 products of 2 b h hd per (q, k) pair, over the
    s(s+1)/2 pairs the causal mask keeps; each input read once, each output
    written once: q, k, v, dO, lse and delta read, the gradients written
    (``grad_bytes`` an element: 4 for the ring hop's fp32 gradients, K5),
    except that K2 with ``fused_delta`` (the training path's) reads o and
    writes delta instead of reading delta."""
    pairs = s * (s + 1) / 2 if causal else s * s
    qbytes, kvbytes, rows = 2.0 * b * h * s * hd, 2.0 * b * kvh * s * hd, \
        4.0 * b * h * s
    read = 2 * qbytes + 2 * kvbytes + 2 * rows
    w = grad_bytes / 2
    k2_delta = qbytes if fused_delta else 0.0  # o read; delta written, not read
    out = {}
    for name, products, moved in (("k2", 3, read + k2_delta + w * qbytes),
                                  ("k3", 4, read + w * 2 * kvbytes)):
        flops = 2.0 * products * b * h * hd * pairs
        t_ops = flops / PEAK_BF16_FLOPS
        t_bytes = moved / PEAK_HBM_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes", flops,
                     moved)
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
            # the delta K2 writes (the K3 above read it), and two K2 launches
            # on the same inputs: bitwise equal (no atomics)
            delta = (g.float() * o.float()).sum(-1)
            fused = [torch.full_like(delta, float("nan")) for _ in range(2)]
            dq2 = [fa._launch_dq(q, k, v, g, lse, d, causal, o=o)
                   for d in fused]
            torch.cuda.synchronize()
            row["rel_norm_delta"] = ((fused[0] - delta).norm()
                                     / delta.norm()).item()
            row["k2_bitwise_equal"] = torch.equal(dq2[0], dq2[1]) \
                and torch.equal(fused[0], fused[1]) and torch.equal(dq2[0], dq)
            ok = ok and row["rel_norm_delta"] <= TOL_DELTA \
                and row["k2_bitwise_equal"]
            if (b, h, kvh, s, hd) == K23_MAIN_SHAPE and causal:
                # the fp32-dq variant (the ring-hop backward's: delta read)
                # at one shape
                dq32 = fa._launch_dq(q, k, v, g, lse, delta, causal,
                                     dq_fp32=True)
                ref32 = fa._flash_bwd_reference(q.float(), k, v, o, lse, g,
                                                causal)[0]
                _, rel_norm, rel_max = _grad_errors(dq32, ref32)
                row["rel_norm_dq_fp32"] = rel_norm
                ok = ok and dq32.dtype == torch.float32 and bool(
                    torch.isfinite(dq32).all()) and rel_norm <= TOL_GRAD_NORM \
                    and rel_max <= TOL_GRAD_MAX
            # K2 as the training path launches it: delta computed and written
            row["k2_ms"] = _time_ms(
                lambda: fa._launch_dq(q, k, v, g, lse, fused[0], causal, o=o))
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
                row[f"{name}_frac_of_bound"] = bms / row[f"{name}_ms"]
            # SDPA's backward does K2's and K3's work in one call
            row["x_library"] = (row["k2_ms"] + row["k3_ms"]) \
                / row["sdpa_bwd_ms"]
            rows.append(row)
            print(json.dumps({"k23": row}), flush=True)
            _check(ok, f"K2/K3 outside ||err||/||ref|| <= {TOL_GRAD_NORM}, "
                   f"max|err| <= {TOL_GRAD_MAX} max|ref|, delta beyond "
                   f"{TOL_DELTA}, two K2 launches unequal or not finite: "
                   f"{row}")
    return rows


# (b, h, kvh, s, hd) of the ring-hop checks (K4, K5), sq = sk = s: the
# training ring's hop first (the flagship's heads, 8192 tokens over sp 4),
# then Llama-3-8B's heads
HOP_SHAPES = [(1, 8, 4, 2048, 128), (1, 32, 8, 512, 128)]
HOP_MAIN_SHAPE = HOP_SHAPES[0]
TOL_M = 1e-3               # K4's running max, absolute (fp32 throughout)
TOL_L_REL = 1e-2           # K4's denominator, relative


def _k4_bound(b, h, kvh, s, hd, causal):
    """(bound_ms, bound_by, flops, bytes) for one K4 call: QK^T and PV over
    the s(s+1)/2 pairs the causal mask keeps; q, k, v (bf16) and o, m, l
    (fp32) read once, the new o, m, l written once."""
    pairs = s * (s + 1) / 2 if causal else s * s
    flops = 4.0 * b * h * hd * pairs
    nbytes = 2.0 * (b * h * s * hd + 2 * b * kvh * s * hd) \
        + 2 * 4.0 * (b * h * s * hd + 2 * b * h * s)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, flops, nbytes


def _hop_inputs(dev, gen, b, h, kvh, s, hd):
    """Seeded bf16 q, k, v, dO of one hop, a second K/V block, and the fresh
    ring state (o = l = 0, m = -inf)."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q, k, v, g = (randn(b, h, s, hd), randn(b, kvh, s, hd),
                  randn(b, kvh, s, hd), randn(b, h, s, hd))
    k0, v0 = randn(b, kvh, s, hd), randn(b, kvh, s, hd)
    fresh = (torch.zeros((b, h, s, hd), device=dev),
             torch.full((b, h, s, 1), float("-inf"), device=dev),
             torch.zeros((b, h, s, 1), device=dev))
    return q, k, v, g, k0, v0, fresh


def phase_k4(dev):
    """K4 against ``_chunk_xla`` on the same bf16 inputs, FULL (causal
    False) and DIAG (causal True) hops, from a fresh state and from one a
    previous plain hop carried."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for (b, h, kvh, s, hd) in HOP_SHAPES:
        q, k, v, _, k0, v0, fresh = _hop_inputs(dev, gen, b, h, kvh, s, hd)
        carried = fa._chunk_xla(q, k0, v0, *fresh, False)
        for state_name, state in (("fresh", fresh), ("carried", carried)):
            for causal in (False, True):
                before = [t.clone() for t in state]
                o, m, l = fa._flash_chunk_cuda(q, k, v, *state, causal)
                torch.cuda.synchronize()
                ro, rm, rl = fa._chunk_xla(q, k, v, *state, causal)
                untouched = all(torch.equal(x, y)
                                for x, y in zip(before, state))
                finite = all(bool(torch.isfinite(t).all()) for t in (o, m, l))
                # o is un-normalised (it grows with l): K1's rule holds the
                # attention output o / l
                # and, as K2/K3's gates do, ||err|| / ||ref|| on it: the
                # elementwise rule's 2e-2 is near a typical |o/l| here
                out, rout = o / l, ro / rl
                rel_norm_o = ((out - rout).norm() / rout.norm()).item()
                o_ok = bool(((out - rout).abs()
                             <= TOL_O + TOL_O_REL * rout.abs()).all()) \
                    and rel_norm_o <= TOL_GRAD_NORM
                err_m = (m - rm).abs().max().item()
                rel_l = ((l - rl).abs() / rl.abs()).max().item()
                row = dict(b=b, h=h, kvh=kvh, s=s, hd=hd, causal=causal,
                           state=state_name,
                           err_o=(out - rout).abs().max().item(),
                           rel_norm_o=rel_norm_o,
                           err_o_unnormalised=(o - ro).abs().max().item(),
                           err_m=err_m, rel_err_l=rel_l)
                row["ms"] = _time_ms(
                    lambda: fa._flash_chunk_cuda(q, k, v, *state, causal))
                row["plain_ms"] = _time_ms(
                    lambda: fa._chunk_xla(q, k, v, *state, causal), iters=5)
                # the yardstick: SDPA's forward on the same q, k, v (it
                # carries no state, so it does a little less work)
                row["sdpa_ms"] = _time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=kvh != h))
                bms, by, flops, nbytes = _k4_bound(b, h, kvh, s, hd, causal)
                row.update(bound_ms=bms, bound_by=by,
                           frac_of_bound=bms / row["ms"],
                           x_library=row["ms"] / row["sdpa_ms"],
                           tflops=flops / (row["ms"] * 1e-3) / 1e12)
                rows.append(row)
                print(json.dumps({"k4": row}), flush=True)
                _check(untouched, f"K4 wrote over its input state: {row}")
                _check(finite and o_ok and err_m <= TOL_M
                       and rel_l <= TOL_L_REL,
                       f"K4 disagrees with _chunk_xla beyond o/l {TOL_O} + "
                       f"{TOL_O_REL}|o/l| and ||err||/||ref|| "
                       f"{TOL_GRAD_NORM}, m {TOL_M}, l {TOL_L_REL} relative, "
                       f"or not finite: {row}")
    # the diagonal hop does half the products: its time over the unmasked
    # hop's, per shape and state (printed, not gated)
    ratios = {}
    for r in rows:
        if r["causal"]:
            full = next(f for f in rows if not f["causal"] and all(
                f[k] == r[k] for k in ("b", "h", "kvh", "s", "hd", "state")))
            ratios[f"b{r['b']} h{r['h']} kvh{r['kvh']} s{r['s']} "
                   f"hd{r['hd']} {r['state']}"] = r["ms"] / full["ms"]
    print(json.dumps({"k4_diag_over_full": ratios}), flush=True)
    return rows


def phase_k5(dev):
    """K5 (``flash_hop_bwd``: K2 with an fp32 dq, K3 with fp32 dk/dv)
    against ``_hop_bwd_xla`` on one hop, causal and not, with the global
    lse and delta of a two-hop plain ring forward."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for (b, h, kvh, s, hd) in HOP_SHAPES:
        q, k, v, g, k0, v0, fresh = _hop_inputs(dev, gen, b, h, kvh, s, hd)
        first = fa._chunk_xla(q, k0, v0, *fresh, False)
        for causal in (True, False):
            o, m, l = fa._chunk_xla(q, k, v, *first, causal)
            lse = m + torch.log(l)
            out = (o / l).bfloat16()
            delta = (g.float() * out.float()).sum(-1, keepdim=True)
            got = fa.flash_hop_bwd(q, k, v, g, lse, delta, causal)
            torch.cuda.synchronize()
            ref = fa._hop_bwd_xla(q, k, v, g, lse, delta, causal)
            row = dict(b=b, h=h, kvh=kvh, s=s, hd=hd, causal=causal)
            ok = True
            for name, x, want in zip(("dq", "dk", "dv"), got, ref):
                mx, rel_norm, rel_max = _grad_errors(x, want)
                row[f"err_{name}"] = mx
                row[f"rel_norm_{name}"] = rel_norm
                row[f"rel_max_{name}"] = rel_max
                ok = ok and x.dtype == torch.float32 \
                    and bool(torch.isfinite(x).all()) \
                    and rel_norm <= TOL_GRAD_NORM and rel_max <= TOL_GRAD_MAX
            row["k5a_ms"] = _time_ms(lambda: fa._launch_dq(
                q, k, v, g, lse, delta, causal, dq_fp32=True))
            row["k5b_ms"] = _time_ms(lambda: fa._launch_dkv(
                q, k, v, g, lse, delta, causal, dkv_fp32=True))
            row["plain_ms"] = _time_ms(lambda: fa._hop_bwd_xla(
                q, k, v, g, lse, delta, causal), iters=3, warmup=1)
            # the yardstick: SDPA's backward on the hop block (its own
            # softmax, not the ring's global rows)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            sd = F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=kvh != h)
            row["sdpa_bwd_ms"] = _time_ms(lambda: torch.autograd.grad(
                sd, (qs, ks, vs), g, retain_graph=True))
            del sd, qs, ks, vs
            for name, (bms, by, flops, _) in _k23_bounds(
                    b, h, kvh, s, hd, causal, grad_bytes=4,
                    fused_delta=False).items():
                key = {"k2": "k5a", "k3": "k5b"}[name]
                row[f"{key}_bound_ms"] = bms
                row[f"{key}_bound_by"] = by
                row[f"{key}_tflops"] = flops / (row[f"{key}_ms"] * 1e-3) / 1e12
                row[f"{key}_frac_of_bound"] = bms / row[f"{key}_ms"]
            row["x_library"] = (row["k5a_ms"] + row["k5b_ms"]) \
                / row["sdpa_bwd_ms"]
            rows.append(row)
            print(json.dumps({"k5": row}), flush=True)
            _check(ok, f"K5 outside ||err||/||ref|| <= {TOL_GRAD_NORM}, "
                   f"max|err| <= {TOL_GRAD_MAX} max|ref|, not fp32 or not "
                   f"finite: {row}")
    # the diagonal hop does half of K5b's products: its time over the
    # unmasked hop's, per shape (printed, not gated)
    ratios = {}
    for r in rows:
        if r["causal"]:
            full = next(f for f in rows if not f["causal"] and all(
                f[k] == r[k] for k in ("b", "h", "kvh", "s", "hd")))
            ratios[f"b{r['b']} h{r['h']} kvh{r['kvh']} s{r['s']} "
                   f"hd{r['hd']}"] = r["k5b_ms"] / full["k5b_ms"]
    print(json.dumps({"k5b_diag_over_full": ratios}), flush=True)
    return rows


# inputs the kernels do not take, (dtype, head_dim) at b1 h8 kvh4 s256:
# fp32 at head_dim 64 and bf16 at head_dim 32 (``LlamaConfig.tiny``'s)
ROUTE_CASES = (("fp32", 64), ("bf16", 32))
ROUTE_SHAPE = (1, 8, 4, 256)
# and bf16 views at head_dim 128, which the kernels take through copies
ROUTE_VIEW_HD = 128
# ||err|| / ||ref||: the same plain ops, or the same deterministic kernels,
# on the same values
TOL_ROUTE = 1e-5


def phase_route(dev):
    """The three public entries (``flash_attention_bhsd``,
    ``flash_chunk_bhsd``, ``flash_hop_bwd``) on CUDA inputs the kernels do
    not take, forward and backward: no kernel launches, and the results of
    the plain versions they route to, on the card. Then the same entries on
    bf16 views the kernels do take (head_dim ``ROUTE_VIEW_HD``): they launch,
    through ``_kernel_input``'s copies, and give what they give on
    contiguous copies of the same values."""
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    b, h, kvh, s = ROUTE_SHAPE

    def grads(fn, inputs, cots):
        xs = [t.detach().requires_grad_() for t in inputs]
        out = fn(*xs)
        outs = list(out) if isinstance(out, tuple) else [out]
        return outs + list(torch.autograd.grad(outs, xs, cots))

    def rel_err(got, want):
        return max(((x.float() - w.float()).norm()
                    / w.float().norm().clamp_min(1e-30)).item()
                   for x, w in zip(got, want))

    for dt_name, hd in ROUTE_CASES + (("bf16", ROUTE_VIEW_HD),):
        dt = getattr(torch, {"fp32": "float32", "bf16": "bfloat16"}[dt_name])
        views = hd == ROUTE_VIEW_HD

        def randn(*shape, dtype=dt):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q, g = randn(b, h, s, hd), randn(b, h, s, hd)
        k, v = randn(b, kvh, s, hd), randn(b, kvh, s, hd)
        f32 = torch.float32
        state = (randn(b, h, s, hd, dtype=f32), randn(b, h, s, 1, dtype=f32),
                 randn(b, h, s, 1, dtype=f32).abs() + 1)
        cot = (randn(b, h, s, hd, dtype=f32), randn(b, h, s, 1, dtype=f32),
               randn(b, h, s, 1, dtype=f32))
        lse, delta = randn(b, h, s, 1, dtype=f32), randn(b, h, s, 1, dtype=f32)
        if views:
            _route_views(fa, grads, rel_err, rows, (q, k, v, g), state,
                         cot, lse, delta)
            continue

        def attn_ref(q, k, v):
            return fa._attention_reference(q, k, v, True)[0]

        cases = {
            "flash_attention_bhsd": (
                lambda: grads(lambda *a: fa.flash_attention_bhsd(*a, True),
                              (q, k, v), (g,)),
                # the plain forward and, as the entry's backward does, the
                # plain backward on its o and lse
                lambda: [attn_ref(q, k, v)] + list(fa._flash_bwd_reference(
                    q, k, v, *fa._attention_reference(q, k, v, True), g,
                    True))),
            "flash_chunk_bhsd": (
                lambda: grads(lambda *a: fa.flash_chunk_bhsd(*a, True),
                              (q, k, v) + state, cot),
                lambda: grads(lambda *a: fa._chunk_xla(*a, True),
                              (q, k, v) + state, cot)),
            "flash_hop_bwd": (
                lambda: list(fa.flash_hop_bwd(q, k, v, g, lse, delta, True)),
                lambda: list(fa._hop_bwd_xla(q, k, v, g, lse, delta, True))),
        }
        for entry, (run, plain) in cases.items():
            _zero_launches(fa)
            got = run()
            torch.cuda.synchronize()
            launches = _read_launches(fa)
            want = plain()
            rel = rel_err(got, want)
            row = dict(entry=entry, dtype=dt_name, hd=hd,
                       kernel_takes=fa._kernel_takes(q, k, v),
                       launches=launches, n_results=len(got),
                       rel_norm_err=rel)
            rows.append(row)
            print(json.dumps({"route": row}), flush=True)
            _check(not row["kernel_takes"]
                   and not any(launches.values())
                   and len(got) == len(want)
                   and all(bool(torch.isfinite(x).all()) for x in got)
                   and rel <= TOL_ROUTE,
                   f"{entry} on {dt_name} hd {hd}: launched a kernel or "
                   f"differs from its plain version beyond ||err||/||ref|| "
                   f"{TOL_ROUTE}: {row}")
    # an empty batch the kernels would take (a pipeline microbatch of which
    # a data rank holds no row): no launch, empty results of its shapes
    q, k, v, g = (torch.zeros((0, n, s, ROUTE_VIEW_HD), device=dev,
                              dtype=torch.bfloat16) for n in (h, kvh, kvh, h))
    _zero_launches(fa)
    got = grads(lambda *a: fa.flash_attention_bhsd(*a, True), (q, k, v),
                (g,))
    torch.cuda.synchronize()
    row = dict(entry="flash_attention_bhsd", dtype="bf16", hd=ROUTE_VIEW_HD,
               batch=0, launches=_read_launches(fa),
               shapes=[tuple(x.shape) for x in got])
    rows.append(row)
    print(json.dumps({"route": row}), flush=True)
    _check(not any(row["launches"].values()) and row["shapes"] == [
        tuple(t.shape) for t in (q, q, k, v)],
        f"an empty batch launched a kernel or lost its shape: {row}")
    return rows


def _view(t, how):
    """A view of ``t``'s values: "transposed" (the transpose of a (b, s,
    h, hd) tensor: not contiguous) or "offset" (contiguous, one element
    into its storage: not 16-byte aligned)."""
    import torch

    if how == "transposed":
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = flat[1:t.numel() + 1].view(t.shape)
    view.copy_(t)
    return view


def _route_views(fa, grads, rel_err, rows, qkvg, state, cot, lse, delta):
    """The route phase's bf16 views (q and dO transposed, k and v at an odd
    offset) through the three entries: each entry's kernels launch, and its
    results equal the same entry's on the contiguous tensors."""
    import torch

    q, k, v, g = qkvg
    qv, kv, vv, gv = (_view(t, "offset" if i in (1, 2) else "transposed")
                      for i, t in enumerate(qkvg))
    cases = {
        "flash_attention_bhsd": (
            lambda q, k, v, g: grads(
                lambda *a: fa.flash_attention_bhsd(*a, True), (q, k, v), (g,)),
            ("k1", "k2", "k3")),
        "flash_chunk_bhsd": (
            lambda q, k, v, g: grads(
                lambda *a: fa.flash_chunk_bhsd(*a, True), (q, k, v) + state,
                cot),
            ("k4",)),
        "flash_hop_bwd": (
            lambda q, k, v, g: list(fa.flash_hop_bwd(q, k, v, g, lse, delta,
                                                     True)),
            ("k2", "k3")),
    }
    for entry, (run, kernels) in cases.items():
        _zero_launches(fa)
        got = run(qv, kv, vv, gv)
        torch.cuda.synchronize()
        launches = _read_launches(fa)
        want = run(q, k, v, g)
        rel = rel_err(got, want)
        row = dict(entry=entry, dtype="bf16", hd=ROUTE_VIEW_HD,
                   inputs="views", kernel_takes=fa._kernel_takes(qv, kv, vv),
                   launches=launches, n_results=len(got), rel_norm_err=rel)
        rows.append(row)
        print(json.dumps({"route": row}), flush=True)
        _check(row["kernel_takes"]
               and all(launches[n] > 0 for n in kernels)
               and len(got) == len(want)
               and all(bool(torch.isfinite(x).all()) for x in got)
               and rel <= TOL_ROUTE,
               f"{entry} on bf16 views: its kernels {kernels} did not launch "
               f"or differ from their run on contiguous tensors beyond "
               f"||err||/||ref|| {TOL_ROUTE}: {row}")


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


def _train_tokens(dev):
    """The train phase's global batch: TRAIN_BATCH x TRAIN_SEQ seeded
    tokens (the shard phase trains on the same)."""
    import numpy as np
    import torch

    return torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, TRAIN_CFG["vocab_size"], size=(TRAIN_BATCH, TRAIN_SEQ))).to(dev)


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
    tokens = _train_tokens(data_dev)
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
    out["bwd_call"] = _bwd_call_kernels(dev, cfg)
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
    _check(not out["bwd_call"]["delta_pass"],
           f"the flash backward launched kernels besides K2 and K3: "
           f"{out['bwd_call']}")
    _check(abs(lf - lx) <= TOL_LOSS_REL * abs(lx),
           f"flash vs xla loss {lf} vs {lx} beyond {TOL_LOSS_REL} relative")
    _check(min(cos.values()) >= GRAD_COS_MIN,
           f"flash vs xla gradient cosine below {GRAD_COS_MIN}: {cos}")
    return out


def _train_profile(train_step, state, *batch):
    """One train step on ``batch`` under torch.profiler: host wall time
    against the device time of its kernels, so the device's idle share,
    and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        train_step(state, *batch)
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
               # K1 (hattn::attn_fwd), K2, K3 (and their launches) in this step
               flash_kernels={e.key[:60]: [e.self_device_time_total / 1e3,
                                           e.count]
                              for e in kernels
                              if "flash_" in e.key or "attn_fwd" in e.key})
    if dev_ms > 0:
        out["device_idle_share"] = 1.0 - dev_ms / host_ms
    return out


def _bwd_call_kernels(dev, cfg):
    """The CUDA kernels, by name and count, that one flash backward
    (``_flash_bwd_cuda``) launches at the train phase's attention shape
    under torch.profiler: K2 and K3, and in ``delta_pass`` any other (the
    eager rowsum of dO * o, where delta is not computed by K2)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    hd = cfg.dim // cfg.n_heads

    def randn(heads):
        return torch.randn((TRAIN_BATCH, heads, TRAIN_SEQ, hd),
                           generator=gen, device=dev).bfloat16()

    q, g, k, v = (randn(cfg.n_heads), randn(cfg.n_heads),
                  randn(cfg.n_kv_heads), randn(cfg.n_kv_heads))
    o, lse = fa._flash_fwd_cuda(q, k, v, True)
    fa._flash_bwd_cuda(q, k, v, o, lse, g, True)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fa._flash_bwd_cuda(q, k, v, o, lse, g, True)
        torch.cuda.synchronize()
    kernels = {e.key[:80]: e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")}
    if not kernels:
        return dict(kernels="not measured", delta_pass={})
    return dict(kernels=kernels, delta_pass={
        name: n for name, n in kernels.items()
        if "flash_bwd_dq_kernel" not in name
        and "flash_bwd_dkv_kernel" not in name})


# the sequence-parallel path: 4 ranks on the mesh's sp axis. One card takes
# them as 4 processes over a gloo group (NCCL refuses two ranks on one
# GPU), with every collective staged through host memory: the kernels and
# the ring run on the card at full width, but the ranks time-slice it, so
# a time here is no speed of the ring.
RING_SP = 4
RING_LABEL = "4 ranks time-sliced on one card, gloo through host"
RING_ATTN = (1, 8, 4, 32768, 128)  # b, h, kvh, s, hd: the flagship's heads
RING_ATTN_IMPLS = ("ring", "ulysses", "flash")
RING_TRAIN_BATCH, RING_TRAIN_SEQ, RING_TRAIN_STEPS = 1, 8192, 3
RING_TIMEOUT_S = 600
GLOO_TIMEOUT_S = 300


def _ring_attention_inputs(dev):
    """The seeded global bf16 q, k, v, dO (b, s, h, hd) of the attention
    check: the same tensors in every process on the card."""
    import torch

    b, h, kvh, s, hd = RING_ATTN
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    return tuple(torch.randn((b, s, n, hd), generator=gen, device=dev)
                 .bfloat16() for n in (h, kvh, kvh, h))


def _ring_train_tokens(dev):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.RandomState(SEED + 7).randint(
        0, TRAIN_CFG["vocab_size"],
        size=(RING_TRAIN_BATCH, RING_TRAIN_SEQ))).to(dev)


def _zero_launches(fa):
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = fa.flash_chunk_launches = 0


def _read_launches(fa):
    return dict(k1=fa.flash_fwd_launches, k2=fa.flash_bwd_dq_launches,
                k3=fa.flash_bwd_dkv_launches, k4=fa.flash_chunk_launches)


def _errors_against(got, want):
    """What the parent needs to hold a shard against its reference: max
    |err|, max |ref|, the sums of squares, and K1's output rule."""
    got, want = got.float(), want.float()
    err = got - want
    return dict(max_err=err.abs().max().item(),
                max_ref=want.abs().max().item(),
                sq_err=err.square().sum().item(),
                sq_ref=want.square().sum().item(),
                o_rule=bool((err.abs() <= TOL_O + TOL_O_REL * want.abs())
                            .all()),
                finite=bool(got.isfinite().all()))


def _ring_rank_attention(dev, mesh, impl):
    """``impl``'s sharded attention forward and backward on this rank's
    shard of the seeded inputs (causal), launches counted from zero around
    it; then this shard of the whole-sequence ``flash_attention`` (K1, K2,
    K3) on the same inputs, to hold it against. "flash" is the model's
    ``attention`` with ``attention_impl="flash"`` on the sp mesh: the
    kernels on the all-gathered sequence."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, attention
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.mesh import axis_index
    from ray_tpu_torch.parallel.ring_attention import ring_attention_sharded
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    def flash_on_sp(q, k, v, mesh, causal):
        return attention(LlamaConfig(attention_impl="flash"), q, k, v, mesh)

    fn = {"ring": ring_attention_sharded,
          "ulysses": ulysses_attention_sharded, "flash": flash_on_sp}[impl]
    q, k, v, g = _ring_attention_inputs(dev)
    n = q.shape[1] // RING_SP
    idx = axis_index(mesh, "sp")
    cut = slice(idx * n, (idx + 1) * n)
    qs, ks, vs = (t[:, cut].contiguous().requires_grad_() for t in (q, k, v))
    torch.cuda.synchronize()
    _zero_launches(fa)
    t = time.monotonic()
    out = fn(qs, ks, vs, mesh, causal=True)
    out.backward(g[:, cut].contiguous())
    torch.cuda.synchronize()
    ms = (time.monotonic() - t) * 1e3
    launches = _read_launches(fa)
    qf, kf, vf = (t.detach().requires_grad_() for t in (q, k, v))
    ref = flash_attention(qf, kf, vf, causal=True)
    ref.backward(g)
    return dict(ms=ms, launches=launches, errors={
        name: _errors_against(x, w[:, cut]) for name, x, w in (
            ("out", out, ref), ("dq", qs.grad, qf.grad),
            ("dk", ks.grad, kf.grad), ("dv", vs.grad, vf.grad))})


def _ring_rank_train(dev, mesh):
    """``make_train_step`` on the flagship with "ring" on the sp mesh: one
    warm-up step, then RING_TRAIN_STEPS with the launches counted from
    zero."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.ops import flash_attention as fa

    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="ring")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, mesh, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _ring_train_tokens(data_dev)
    state, loss = train_step(state, tokens)  # warm-up
    losses = [float(loss)]
    torch.cuda.synchronize()
    _zero_launches(fa)
    t = time.monotonic()
    for _ in range(RING_TRAIN_STEPS):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
    torch.cuda.synchronize()
    return dict(losses=losses, launches=_read_launches(fa),
                step_ms=(time.monotonic() - t) * 1e3 / RING_TRAIN_STEPS,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def _ring_rank(dev, mesh):
    """One rank of the sp mesh: the attention checks, then the training
    run."""
    import torch

    out = {impl: _ring_rank_attention(dev, mesh, impl)
           for impl in RING_ATTN_IMPLS}
    torch.cuda.empty_cache()
    out["train"] = _ring_rank_train(dev, mesh)
    return out


def _rank_main(rank, world, store, device, mesh_axes, work, args, results):
    """One rank process of a multi-rank phase on ``device`` (every rank on
    the one card): joins the gloo group of ``world`` ranks, builds
    ``MeshSpec(**mesh_axes)``, runs ``work(dev, mesh, *args)`` and puts its
    result (or its traceback) on ``results``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshSpec

    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        mesh = MeshSpec(**mesh_axes).build()
        results.put((rank, True, work(dev, mesh, *args)))
    except Exception:  # the parent fails the run with this traceback
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(dev, name, mesh_axes, work, *args):
    """``work(dev, mesh, *args)`` in one process a position of
    ``MeshSpec(**mesh_axes)``, all on the card ``dev``: their results in
    rank order. A rank that fails, or no result within
    ``RING_TIMEOUT_S``, fails the run; every process is ended before this
    returns."""
    import multiprocessing
    import queue
    import shutil
    import tempfile

    world = math.prod(mesh_axes.values())
    ctx = multiprocessing.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, os.path.join(store_dir, "store"), str(dev), mesh_axes,
        work, args, results)) for r in range(world)]
    for p in procs:
        p.start()
    ranks, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, ok, value = results.get(timeout=RING_TIMEOUT_S)
            except queue.Empty:
                errors.append(f"no result in {RING_TIMEOUT_S} s")
                break
            if ok:
                ranks[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
                break
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(store_dir, ignore_errors=True)
    _check(not errors, f"{name} phase: a rank failed:\n" + "\n".join(errors))
    return [ranks[r] for r in range(world)]


def _flash_train_losses(dev):
    """The single-process reference: the same seed, batch and steps with
    attention_impl="flash"."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step

    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _ring_train_tokens(data_dev)
    losses = []
    for _ in range(1 + RING_TRAIN_STEPS):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
    del state
    torch.cuda.empty_cache()
    return losses


def phase_ring(dev):
    """The sequence-parallel path on 4 ranks (``RING_LABEL``): ring,
    Ulysses and the model's "flash" attention on the mesh at full width
    against the whole-sequence flash attention, K1-K4 launches counted;
    then the flagship trained on sp 4 with "ring" against a single-process
    "flash" run."""
    import numpy as np

    flash_losses = _flash_train_losses(dev)
    t0 = time.monotonic()
    ranks = _run_ranks(dev, "ring", dict(sp=RING_SP), _ring_rank)
    out = dict(label=RING_LABEL, ranks=RING_SP, wall_s=time.monotonic() - t0)

    b, h, kvh, s, hd = RING_ATTN
    for impl in RING_ATTN_IMPLS:
        per = [ranks[r][impl] for r in range(RING_SP)]
        launches = {k: sum(p["launches"][k] for p in per)
                    for k in per[0]["launches"]}
        row = dict(shape=dict(b=b, h=h, kvh=kvh, s=s, hd=hd, sp=RING_SP),
                   ms_per_rank=[p["ms"] for p in per], launches=launches,
                   launches_per_rank=[p["launches"] for p in per])
        ok = True
        for name in ("out", "dq", "dk", "dv"):
            e = [p["errors"][name] for p in per]
            mx = max(x["max_err"] for x in e)
            rel_norm = (sum(x["sq_err"] for x in e)
                        / sum(x["sq_ref"] for x in e)) ** 0.5
            rel_max = mx / max(x["max_ref"] for x in e)
            row[f"err_{name}"], row[f"rel_norm_{name}"] = mx, rel_norm
            row[f"rel_max_{name}"] = rel_max
            ok = ok and all(x["finite"] for x in e)
            if name == "out":
                ok = ok and all(x["o_rule"] for x in e) \
                    and rel_norm <= TOL_GRAD_NORM
            else:
                ok = ok and rel_norm <= TOL_GRAD_NORM \
                    and rel_max <= TOL_GRAD_MAX
        out[impl] = row
        print(json.dumps({f"ring_attention_{impl}": row}), flush=True)
        _check(ok, f"{impl} attention on sp {RING_SP} disagrees with the "
               f"whole-sequence flash attention beyond K1's rule and "
               f"||err||/||ref|| {TOL_GRAD_NORM} (out) or K2-K3's gates: "
               f"{row}")
        # ring: rank idx runs idx + 1 non-skipped hops each way; Ulysses
        # and "flash" one flash attention a rank
        want = (dict(k1=0, k2=10, k3=10, k4=10) if impl == "ring"
                else dict(k1=RING_SP, k2=RING_SP, k3=RING_SP, k4=0))
        _check(launches == want, f"{impl} launches {launches}, want {want}")

    per = [ranks[r]["train"] for r in range(RING_SP)]
    losses = per[0]["losses"]
    launches = {k: sum(p["launches"][k] for p in per)
                for k in per[0]["launches"]}
    hops = RING_SP * (RING_SP + 1) // 2  # non-skipped hops over the ranks
    layers = TRAIN_CFG["n_layers"]
    train = dict(
        config=dict(TRAIN_CFG, attention_impl="ring", remat=TRAIN_REMAT,
                    loss_chunk=0, batch=RING_TRAIN_BATCH, seq=RING_TRAIN_SEQ,
                    sp=RING_SP, lr=TRAIN_LR),
        losses=losses, flash_losses=flash_losses,
        loss_rel_diff=[abs(a - b) / abs(b)
                       for a, b in zip(losses, flash_losses)],
        step_ms=[p["step_ms"] for p in per], step_ms_label=RING_LABEL,
        peak_memory_gb=[p["peak_memory_gb"] for p in per],
        launches=launches,
        launches_per_step={k: v / RING_TRAIN_STEPS
                           for k, v in launches.items()})
    out["train"] = train
    print(json.dumps({"ring_train": train}), flush=True)
    print(f"ring train step: {max(train['step_ms']):.1f} ms ({RING_LABEL})",
          flush=True)
    _check(all(p["losses"] == losses for p in per),
           f"the ranks disagree on the loss: {[p['losses'] for p in per]}")
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"ring train losses not finite and falling: {losses}")
    _check(max(train["loss_rel_diff"]) <= TOL_LOSS_REL,
           f"ring vs flash losses beyond {TOL_LOSS_REL} relative: {losses} "
           f"vs {flash_losses}")
    # K4 twice a layer and hop (forward and the "dots" recompute), K2 / K3
    # once
    want = dict(k1=0, k2=layers * hops * RING_TRAIN_STEPS,
                k3=layers * hops * RING_TRAIN_STEPS,
                k4=2 * layers * hops * RING_TRAIN_STEPS)
    _check(launches == want, f"ring train launches {launches} in "
           f"{RING_TRAIN_STEPS} steps, want {want}")
    return out


SHARD_MESH = dict(fsdp=2, tp=2)
SHARD_LABEL = "4 ranks time-sliced on one card, gloo through host"
SHARD_STEPS = 2            # timed, after one warm-up step
TOL_SHARD_LOSS = 1e-2      # absolute, each step against one device
TOL_SHARD_PARAM = 1e-2     # ||err|| / ||ref|| of each leaf after step one
# ||err|| / ||ref|| of each leaf's step-one gradient: AdamW's first update
# is about sign(g), blind to a gradient scaled by a constant; a gradient
# counted twice (over tp, or over fsdp once too many) gives 1
TOL_SHARD_GRAD = 5e-2
TOL_SHARD_BYTES = 1e-2     # a rank's parameters + moments vs a quarter


def _shard_reference(dev, path):
    """The single-device run the shard and pipe phases are held to:
    "flash" on the same seed, batch, lr and remat, 1 + SHARD_STEPS steps;
    the first step's gradients and the parameters after it saved to
    ``path`` (nested host copies). Returns the losses."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig, make_train_step
    from ray_tpu_torch.parallel.mesh import tree_map

    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _train_tokens(data_dev)
    losses = []
    for step in range(1 + SHARD_STEPS):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
        if step == 0:
            torch.save(dict(
                params=tree_map(lambda t: t.detach().cpu(), state[0]),
                grads=tree_map(lambda t: t.grad.cpu(), state[0])), path)
    del state
    torch.cuda.empty_cache()
    return losses


def _shard_rank(dev, mesh, ref_path):
    """One rank of the fsdp 2 x tp 2 mesh: the flagship's train step on
    this rank's shards, one warm-up step (after which its gathered
    gradients and the gathered parameters are held to ``ref_path``'s on
    rank 0) and SHARD_STEPS timed steps with the launches counted from zero
    and the shapes of the attention calls recorded."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.models.llama import (LlamaConfig, gather_state,
                                            make_train_step, param_specs)
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import gather_full, tree_leaves, tree_map

    shapes = set()

    def recording(launch):
        def wrapped(q, k, *args):
            shapes.add((tuple(q.shape), tuple(k.shape)))
            return launch(q, k, *args)
        return wrapped

    # the kernels' launchers (K1; K2 and K3), as _FlashAttn calls them
    fa._flash_fwd_cuda = recording(fa._flash_fwd_cuda)
    fa._flash_bwd_cuda = recording(fa._flash_bwd_cuda)
    # host seconds, calls and bytes sent (each call's input) in the gloo
    # collectives, on tensors already staged to the host; waiting for a
    # slower peer included
    comm = dict(s=0.0, calls=0, bytes=0)

    def timed(collective, arg):
        def wrapped(*args, **kwargs):
            t0 = time.monotonic()
            try:
                return collective(*args, **kwargs)
            finally:
                comm["s"] += time.monotonic() - t0
                comm["calls"] += 1
                comm["bytes"] += args[arg].numel() * args[arg].element_size()
        return wrapped

    for name, arg in (("all_reduce", 0), ("all_gather", 1),
                      ("all_to_all_single", 1)):
        setattr(dist, name, timed(getattr(dist, name), arg))
    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, mesh, learning_rate=TRAIN_LR, remat=TRAIN_REMAT, loss_chunk=0,
        device=dev)
    state = shard_state(init_state(SEED))
    tokens = _train_tokens(data_dev)
    state, loss = train_step(state, tokens)  # warm-up
    losses = [float(loss)]
    params, opt = state
    state_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params)) + sum(
        v.numel() * v.element_size() for moments in opt.state.values()
        for v in moments.values() if torch.is_tensor(v) and v.dim())
    # every rank takes part in both gathers
    full = gather_state(cfg, state, mesh)
    grads = tree_map(lambda t, spec: gather_full(t.grad, spec, mesh),
                     params, param_specs(cfg))
    leaf_errors = grad_errors = None
    if dist.get_rank() == 0:
        ref = torch.load(ref_path, map_location="cpu", mmap=True,
                         weights_only=True)

        def rel_err(got, want):
            want = want.to(got.device)
            return ((got - want).norm() / want.norm()).item()

        leaf_errors = tree_map(rel_err, full, ref["params"])
        grad_errors = tree_map(rel_err, grads, ref["grads"])
    del full, grads
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    _zero_launches(fa)
    shapes.clear()
    comm.update(s=0.0, calls=0, bytes=0)
    t = time.monotonic()
    for _ in range(SHARD_STEPS):
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
    torch.cuda.synchronize()
    return dict(losses=losses, launches=_read_launches(fa),
                shapes=sorted(shapes),
                step_s=(time.monotonic() - t) / SHARD_STEPS,
                collectives_per_step={k: v / SHARD_STEPS
                                      for k, v in comm.items()},
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                state_bytes=state_bytes, leaf_errors=leaf_errors,
                grad_errors=grad_errors)


def phase_shard(dev, ref):
    """Sharded training on fsdp 2 x tp 2 (``SHARD_LABEL``): the flagship at
    full width and depth with "flash" and remat "dots" on b8 x 2048, each
    rank on its quarter of the parameters and moments, K1-K3 on its 4 of
    the 8 heads and 4 of the 8 rows; held to a single-device "flash" run
    from the same seed on the same batch (``ref``: the path and losses of
    ``_shard_reference``)."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import tree_leaves

    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    ref_path, ref_losses = ref
    t0 = time.monotonic()
    per = _run_ranks(dev, "shard", SHARD_MESH, _shard_rank, ref_path)
    wall_s = time.monotonic() - t0
    world = math.prod(SHARD_MESH.values())
    rows = TRAIN_BATCH // SHARD_MESH["fsdp"]
    tp = SHARD_MESH["tp"]
    hd = cfg.head_dim
    want_shape = [((rows, cfg.n_heads // tp, TRAIN_SEQ, hd),
                   (rows, cfg.n_kv_heads // tp, TRAIN_SEQ, hd))]
    want_launches = dict(k1=2 * cfg.n_layers * SHARD_STEPS,
                         k2=cfg.n_layers * SHARD_STEPS,
                         k3=cfg.n_layers * SHARD_STEPS, k4=0)
    quarter = 3 * 4 * cfg.num_params() / world  # fp32 parameter + 2 moments
    losses = per[0]["losses"]
    leaf_errors = per[0]["leaf_errors"]
    grad_errors = per[0]["grad_errors"]
    out = dict(
        config=dict(TRAIN_CFG, attention_impl="flash", remat=TRAIN_REMAT,
                    loss_chunk=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    lr=TRAIN_LR, mesh=SHARD_MESH),
        label=SHARD_LABEL, wall_s=wall_s, losses=losses,
        flash_losses=ref_losses,
        loss_abs_diff=[abs(a - b) for a, b in zip(losses, ref_losses)],
        leaf_rel_err=leaf_errors, grad_rel_err=grad_errors,
        step_s=[p["step_s"] for p in per],
        collectives_per_step=[p["collectives_per_step"] for p in per],
        peak_memory_gb=[p["peak_memory_gb"] for p in per],
        state_bytes=[p["state_bytes"] for p in per],
        state_frac_of_quarter=[p["state_bytes"] / quarter for p in per],
        launches_per_rank=[p["launches"] for p in per],
        launches_per_rank_step={k: v / SHARD_STEPS
                                for k, v in per[0]["launches"].items()},
        shapes=[p["shapes"] for p in per])
    print(json.dumps({"shard": out}), flush=True)
    print(f"shard train step: {max(out['step_s']):.3f} s, peak memory a "
          f"rank {[round(m, 2) for m in out['peak_memory_gb']]} GB "
          f"({SHARD_LABEL})", flush=True)
    _check(all(p["losses"] == losses for p in per),
           f"the ranks disagree on the loss: {[p['losses'] for p in per]}")
    _check(max(out["loss_abs_diff"]) <= TOL_SHARD_LOSS,
           f"fsdp x tp losses {losses} vs one device {ref_losses}: beyond "
           f"{TOL_SHARD_LOSS}")
    _check(max(tree_leaves(leaf_errors)) <= TOL_SHARD_PARAM,
           f"gathered parameters after one step beyond ||err||/||ref|| "
           f"{TOL_SHARD_PARAM}: {leaf_errors}")
    _check(max(tree_leaves(grad_errors)) <= TOL_SHARD_GRAD,
           f"gathered step-one gradients beyond ||err||/||ref|| "
           f"{TOL_SHARD_GRAD}: {grad_errors}")
    for r, p in enumerate(per):
        _check(p["launches"] == want_launches,
               f"rank {r} launched {p['launches']} in {SHARD_STEPS} steps, "
               f"want {want_launches}")
        _check([tuple(map(tuple, x)) for x in p["shapes"]] == want_shape,
               f"rank {r} ran attention at {p['shapes']}, want {want_shape}")
        _check(abs(p["state_bytes"] / quarter - 1) <= TOL_SHARD_BYTES,
               f"rank {r} holds {p['state_bytes']} bytes of parameters and "
               f"moments, a quarter is {quarter}")
    return out


# GPipe over pp 4: the flagship's 16 layers in 4 stages of 4, 8 microbatches
# of one sequence of the train batch, "flash" without remat; four processes
# on the card over gloo, as in shard (NCCL refuses two ranks on one GPU), so
# its times are time-slicing, not the pipeline's speed
PIPE_MESH = dict(pp=4)
PIPE_MICRO = 8
PIPE_STEPS = 2             # timed, after one warm-up step
PIPE_LABEL = "4 ranks time-sliced on one card, gloo through host"


def _pipe_rank(dev, mesh, ref_path):
    """One stage of the pp 4 mesh: the flagship's pipelined train step on
    its 4 layers, one warm-up step (after which its gradients and
    parameters are held to ``ref_path``'s layers [4s, 4s + 4), tok_emb,
    norm and lm_head), then PIPE_STEPS timed steps, each with the launches
    counted from zero, the (q, k, causal) of every attention call recorded
    and the bytes this stage sends to its neighbours added up."""
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import pipeline as tpp
    from ray_tpu_torch.parallel.mesh import AxisRing, axis_index, tree_map

    shapes = set()

    def recording(launch):
        def wrapped(q, k, *args):
            shapes.add((tuple(q.shape), tuple(k.shape), bool(args[-1])))
            return launch(q, k, *args)
        return wrapped

    # the kernels' launchers (K1; K2 and K3), as _FlashAttn calls them
    fa._flash_fwd_cuda = recording(fa._flash_fwd_cuda)
    fa._flash_bwd_cuda = recording(fa._flash_bwd_cuda)
    sent = dict(bytes=0)
    exchange = AxisRing.exchange

    def counted(ring, sends=(), *args, **kwargs):
        sent["bytes"] += sum(t.numel() * t.element_size() for t in sends)
        return exchange(ring, sends, *args, **kwargs)

    AxisRing.exchange = counted
    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    init_state, shard_state, train_step, data_dev = \
        tpp.make_pipeline_train_step(cfg, mesh, PIPE_MICRO,
                                     learning_rate=TRAIN_LR, device=dev)
    state = shard_state(init_state(SEED))
    tokens = _train_tokens(data_dev)
    state, loss = train_step(state, tokens)  # warm-up
    losses = [float(loss)]
    params = state[0]
    stage = axis_index(mesh, "pp")
    per_stage = cfg.n_layers // PIPE_MESH["pp"]
    ref = torch.load(ref_path, map_location="cpu", mmap=True,
                     weights_only=True)

    def rel_err(got, want):
        want = want.to(got.device)
        return ((got - want).norm() / want.norm()).item()

    def own(tree):
        """The reference's leaves as this stage holds them."""
        return dict(tree, layers={
            k: w[stage * per_stage:(stage + 1) * per_stage][None]
            for k, w in tree["layers"].items()})

    leaf_errors = tree_map(lambda t, w: rel_err(t.detach(), w), params,
                           own(ref["params"]))
    grad_errors = tree_map(lambda t, w: rel_err(t.grad, w), params,
                           own(ref["grads"]))
    del ref
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    shapes.clear()
    step_s, launches, step_bytes = [], [], []
    for _ in range(PIPE_STEPS):
        _zero_launches(fa)
        sent["bytes"] = 0
        t = time.monotonic()
        state, loss = train_step(state, tokens)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t)
        launches.append(_read_launches(fa))
        step_bytes.append(sent["bytes"])
    return dict(stage=stage, losses=losses, launches=launches,
                shapes=sorted(shapes), step_s=step_s,
                sent_bytes_per_step=step_bytes,
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                leaf_errors=leaf_errors, grad_errors=grad_errors)


def phase_pipe(dev, ref):
    """GPipe over pp 4 (``PIPE_LABEL``): the flagship at full width and
    depth, "flash", no remat, 8 microbatches of one sequence of the b8 x
    2048 train batch, each stage K1-K3 on its 4 layers at (1, 8, 4, 2048,
    128), causal; held to the single-device "flash" run from the same seed
    on the same batch (``ref``: the path and losses of
    ``_shard_reference``)."""
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.parallel.mesh import tree_leaves

    cfg = LlamaConfig(**TRAIN_CFG, attention_impl="flash")
    ref_path, ref_losses = ref
    t0 = time.monotonic()
    per = _run_ranks(dev, "pipe", PIPE_MESH, _pipe_rank, ref_path)
    wall_s = time.monotonic() - t0
    S, M = PIPE_MESH["pp"], PIPE_MICRO
    mb = TRAIN_BATCH // M
    b, h, kvh, s, hd = PIPE_SHAPE
    want_shapes = [((b, h, s, hd), (b, kvh, s, hd), True)]
    n = cfg.n_layers // S * M
    want_launches = dict(k1=n, k2=n, k3=n, k4=0)
    # an activation forward and its gradient back at each of the S - 1
    # boundaries, for each microbatch, in bf16
    want_bytes = 2 * (S - 1) * M * mb * TRAIN_SEQ * cfg.dim * 2
    losses = per[0]["losses"]
    out = dict(
        config=dict(TRAIN_CFG, attention_impl="flash", remat=False,
                    batch=TRAIN_BATCH, seq=TRAIN_SEQ, lr=TRAIN_LR,
                    mesh=PIPE_MESH, microbatches=M),
        label=PIPE_LABEL, wall_s=wall_s, losses=losses,
        flash_losses=ref_losses,
        loss_abs_diff=[abs(a - b) for a, b in zip(losses, ref_losses)],
        leaf_rel_err=[p["leaf_errors"] for p in per],
        grad_rel_err=[p["grad_errors"] for p in per],
        step_ms=[[t * 1e3 for t in p["step_s"]] for p in per],
        peak_memory_gb=[p["peak_memory_gb"] for p in per],
        handoff_bytes_per_step=[sum(p["sent_bytes_per_step"][i] for p in per)
                                for i in range(PIPE_STEPS)],
        handoff_bytes_expected=want_bytes,
        bubble_share=(S - 1) / (M + S - 1),
        launches_per_rank_step=[p["launches"] for p in per],
        shapes=[p["shapes"] for p in per])
    print(json.dumps({"pipe": out}), flush=True)
    print(f"pipe train step (ms, each rank): {out['step_ms']}; peak memory a "
          f"rank {[round(m, 2) for m in out['peak_memory_gb']]} GB; hand-off "
          f"{out['handoff_bytes_per_step']} B a step; bubble "
          f"{S - 1}/{M + S - 1} ({PIPE_LABEL})", flush=True)
    _check([p["stage"] for p in per] == list(range(S)),
           f"ranks hold stages {[p['stage'] for p in per]}")
    _check(all(p["losses"] == losses for p in per),
           f"the ranks disagree on the loss: {[p['losses'] for p in per]}")
    _check(max(out["loss_abs_diff"]) <= TOL_SHARD_LOSS,
           f"pp losses {losses} vs one device {ref_losses}: beyond "
           f"{TOL_SHARD_LOSS}")
    for r, p in enumerate(per):
        _check(max(tree_leaves(p["leaf_errors"])) <= TOL_SHARD_PARAM,
               f"rank {r}'s parameters after one step beyond ||err||/||ref|| "
               f"{TOL_SHARD_PARAM}: {p['leaf_errors']}")
        _check(max(tree_leaves(p["grad_errors"])) <= TOL_SHARD_GRAD,
               f"rank {r}'s step-one gradients beyond ||err||/||ref|| "
               f"{TOL_SHARD_GRAD}: {p['grad_errors']}")
        for i, counts in enumerate(p["launches"]):
            _check(counts == want_launches,
                   f"rank {r} launched {counts} in step {i}, want "
                   f"{want_launches}")
        got_shapes = [(tuple(q), tuple(k), c) for q, k, c in p["shapes"]]
        _check(got_shapes == want_shapes,
               f"rank {r} ran attention at {p['shapes']}, want {want_shapes}")
    _check(out["handoff_bytes_per_step"] == [want_bytes] * PIPE_STEPS,
           f"hand-offs of {out['handoff_bytes_per_step']} B a step, want "
           f"{want_bytes}")
    return out


# ViT-B/16 (ViTConfig.base: 86.5M parameters, 224² images, patch 16, 12
# layers, dim 768, 12 heads of 64, MLP 3072, 1000 classes) at full width and
# depth: fp32 parameters, bf16 compute, "flash", no remat, one seeded batch
# of VIT_BATCH NHWC images
VIT_BATCH, VIT_STEPS, VIT_LR = 128, 10, 1e-3  # the JAX package's lr
VIT_CMP_STEPS = 3          # flash against xla: the loss after 3 steps
TOL_VIT_LOSS = 1e-2        # absolute


def _vit_batch(dev, cfg):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    images = torch.randn((VIT_BATCH, cfg.image_size, cfg.image_size,
                          cfg.channels), generator=gen, device=dev)
    labels = torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=gen,
                           device=dev)
    return images, labels


def _vit_losses(dev, impl, steps):
    """Losses of ``steps`` AdamW steps of ViT-B/16 with ``impl`` from seed
    SEED on the vit batch."""
    import torch

    from ray_tpu_torch.models.vit import ViTConfig, make_train_step

    cfg = ViTConfig.base(attention_impl=impl)
    init_state, shard_state, train_step, data_dev = make_train_step(
        cfg, learning_rate=VIT_LR)
    state = shard_state(init_state(SEED))
    images, labels = _vit_batch(data_dev, cfg)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, images, labels)
        losses.append(float(loss))
    del state
    torch.cuda.empty_cache()
    return losses


def phase_vit(dev):
    """ViT-B/16 trained at full width and depth on one card ("flash": K1
    forward, K2 and K3 backward, unmasked, at (128, 12, 12, 196, 64)),
    then held to "xla" on the loss after 3 steps, on the step-one head
    gradients and on the forward of converted weights with a nonzero
    head."""
    import numpy as np
    import torch

    from ray_tpu_torch.models.convert import params_from_jax
    from ray_tpu_torch.models.vit import (ViTConfig, compute_loss, forward,
                                          init_params, make_train_step)
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel.mesh import tree_map

    cfg = ViTConfig.base(attention_impl="flash")
    xcfg = ViTConfig.base(attention_impl="xla")
    calls = []

    def recording(launch, kind):
        def wrapped(q, k, v, *args):
            calls.append((kind, tuple(q.shape), tuple(k.shape), args[-1]))
            return launch(q, k, v, *args)
        return wrapped

    # the kernels' launchers as _FlashAttn calls them: (shapes, causal)
    fwd_cuda, bwd_cuda = fa._flash_fwd_cuda, fa._flash_bwd_cuda
    fa._flash_fwd_cuda = recording(fwd_cuda, "k1")
    fa._flash_bwd_cuda = recording(bwd_cuda, "k23")
    try:
        init_state, shard_state, train_step, data_dev = make_train_step(
            cfg, learning_rate=VIT_LR)
        state = shard_state(init_state(SEED))
        images, labels = _vit_batch(data_dev, cfg)
        state, loss = train_step(state, images, labels)  # warm-up
        losses = [float(loss)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches(fa)
        calls.clear()
        t = time.monotonic()
        step_losses = []
        for _ in range(VIT_STEPS):
            state, loss = train_step(state, images, labels)
            step_losses.append(loss)
        torch.cuda.synchronize()
        dt = (time.monotonic() - t) / VIT_STEPS
        launches = _read_launches(fa)
        shapes = sorted(set(calls))
    finally:
        fa._flash_fwd_cuda, fa._flash_bwd_cuda = fwd_cuda, bwd_cuda
    losses += [float(x) for x in step_losses]
    out = dict(
        config=dict(image_size=cfg.image_size, patch_size=cfg.patch_size,
                    dim=cfg.dim, n_layers=cfg.n_layers, n_heads=cfg.n_heads,
                    mlp_dim=cfg.mlp_dim, num_classes=cfg.num_classes,
                    num_params=cfg.num_params(), batch=VIT_BATCH,
                    attention_impl="flash", remat=False, lr=VIT_LR),
        losses=losses, step_ms=dt * 1e3, images_per_s=VIT_BATCH / dt,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=launches,
        launches_per_step={k: v / VIT_STEPS for k, v in launches.items()},
        shapes=shapes)
    out["profile"] = _train_profile(train_step, state, images, labels)
    del state
    torch.cuda.empty_cache()

    # flash against xla: the loss after VIT_CMP_STEPS steps from the seed
    lf = _vit_losses(dev, "flash", VIT_CMP_STEPS)
    lx = _vit_losses(dev, "xla", VIT_CMP_STEPS)
    # step one from the seed: its gradient reaches the zero head alone
    params = init_params(cfg, SEED)
    for t_ in (params["head"], params["head_bias"]):
        t_.requires_grad_(True)
    grads = {}
    for c in (cfg, xcfg):
        loss = compute_loss(c, params, images, labels)
        grads[c.attention_impl] = torch.autograd.grad(
            loss, [params["head"], params["head_bias"]])
    cos = {name: torch.nn.functional.cosine_similarity(
        gf.flatten().double(), gx.flatten().double(), dim=0).item()
        for name, gf, gx in zip(("head", "head_bias"), grads["flash"],
                                grads["xla"])}
    # converted weights (a nested numpy dict, as a JAX checkpoint arrives)
    # with a seeded nonzero head: the forward phase's top-1 rule
    tree = tree_map(lambda t_: t_.detach().cpu().numpy(), params)
    rng = np.random.RandomState(SEED + 9)
    tree["head"] = (0.02 * rng.randn(cfg.dim, cfg.num_classes)).astype(
        np.float32)
    del params, grads
    conv = params_from_jax(tree, None)
    with torch.no_grad():
        _zero_launches(fa)
        logits_f = forward(cfg, conv, images)
        fwd_launches = fa.flash_fwd_launches
        logits_x = forward(xcfg, conv, images)
    top1 = (logits_f.argmax(-1) == logits_x.argmax(-1)).float().mean().item()
    dls = (torch.log_softmax(logits_f, -1) - torch.log_softmax(logits_x, -1)
           ).abs().max().item()
    finite = bool(torch.isfinite(logits_f).all())
    out["flash_vs_xla"] = dict(
        steps=VIT_CMP_STEPS, losses_flash=lf, losses_xla=lx,
        loss_abs_diff=abs(lf[-1] - lx[-1]), head_grad_cosine=cos,
        forward_top1_agreement=top1, forward_max_abs_logsoftmax_diff=dls,
        forward_k1_launches=fwd_launches)
    del conv, logits_f, logits_x
    torch.cuda.empty_cache()
    print(json.dumps({"vit": out}), flush=True)
    print(f"vit train step: {out['step_ms']:.1f} ms, "
          f"{out['images_per_s']:.0f} images/s, peak "
          f"{out['peak_memory_gb']:.2f} GB", flush=True)
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"vit losses not finite and falling: {losses}")
    n = cfg.n_layers * VIT_STEPS
    _check(launches == dict(k1=n, k2=n, k3=n, k4=0),
           f"vit launched {launches} in {VIT_STEPS} steps, want K1, K2 and "
           f"K3 {cfg.n_layers} a step")
    b, h, kvh, s, hd = VIT_SHAPE
    want = [("k1", (b, h, s, hd), (b, kvh, s, hd), False),
            ("k23", (b, h, s, hd), (b, kvh, s, hd), False)]
    _check(shapes == want, f"vit ran attention at {shapes}, want {want}")
    _check(abs(lf[-1] - lx[-1]) <= TOL_VIT_LOSS,
           f"vit flash vs xla loss after {VIT_CMP_STEPS} steps {lf} vs {lx} "
           f"beyond {TOL_VIT_LOSS}")
    _check(min(cos.values()) >= GRAD_COS_MIN,
           f"vit flash vs xla step-one head gradient cosine below "
           f"{GRAD_COS_MIN}: {cos}")
    _check(finite and fwd_launches == cfg.n_layers and top1 >= TOP1_MIN,
           f"vit forward of converted weights: finite {finite}, K1 "
           f"{fwd_launches} launches, flash vs xla top-1 {top1} < {TOP1_MIN}")
    return out


# Mixtral-8x7B's FFN widths (mistralai/Mixtral-8x7B-v0.1 config.json:
# hidden_size 4096, intermediate_size 14336, 8 local experts, 2 a token) with
# the JAX package's GELU pair for the expert FFN (not SwiGLU); fp32
# parameters, bf16 tokens
MOE_D, MOE_FF, MOE_E, MOE_K = 4096, 14336, 8, 2
MOE_TOKENS, MOE_CF = 4096, 2.0
MOE_EP = dict(tp=4)
MOE_EP_TOKENS, MOE_EP_CF = 1024, 8.0   # no slot dropped
MOE_LABEL = "4 ranks time-sliced on one card, gloo through host"
TOL_MOE = 1e-2             # ||err|| / ||ref||
TOL_COMBINE = 1e-5


def _moe_reference(params, x, top_k, capacity):
    """The MoE FFN token by token: each kept (token, choice) slot's gate
    times its expert's FFN of the token, summed in fp32; a slot is kept
    while its expert has taken fewer than ``capacity`` slots, first choices
    in token order before second ones. Returns (y, dropped slots)."""
    import torch
    import torch.nn.functional as F

    xf = x.float()
    probs = torch.softmax(xf @ params["router"].float(), dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    y = torch.zeros_like(xf)
    taken = [0] * params["router"].shape[1]
    dropped = 0
    for j in range(top_k):
        for e in range(len(taken)):
            toks = (idx[:, j] == e).nonzero()[:, 0]
            keep = toks[:max(0, capacity - taken[e])]
            taken[e] += len(toks)
            dropped += len(toks) - len(keep)
            if len(keep):
                h = F.gelu(xf[keep] @ params["w_in"][e].float(),
                           approximate="tanh")
                y.index_add_(0, keep, gates[keep, j:j + 1]
                             * (h @ params["w_out"][e].float()))
    return y, dropped


def _moe_ep_rank(dev, mesh, ref_path):
    """One rank of ``moe_ffn_ep`` over tp 4: its experts' block of the
    seeded parameters, the whole token batch (tokens_spec P("dp"), dp 1):
    y, aux and the gradients of mean(y²) against the single shard's in
    ``ref_path`` (sums of squares, for the parent to combine), and the
    ms of a forward call."""
    import torch

    from ray_tpu_torch.parallel.mesh import shard_of
    from ray_tpu_torch.parallel.moe import (init_moe_params, moe_ffn_ep,
                                            moe_param_specs)

    specs = moe_param_specs("tp")
    full = init_moe_params(SEED, MOE_D, MOE_FF, MOE_E, device=dev)
    params = {k: shard_of(v, specs[k], mesh).clone().requires_grad_()
              for k, v in full.items()}
    del full
    x = _moe_tokens(dev, MOE_EP_TOKENS)
    y, aux = moe_ffn_ep(params, x, mesh=mesh, axis="tp", top_k=MOE_K,
                        capacity_factor=MOE_EP_CF)
    y.float().square().mean().backward()
    ref = torch.load(ref_path, map_location="cpu", mmap=True,
                     weights_only=True)
    errors = {"y": _errors_against(y, ref["y"].to(dev))}
    for k in params:
        errors[k] = _errors_against(params[k].grad, shard_of(
            ref["grads"][k], specs[k], mesh).to(dev))
    del ref
    with torch.no_grad():
        for _ in range(2):  # warm-up
            moe_ffn_ep(params, x, mesh=mesh, axis="tp", top_k=MOE_K,
                       capacity_factor=MOE_EP_CF)
        torch.cuda.synchronize()
        t = time.monotonic()
        for _ in range(3):
            moe_ffn_ep(params, x, mesh=mesh, axis="tp", top_k=MOE_K,
                       capacity_factor=MOE_EP_CF)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t) * 1e3 / 3
    return dict(errors=errors, aux=float(aux.detach()), ms=ms,
                peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def _moe_tokens(dev, n):
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    return torch.randn((n, MOE_D), generator=gen, device=dev).bfloat16()


def phase_moe(dev):
    """``moe_ffn`` at Mixtral-8x7B's FFN widths on MOE_TOKENS bf16 tokens
    against a per-token reference on the card; then ``moe_ffn_ep`` over tp
    4 (MOE_LABEL) against the single shard's outputs and gradients."""
    import shutil
    import tempfile

    import torch

    from ray_tpu_torch.parallel.moe import (_capacity, _route,
                                            init_moe_params, moe_ffn)

    params = init_moe_params(SEED, MOE_D, MOE_FF, MOE_E)
    x = _moe_tokens(dev, MOE_TOKENS)
    capacity = _capacity(MOE_TOKENS, MOE_E, MOE_CF, MOE_K)
    with torch.no_grad():
        y, aux = moe_ffn(params, x, top_k=MOE_K, capacity_factor=MOE_CF)
        ref, ref_dropped = _moe_reference(params, x, MOE_K, capacity)
        dispatch, combine, _ = _route(x.float() @ params["router"], MOE_K,
                                      capacity)
        slots = dispatch.sum(dim=(1, 2))
        dropped = int(round(MOE_TOKENS * MOE_K - slots.sum().item()))
        whole = slots == MOE_K   # tokens that kept every slot
        combine_err = (combine.sum(dim=(1, 2))[whole] - 1).abs().max().item()
        del dispatch, combine
        rel = ((y.float() - ref).norm() / ref.norm()).item()
        ms = _time_ms(lambda: moe_ffn(params, x, top_k=MOE_K,
                                      capacity_factor=MOE_CF),
                      iters=5, warmup=1)
    out = dict(config=dict(d_model=MOE_D, d_ff=MOE_FF, experts=MOE_E,
                           top_k=MOE_K, tokens=MOE_TOKENS,
                           capacity_factor=MOE_CF, capacity=capacity),
               rel_err=rel, aux=float(aux), dropped_slots=dropped,
               reference_dropped_slots=ref_dropped,
               tokens_with_every_slot=int(whole.sum()),
               combine_sum_max_err=combine_err, ms=ms,
               tokens_per_s=MOE_TOKENS / (ms * 1e-3))
    del y, ref

    # the single shard at the ep check's tokens and capacity: y and the
    # gradients of mean(y²), which the ranks are held to
    xe = _moe_tokens(dev, MOE_EP_TOKENS)
    leaves = {k: v.requires_grad_() for k, v in params.items()}
    ye, _ = moe_ffn(leaves, xe, top_k=MOE_K, capacity_factor=MOE_EP_CF)
    ye.float().square().mean().backward()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_ref_")
    try:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save(dict(y=ye.detach(), grads={k: v.grad for k, v in
                                              leaves.items()}), ref_path)
        del params, leaves, ye, xe
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        per = _run_ranks(dev, "moe", MOE_EP, _moe_ep_rank, ref_path)
        wall_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ep = MOE_EP["tp"]
    ep_capacity = _capacity(MOE_EP_TOKENS, MOE_E, MOE_EP_CF, MOE_K)
    ep_out = dict(label=MOE_LABEL, mesh=MOE_EP, tokens=MOE_EP_TOKENS,
                  capacity_factor=MOE_EP_CF, capacity=ep_capacity,
                  wall_s=wall_s, ms_per_call=[p["ms"] for p in per],
                  tokens_per_s=[MOE_EP_TOKENS / (p["ms"] * 1e-3)
                                for p in per],
                  # each all-to-all moves a rank's fp32 [E, C, d] buckets,
                  # (ep - 1)/ep of them to other ranks; two a call
                  exchange_bytes_per_rank=4 * MOE_E * ep_capacity * MOE_D,
                  peak_memory_gb=[p["peak_memory_gb"] for p in per],
                  aux=[p["aux"] for p in per])
    ok = True
    for name in ("y", "router", "w_in", "w_out"):
        e = [p["errors"][name] for p in per]
        if name == "router":  # every rank holds the whole router
            e = e[:1]
        rel_norm = (sum(x_["sq_err"] for x_ in e)
                    / sum(x_["sq_ref"] for x_ in e)) ** 0.5
        ep_out[f"rel_norm_{name}"] = rel_norm
        ok = ok and rel_norm <= TOL_MOE and all(x_["finite"] for x_ in e)
    out["ep"] = ep_out
    print(json.dumps({"moe": out}), flush=True)
    print(f"moe_ffn at Mixtral-8x7B widths: {ms:.2f} ms a call, "
          f"{out['tokens_per_s']:.0f} tokens/s; moe_ffn_ep over tp {ep}: "
          f"{max(ep_out['ms_per_call']):.1f} ms a call ({MOE_LABEL})",
          flush=True)
    _check(rel <= TOL_MOE, f"moe_ffn vs the per-token reference: "
           f"||err||/||ref|| {rel} > {TOL_MOE}")
    _check(combine_err <= TOL_COMBINE,
           f"combine weights of tokens that kept every slot sum to 1 +- "
           f"{combine_err} > {TOL_COMBINE}")
    _check(dropped == ref_dropped, f"moe_ffn dropped {dropped} slots, the "
           f"reference {ref_dropped}")
    _check(ok, f"moe_ffn_ep over tp {ep} vs the single shard beyond "
           f"||err||/||ref|| {TOL_MOE}: {ep_out}")
    return out


def kernels_line(report):
    """The kernels record: each kernel at its main path's shape, with the
    launches of that path's run (K1: the serve phase; K2/K3: the train
    phase's timed steps; K4, K5a, K5b: the ring phase's timed training
    steps, over its 4 ranks)."""
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
        for key, name, line_no, errs, src in (
                ("k2", "flash_bwd_dq (K2)", 275, ("err_dq",), "flash_bwd.cu"),
                ("k3", "flash_bwd_dkv (K3)", 320, ("err_dk", "err_dv"),
                 "flash_bwd_dkv.cu")):
            line.append({
                "name": name, "route": "cuda",
                "source": f"ray_tpu_torch/csrc/{src}",
                "replaces": f"ray_tpu/ops/flash_attention.py:{line_no}",
                "launches": report["train"]["launches"][key],
                "max_abs_err": max(r[e] for r in report["k23"] for e in errs),
                "ms": row[f"{key}_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row[f"{key}_bound_ms"],
                "bound_by": row[f"{key}_bound_by"],
                # SDPA's backward computes K2's and K3's work in one call
                "library_ms": row["sdpa_bwd_ms"],
            })
    # K4 and K5 at the training ring's unmasked hop, with the launches of
    # the ring phase's timed training steps (over the 4 ranks)
    if "k4" in report and "ring" in report:
        row = next(r for r in report["k4"] if not r["causal"]
                   and r["state"] == "carried" and (
                       r["b"], r["h"], r["kvh"], r["s"], r["hd"])
                   == HOP_MAIN_SHAPE)
        line.append({
            "name": "flash_chunk (K4)", "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_chunk.cu",
            "replaces": "ray_tpu/ops/flash_attention.py:541",
            "launches": report["ring"]["train"]["launches"]["k4"],
            "max_abs_err": max(r["err_o"] for r in report["k4"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # SDPA's forward carries no state: a little less work
            "library_ms": row["sdpa_ms"],
        })
    if "k5" in report and "ring" in report:
        row = next(r for r in report["k5"] if not r["causal"] and (
            r["b"], r["h"], r["kvh"], r["s"], r["hd"]) == HOP_MAIN_SHAPE)
        for key, counter, name, line_no, errs, src in (
                ("k5a", "k2", "flash_bwd_dq fp32 (K5a)", 743, ("err_dq",),
                 "flash_bwd.cu"),
                ("k5b", "k3", "flash_bwd_dkv fp32 (K5b)", 770,
                 ("err_dk", "err_dv"), "flash_bwd_dkv.cu")):
            line.append({
                "name": name, "route": "cuda",
                "source": f"ray_tpu_torch/csrc/{src}",
                "replaces": f"ray_tpu/ops/flash_attention.py:{line_no}",
                "launches": report["ring"]["train"]["launches"][counter],
                "max_abs_err": max(r[e] for r in report["k5"] for e in errs),
                "ms": row[f"{key}_ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row[f"{key}_bound_ms"],
                "bound_by": row[f"{key}_bound_by"],
                "library_ms": row["sdpa_bwd_ms"],
            })
    return line


PHASES = ("k1", "k23", "k4", "k5", "route", "forward", "serve", "train",
          "ring", "shard", "pipe", "vit", "moe")


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
    paths = _build.build_all()
    build_s = time.monotonic() - t0
    print(f"build: {build_s:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})",
          flush=True)
    binfo = build_info(paths)
    print(json.dumps({"build_info": binfo}), flush=True)

    report = {"card": card, "build_s": build_s, "build_info": binfo}
    if "k1" in phases:
        report["k1"] = phase_k1(dev)
    if "k23" in phases:
        report["k23"] = phase_k23(dev)
    if "k4" in phases:
        report["k4"] = phase_k4(dev)
    if "k5" in phases:
        report["k5"] = phase_k5(dev)
    if "route" in phases:
        report["route"] = phase_route(dev)
    if phases & {"forward", "serve"}:
        report.update(phase_model(dev, phases))
    if "train" in phases:
        report["train"] = phase_train(dev)
    if "ring" in phases:
        torch.cuda.empty_cache()
        report["ring"] = phase_ring(dev)
    if phases & {"shard", "pipe"}:
        torch.cuda.empty_cache()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ref_")
        try:
            ref_path = os.path.join(tmp, "step1.pt")
            ref = (ref_path, _shard_reference(dev, ref_path))
            if "shard" in phases:
                report["shard"] = phase_shard(dev, ref)
            if "pipe" in phases:
                torch.cuda.empty_cache()
                report["pipe"] = phase_pipe(dev, ref)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if "vit" in phases:
        torch.cuda.empty_cache()
        report["vit"] = phase_vit(dev)
    if "moe" in phases:
        torch.cuda.empty_cache()
        report["moe"] = phase_moe(dev)
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
