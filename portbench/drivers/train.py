"""Training driver: ``make_train_step``'s ``train_step`` (remat "dots", the
flash kernels, fused AdamW) stepped back to back, checked against the
plain reference's first three steps.

Set-up builds one state from weights the benchmark drew on the card from
the seed (float32), and drives it through its first three steps with the
window's own call and feed (fresh random rows each step). Those steps are
the warm-up and give the program's readings: each step's loss, each leaf's
first gradient as AdamW holds it after step 1 (exp_avg / (1 - beta1)),
its norm and its elements at indices drawn from the seed, and each leaf's
change after step 3, its norm and its elements at the same indices. The same state then runs the window. After it the
state is freed, the weights are drawn again from the seed (their checksums
must match), and the reference runs the same three batches. The cell's
``check`` names the numbers compared and their limits; the loss gap is
read but compared in no cell (PERF.md gives why).
"""

from __future__ import annotations

import gc
import os
import statistics
import time
from typing import Dict

import torch

import port
import traffic as T
import weights as W
from reference.llama import Reference

CHECK_STEPS = 3
SAMPLE = 1 << 20
NUMBERS = ("loss_gap", "grad_gap", "grad_diff", "change_gap", "change_diff")
STEP_SPAN = "portbench.step"
OPT_SPAN = "portbench.optimizer"


class Feed:
    """Random token rows from the seed, drawn on the device, new each step."""

    def __init__(self, seed: int, batch: int, seq: int, vocab: int, device):
        self.shape, self.vocab, self.device = (batch, seq), vocab, device
        self.gen = torch.Generator(device=device).manual_seed(
            T.torch_seed(seed, 2))

    def next(self) -> torch.Tensor:
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)


def sample_indices(params: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """Per leaf, up to 2^20 flat indices drawn from the seed: the elements
    of the first gradient and of the change that are compared one by one."""
    out = {}
    for n, t in W.leaves(params).items():
        gen = torch.Generator(device=t.device).manual_seed(
            T.torch_seed(seed, 4) + len(out))
        out[n] = torch.randint(0, t.numel(), (min(t.numel(), SAMPLE),),
                               generator=gen, device=t.device)
    return out


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap; the worst
    leaf's gap between the program's and the reference's norm of the first
    gradient, and of the change after the steps, each against the larger
    of the reference's norm of that leaf and of the median leaf; and the
    worst leaf's norm of the difference of the sampled elements, of the
    first gradient and of the change, each against the same of the
    reference's sample. The change's elements see the update's direction,
    which a norm does not. Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under AdamW and
    are left out of the change. ``worst`` names the leaf that gave each of
    the last four."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g_med = statistics.median(ref["grad_norms"].values())
    grad = {n: abs(prog["grad_norms"][n] - g) / max(g, g_med)
            for n, g in ref["grad_norms"].items()}
    s_norm = {n: float(t.norm()) for n, t in ref["grad_sample"].items()}
    s_med = statistics.median(s_norm.values())
    diff = {n: float((prog["grad_sample"][n] - t).norm()) / max(s_norm[n], s_med)
            for n, t in ref["grad_sample"].items()}
    moved = [n for n, g in ref["grad_norms"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change_norms"][n] for n in moved)
    change = {n: abs(prog["change_norms"][n] - ref["change_norms"][n])
              / max(ref["change_norms"][n], c_med) for n in moved}
    cs_norm = {n: float(ref["change_sample"][n].norm()) for n in moved}
    cs_med = statistics.median(cs_norm.values())
    cdiff = {n: float((prog["change_sample"][n] - ref["change_sample"][n])
                      .norm()) / max(cs_norm[n], cs_med) for n in moved}
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "grad_diff": max(diff.values()), "change_gap": max(change.values()),
            "change_diff": max(cdiff.values()),
            "worst": [max(d, key=d.get) for d in (grad, diff, change, cdiff)]}


def _program_readings(r, cfg, hp, P0, feed, sample):
    """Build the state, run the checked steps; return it and the readings."""
    from ray_tpu_torch.models.llama import make_train_step

    init_state, shard_state, train_step, _ = make_train_step(
        cfg, learning_rate=hp["learning_rate"], remat=hp["remat"],
        device=r.device)
    state = shard_state(init_state(P0))
    names = W.leaves(state[0])
    losses = []
    grad_norms, grad_sample = {}, {}
    for k in range(CHECK_STEPS):
        state, loss = train_step(state, feed.next())
        losses.append(loss)
        if k == 0:
            opt, b1 = state[1], hp["betas"][0]
            for n, p in names.items():
                g = (opt.state[p]["exp_avg"] / (1 - b1) if p in opt.state
                     else torch.zeros_like(p))
                grad_norms[n] = float(g.norm())
                grad_sample[n] = g.reshape(-1)[sample[n]].clone()
    P0l = W.leaves(P0)
    change, change_sample = {}, {}
    with torch.no_grad():
        for n, p in names.items():
            d = (p - P0l[n]).reshape(-1)
            change[n] = float(d.norm())
            change_sample[n] = d[sample[n]].clone()
            del d
    return state, train_step, {"losses": [float(x) for x in losses],
                               "grad_norms": grad_norms,
                               "grad_sample": grad_sample,
                               "change_norms": change,
                               "change_sample": change_sample}


def run(r) -> Dict:
    mc, mix = r.mc, r.mix
    hp = mc["run"]
    cuda = r.device.type == "cuda"
    cfg = port.llama_config(mc, torch.float32, attention_impl="flash",
                            max_seq_len=mix["seq"])
    P0 = W.draw(mc, r.seed, r.device, torch.float32)
    sums = W.checksum(P0)
    feed = Feed(r.seed, mix["batch"], mix["seq"], cfg.vocab_size, r.device)
    sample = sample_indices(P0, r.seed)
    state, train_step, prog = _program_readings(r, cfg, hp, P0, feed, sample)
    del P0
    tokens_per_step = mix["batch"] * mix["seq"]

    prof = None
    if r.trace:
        import devtrace

        devtrace.warm()
        opt = state[1]
        opt_step = opt.step

        def traced_opt_step(*a, **k):
            with torch.profiler.record_function(OPT_SPAN):
                return opt_step(*a, **k)

        opt.step = traced_opt_step
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_open = time.perf_counter()
    t_close = t_open + r.seconds
    steps = 0
    while time.perf_counter() < t_close:
        if r.trace and prof is None and \
                time.perf_counter() >= t_close - r.cell["trace_seconds"]:
            prof = devtrace.Profile(os.path.join(r.tmpdir, "trace.json"))
            opened = False
        elif prof is not None and not opened:
            prof.open()     # one step after the start: the device is busy
            opened = True
        if prof is not None:
            with torch.profiler.record_function(STEP_SPAN):
                state, _ = train_step(state, feed.next())
        else:
            state, _ = train_step(state, feed.next())
        steps += 1
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if prof is not None:
        if not opened:     # the window closed within the traced step
            prof.open()
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del state, train_step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    P0 = W.draw(mc, r.seed, r.device, torch.float32)
    redraw_changed = sum(a != b for a, b in zip(sums.values(),
                                                W.checksum(P0).values()))
    again = Feed(r.seed, mix["batch"], mix["seq"], cfg.vocab_size, r.device)
    batches = [again.next() for _ in range(CHECK_STEPS)]
    ref = Reference(mc).train(P0, batches, hp, sample)
    got = gaps(prog, ref)
    extra = {"gaps": got}
    if r.extra.get("control"):
        extra["control"] = gaps(
            Reference(mc, "fp8").train(P0, batches, hp, sample), ref)
        extra["half_batch"] = gaps(Reference(mc).train(
            P0, batches, hp, sample, rows=mix["batch"] // 2), ref)
        # the update applied with the wrong sign (weight decay with it)
        extra["sign_flipped"] = gaps(Reference(mc).train(
            P0, batches, {**hp, "learning_rate": -hp["learning_rate"]},
            sample), ref)
    lim = r.cell["check"]
    checks = {k: (got[k], "<=", lim[k]) for k in NUMBERS if k in lim}
    checks["weights_redrawn_differ"] = (redraw_changed, "<=", 0)
    ctx = dict(steps=steps, tokens_per_step=tokens_per_step,
               t_open=t_open, t_end=t_end, setup_s=t_open - r.t0)
    return dict(correct=port.passes(checks), attempted=steps, failed=0,
                memory_peak_bytes=peak, checks=checks, ctx=ctx,
                trace_path=prof.path if prof else None, extra=extra)
