"""The PyTorch side of the ``test_torch_*.py`` parity tests.

These functions run in the child process that ``_port_proc.spawn`` starts,
never in a pytest worker (``_port_proc`` says why). Inputs and outputs are
numpy arrays and plain Python values, so the JAX side of each test stays in
the worker and compares like with like on the same numpy inputs.
"""

from __future__ import annotations

import asyncio
import atexit
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import _port_ranks

from ray_tpu_torch.llm import LLMConfig, LLMServer
from ray_tpu_torch.llm._engine import EngineConfig, PagedEngine, _make_prefill
from ray_tpu_torch.llm._generate import generate, generate_stream
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.parallel.mesh import (AXES, MeshSpec, activation_spec,
                                         data_spec, tree_map)
from ray_tpu_torch.parallel.ring_attention import _dispatch_hop

_T = torch.from_numpy


def _np(x):
    return x.detach().cpu().numpy()


def _cfg(shape, **kw):
    return tl.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                          **shape, **kw)


def launches() -> int:
    return tfa.flash_fwd_launches


def bwd_launches():
    return tfa.flash_bwd_dq_launches, tfa.flash_bwd_dkv_launches


# -- ops/flash_attention.py --------------------------------------------------


def attention_reference(q, k, v, causal):
    o, lse = tfa._attention_reference(_T(q), _T(k), _T(v), causal)
    return _np(o), _np(lse)


def flash_attention_bshd(q, k, v):
    return _np(tfa.flash_attention(_T(q), _T(k), _T(v)))


def attention_bhsd(q, k, v, causal):
    """(_xla_attention_bhsd, flash_attention_bhsd) on the CPU."""
    return (_np(tfa._xla_attention_bhsd(_T(q), _T(k), _T(v), causal)),
            _np(tfa.flash_attention_bhsd(_T(q), _T(k), _T(v), causal)))


def cpu_path_gradients(q, k, v):
    """Gradients through the CPU path, and the launch count around it."""
    before = tfa.flash_fwd_launches
    q, k, v = (_T(a).requires_grad_() for a in (q, k, v))
    tfa.flash_attention_bhsd(q, k, v, causal=True).sum().backward()
    return (before, tfa.flash_fwd_launches, _np(q.grad), _np(k.grad),
            _np(v.grad))


def flash_bwd_reference(q, k, v, o, lse, g, causal):
    return tuple(_np(t) for t in tfa._flash_bwd_reference(
        _T(q), _T(k), _T(v), _T(o), _T(lse), _T(g), causal))


def flash_vjp(entry, q, k, v, g, causal):
    """(launch counts before, after, dq, dk, dv) of ``torch.autograd.grad``
    through the public entry ``entry`` on the CPU."""
    before = (tfa.flash_fwd_launches,) + bwd_launches()
    q, k, v = (_T(a).requires_grad_() for a in (q, k, v))
    out = getattr(tfa, entry)(q, k, v, causal)
    grads = torch.autograd.grad(out, (q, k, v), _T(g))
    after = (tfa.flash_fwd_launches,) + bwd_launches()
    return (before, after) + tuple(_np(t) for t in grads)


def chunk(q, k, v, o, m, l, causal):
    """(``_chunk_xla``, ``flash_chunk_bhsd``) on the CPU, and the launch
    count around them."""
    before = tfa.flash_chunk_launches
    args = [_T(a) for a in (q, k, v, o, m, l)]
    plain = tfa._chunk_xla(*args, causal)
    entry = tfa.flash_chunk_bhsd(*args, causal)
    return ([_np(t) for t in plain], [_np(t) for t in entry],
            (before, tfa.flash_chunk_launches))


def chunk_vjp(q, k, v, o, m, l, causal, go, gm, gl):
    """Gradients of the six inputs of ``flash_chunk_bhsd`` on the CPU."""
    args = [_T(a).requires_grad_() for a in (q, k, v, o, m, l)]
    out = tfa.flash_chunk_bhsd(*args, causal)
    return [_np(t) for t in torch.autograd.grad(
        out, args, [_T(a) for a in (go, gm, gl)])]


def hop_bwd(q, k, v, g, lse, delta, causal):
    """(``_hop_bwd_xla``, ``flash_hop_bwd``) on the CPU, and the launch
    counts around them."""
    before = bwd_launches()
    args = [_T(a) for a in (q, k, v, g, lse, delta)]
    plain = tfa._hop_bwd_xla(*args, causal)
    entry = tfa.flash_hop_bwd(*args, causal)
    return ([_np(t) for t in plain], [_np(t) for t in entry],
            (before, bwd_launches()))


def ring_reference(q, k, v, causal):
    from ray_tpu_torch.parallel.ring_attention import ring_attention_reference

    return _np(ring_attention_reference(_T(q), _T(k), _T(v), causal))


def dispatch_hops(sp):
    """``_dispatch_hop`` for every (causal, idx, i) on a ring of ``sp``."""
    return {(c, idx, i): _dispatch_hop(c, idx, i, sp) for c in (False, True)
            for idx in range(sp) for i in range(sp)}


def mesh_spec_facts():
    return {n: (MeshSpec(**kw).shape, MeshSpec(**kw).num_devices)
            for n, kw in (("default", {}), ("dp2sp2", dict(dp=2, sp=2)),
                          ("all", dict(dp=2, fsdp=2, tp=2, sp=2, pp=2)))} | {
        "for_devices": MeshSpec.for_devices(8, tp=2).shape}


def chunk_refusal(bad):
    """The exception type name the K4 wrapper raises for input ``bad``."""
    b, h, kvh, s, hd = 1, 4, 2, 64, 128
    dt = torch.bfloat16
    q = torch.zeros((b, h, s, hd), dtype=dt)
    k = v = torch.zeros((b, kvh, s // 2, hd), dtype=dt)  # sq != sk is fine
    o, m, l = (torch.zeros((b, h, s, hd)), torch.zeros((b, h, s, 1)),
               torch.zeros((b, h, s, 1)))
    if bad == "dtype":
        q = q.float()
    elif bad == "state_dtype":
        o = o.bfloat16()
    elif bad == "head_dim":
        q, o = q[..., :32].contiguous(), o[..., :32].contiguous()
        k = v = k[..., :32].contiguous()
    elif bad == "heads":
        k = v = torch.zeros((b, 3, s, hd), dtype=dt)
    elif bad == "state_shape":
        m = torch.zeros((b, h, s))
    elif bad == "contiguous":
        o = torch.zeros((b, s, h, hd)).transpose(1, 2)
    try:
        tfa._flash_chunk_cuda(q, k, v, o, m, l, True)
    except (TypeError, ValueError) as e:
        return type(e).__name__
    return None


def bwd_wrapper_refusal(bad):
    """The exception type name the K2/K3 wrapper raises for input ``bad``."""
    b, h, kvh, s, hd = 1, 4, 2, 64, 128
    dt = torch.bfloat16
    q, o, g = (torch.zeros((b, h, s, hd), dtype=dt) for _ in range(3))
    k = torch.zeros((b, kvh, s, hd), dtype=dt)
    v = torch.zeros((b, kvh, s, hd), dtype=dt)
    lse = torch.zeros((b, h, s, 1))
    if bad == "dtype":
        q, k, v, o, g = (x.float() for x in (q, k, v, o, g))
    elif bad == "lse_dtype":
        lse = lse.double()
    elif bad == "head_dim":
        q, k, v, o, g = (x[..., :32].contiguous() for x in (q, k, v, o, g))
    elif bad == "heads":
        k = v = torch.zeros((b, 3, s, hd), dtype=dt)
    elif bad == "contiguous":
        g = torch.zeros((b, s, h, hd), dtype=dt).transpose(1, 2)
    elif bad == "lse_shape":
        lse = torch.zeros((b, h, s))
    else:
        k = v = torch.zeros((b, kvh, s // 2, hd), dtype=dt)
    try:
        tfa._flash_bwd_cuda(q, k, v, o, lse, g, True)
    except (TypeError, ValueError) as e:
        return type(e).__name__
    return None


def wrapper_refusal(bad):
    """The exception type name the K1 wrapper raises for input ``bad``."""
    b, h, kvh, s, hd = 1, 4, 2, 64, 128
    dt = torch.bfloat16
    q = torch.zeros((b, h, s, hd), dtype=dt)
    k = torch.zeros((b, kvh, s, hd), dtype=dt)
    v = torch.zeros((b, kvh, s, hd), dtype=dt)
    if bad == "dtype":
        q, k, v = q.float(), k.float(), v.float()
    elif bad == "head_dim":
        q, k, v = (x[..., :32].contiguous() for x in (q, k, v))
    elif bad == "heads":
        k = v = torch.zeros((b, 3, s, hd), dtype=dt)
    elif bad == "contiguous":
        q = torch.zeros((b, s, h, hd), dtype=dt).transpose(1, 2)
    else:
        k = v = torch.zeros((b, kvh, s // 2, hd), dtype=dt)
    try:
        tfa._flash_fwd_cuda(q, k, v, True)
    except (TypeError, ValueError) as e:
        return type(e).__name__
    return None


def alignment_check(which, offset):
    """``_check_inputs`` with tensor ``which`` of q/k/v a contiguous bf16
    view at storage offset ``offset`` elements: (is it contiguous, its
    data_ptr() % 16, the ValueError's text or None)."""
    b, h, kvh, s, hd = 1, 4, 2, 64, 128
    shapes = {"q": (b, h, s, hd), "k": (b, kvh, s, hd), "v": (b, kvh, s, hd)}
    t = {n: torch.zeros(shape, dtype=torch.bfloat16)
         for n, shape in shapes.items()}
    n = math.prod(shapes[which])
    t[which] = torch.zeros(n + 16, dtype=torch.bfloat16)[
        offset:offset + n].view(shapes[which])
    try:
        tfa._check_inputs("flash_fwd kernel", t["q"], t["k"], t["v"],
                          same_length=True)
        err = None
    except ValueError as e:
        err = str(e)
    return t[which].is_contiguous(), t[which].data_ptr() % 16, err


def all_launches():
    return (tfa.flash_fwd_launches,) + bwd_launches() + (
        tfa.flash_chunk_launches,)


def kernel_takes(case):
    """``_kernel_takes`` on CPU tensors of case ``case``: q (1, 4, 64, hd),
    k/v (1, 2, 64, hd), dO like q."""
    hd = {"bf16_hd64": 64, "hd32": 32}.get(case, 128)
    dt = torch.float32 if case == "fp32" else torch.bfloat16
    q, g = (torch.zeros((1, 4, 64, hd), dtype=dt) for _ in range(2))
    kvh = 3 if case == "heads" else 2
    k, v = (torch.zeros((1, kvh, 64, hd), dtype=dt) for _ in range(2))
    n = q.numel()
    if case == "unaligned_q":  # a contiguous view at storage offset 1
        q = torch.zeros(n + 16, dtype=dt)[1:n + 1].view(q.shape)
    if case == "unaligned_dO":
        g = torch.zeros(n + 16, dtype=dt)[1:n + 1].view(q.shape)
    return tfa._kernel_takes(q, k, v, g)


def _view(t, how):
    """A view of ``t``'s values: "transposed" (a (b, s, h, hd) tensor's
    transpose, not contiguous) or "offset" (contiguous, at storage offset
    1 element, not 16-byte aligned)."""
    if how == "transposed":
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    flat = torch.empty(t.numel() + 16, dtype=t.dtype)
    view = flat[1:t.numel() + 1].view(t.shape)
    view.copy_(t)
    return view


def kernel_input(how):
    """``_kernel_input`` of a bf16 (1, 4, 64, 64) tensor given "aligned"
    or as a ``_view``: (the same tensor returned?, contiguous?, its
    data_ptr() % 16, its values equal?)."""
    t = torch.randn((1, 4, 64, 64), generator=torch.Generator().manual_seed(
        0)).bfloat16()
    x = t if how == "aligned" else _view(t, how)
    y = tfa._kernel_input(x)
    return (y is x, y.is_contiguous(), y.data_ptr() % 16,
            bool(torch.equal(y, t)))


def routed(entry, case, args, cots, causal):
    """``entry`` (``flash_attention_bhsd``, ``flash_chunk_bhsd`` or
    ``flash_hop_bwd``) on the CPU with q, k, v (and the hop's dO) in bf16
    for case "hd32" and fp32 for case "fp32", or in bf16 as views (q and
    dO "transposed", k and v "offset") for case "view": (whether the
    kernels take the inputs, the outputs, the gradients of the inputs under
    cotangents ``cots`` (none for the hop, itself a gradient), and every
    launch counter before and after)."""
    n_bf16 = 4 if entry == "flash_hop_bwd" else 3
    dt = torch.float32 if case == "fp32" else torch.bfloat16
    xs = [_T(a).to(dt) if i < n_bf16 else _T(a) for i, a in enumerate(args)]
    if case == "view":
        xs[:n_bf16] = [_view(x, "offset" if i in (1, 2) else "transposed")
                       for i, x in enumerate(xs[:n_bf16])]
    before = all_launches()
    takes = tfa._kernel_takes(*xs[:3], *xs[3:n_bf16])
    if entry != "flash_hop_bwd":
        for x in xs:
            x.requires_grad_()
    out = getattr(tfa, entry)(*xs, causal)
    outs = [out] if entry == "flash_attention_bhsd" else list(out)
    grads = []
    if entry != "flash_hop_bwd":
        grads = torch.autograd.grad(outs, xs, [_T(c).to(o.dtype)
                                               for c, o in zip(cots, outs)])
    return (takes, [_np(o.float()) for o in outs],
            [_np(x.float()) for x in grads], before, all_launches())


def dO_alignment_check(offset):
    """``_check_inputs`` as the K2/K3 wrapper calls it with dO a contiguous
    bf16 view at storage offset ``offset`` elements: (its data_ptr() % 16,
    the ValueError's text or None)."""
    b, h, kvh, s, hd = 1, 4, 2, 64, 128
    dt = torch.bfloat16
    q, o = (torch.zeros((b, h, s, hd), dtype=dt) for _ in range(2))
    k, v = (torch.zeros((b, kvh, s, hd), dtype=dt) for _ in range(2))
    n = q.numel()
    g = torch.zeros(n + 16, dtype=dt)[offset:offset + n].view(q.shape)
    try:
        tfa._check_inputs("flash_bwd kernels", q, k, v, same_length=True,
                          bf16={"o": (o, tuple(q.shape)),
                                "dO": (g, tuple(q.shape))},
                          fp32={"lse": (torch.zeros((b, h, s, 1)),
                                        (b, h, s, 1))})
        err = None
    except ValueError as e:
        err = str(e)
    return g.data_ptr() % 16, err


def build_without_nvcc(tmp):
    """(lib path stable?, error text) of a build where there is no nvcc."""
    saved = (_build._BUILD, os.environ.get("PATH"),
             os.environ.get("CUDA_HOME"))
    _build._BUILD = tmp
    os.environ["PATH"] = tmp
    os.environ["CUDA_HOME"] = os.path.join(tmp, "no-cuda")
    try:
        stable = _build.lib_path("flash_fwd") == _build.lib_path("flash_fwd")
        try:
            _build.build_all(["flash_fwd"])
        except RuntimeError as e:
            return stable, str(e)
        return stable, ""
    finally:
        _build._BUILD = saved[0]
        for key, val in (("PATH", saved[1]), ("CUDA_HOME", saved[2])):
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val


# -- models/ -----------------------------------------------------------------


def forward(shape, tree, tokens, impl, loss=False):
    cfg = _cfg(shape, attention_impl=impl)
    p = params_from_jax(tree, "cpu")
    with torch.no_grad():
        if loss:
            return float(tl.loss_fn(cfg, p, _T(tokens).long()))
        return _np(tl.forward(cfg, p, _T(tokens)))


def convert(tree):
    """params_from_jax → (nested numpy of values, nested dtype names)."""
    p = params_from_jax(tree, "cpu")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return (_np(t.float()), str(t.dtype))

    return walk(p)


def presets():
    out = {}
    for name in ("tiny", "llama2_7b", "llama3_8b"):
        c = getattr(tl.LlamaConfig, name)()
        out[name] = dict(
            num_params=c.num_params(), head_dim=c.head_dim,
            dtype=str(c.dtype), param_dtype=str(c.param_dtype),
            **{f: getattr(c, f) for f in (
                "vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                "ffn_dim", "rope_theta", "norm_eps", "max_seq_len",
                "attention_impl")})
    return out


def init_params_facts():
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    p = tl.init_params(cfg, 0, device="cpu")
    again = tl.init_params(cfg, 0, device="cpu")
    n = sum(int(x.numel()) for x in [p["tok_emb"], p["norm"], p["lm_head"]]
            + list(p["layers"].values()))
    return dict(n=n, num_params=cfg.num_params(),
                wq=tuple(p["layers"]["wq"].shape),
                w2=tuple(p["layers"]["w2"].shape),
                same=bool(torch.equal(p["layers"]["w1"],
                                      again["layers"]["w1"])),
                w2_std=float(p["layers"]["w2"].std()))


def norm_and_rope(shape, x, w, pos, bpos, xb):
    cfg = _cfg(shape)
    cos, sin = tl.rope_tables(cfg, _T(pos))
    cos2, sin2 = tl.rope_tables(cfg, _T(bpos))
    return dict(
        rms=_np(tl.rms_norm(_T(x), _T(w), 1e-5)),
        cos=_np(cos), sin=_np(sin),
        rope=_np(tl.apply_rope(_T(x), cos, sin)),
        rope_bhsd=_np(tl.apply_rope_bhsd(_T(xb), cos, sin)),
        rope_rows=_np(tl.apply_rope(_T(x), cos2, sin2)))


def cuda_default_errors(shape, tree):
    """Entry points called with no device where CUDA is absent: the error
    text of each (None if it did not raise)."""
    p = params_from_jax(tree, "cpu")
    calls = {
        "init_params": lambda: tl.init_params(_cfg(shape)),
        "params_from_jax": lambda: params_from_jax(
            {"w": np.zeros(2, np.float32)}, None),
        "PagedEngine": lambda: PagedEngine(_cfg(shape), p),
        "LLMServer": lambda: LLMServer(LLMConfig()),
        "build_model": lambda: LLMConfig().build_model(),
        "make_train_step": lambda: tl.make_train_step(_cfg(shape))[0](0),
    }
    return _errors(calls)


def _errors(calls):
    """The RuntimeError text each of ``calls`` raises (None if it does
    not), and whether this machine has CUDA."""
    out = {"cuda_available": torch.cuda.is_available()}
    for name, fn in calls.items():
        try:
            fn()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    return out


def train(shape, tree, tokens, impl, remat, loss_chunk, steps, lr):
    """Losses of ``steps`` train steps on one batch from the carried
    weights, and the parameters after them (nested numpy)."""
    cfg = _cfg(shape, attention_impl=impl)
    init_state, shard_state, train_step, dev = tl.make_train_step(
        cfg, learning_rate=lr, remat=remat, loss_chunk=loss_chunk,
        device="cpu")
    state = shard_state(init_state(params_from_jax(tree, "cpu")))
    toks = _T(tokens).to(dev)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, toks)
        losses.append(float(loss))
    return losses, tree_map(_np, state[0]), (tfa.flash_fwd_launches,) + \
        bwd_launches()


def adamw_steps(params, grads, lr):
    """``params`` after one ``adamw`` step per entry of ``grads``."""
    leaves = [_T(p.copy()).requires_grad_() for p in params]
    opt = tl.adamw(leaves, lr)
    for step in grads:
        for leaf, g in zip(leaves, step):
            leaf.grad = _T(g)
        opt.step()
    return [_np(t) for t in leaves]


class _Mesh:
    """A stand-in for ``torch.distributed.DeviceMesh`` with the axis sizes
    ``axes`` (a real one of more than one device needs as many
    processes): what ``make_train_step`` reads when it is built."""

    def __init__(self, axes):
        self.mesh_dim_names = AXES
        self.shape = tuple(axes.get(a, 1) for a in AXES)

    def size(self):
        return math.prod(self.shape)


def train_step_mesh(shape, axes, impl="ring"):
    """The error ``make_train_step`` raises on a mesh of axis sizes
    ``axes``, as (type name, text), or None if it accepts the mesh."""
    try:
        tl.make_train_step(_cfg(shape, attention_impl=impl),
                           mesh=_Mesh(axes), device="cpu")
    except (NotImplementedError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def pipeline_refusal(shape, impl, axes, n_micro=2):
    """The error ``make_pipeline_train_step`` raises on a mesh of axis
    sizes ``axes``, as (type name, text), or None if it accepts it."""
    from ray_tpu_torch.parallel.pipeline import make_pipeline_train_step

    try:
        make_pipeline_train_step(_cfg(shape, attention_impl=impl),
                                 _Mesh(axes), n_micro, device="cpu")
    except AssertionError as e:
        return type(e).__name__, str(e)
    return None


def stack_roundtrip(tree, n_stages):
    """``stack_stages`` of ``tree`` and ``unstack_stages`` of that."""
    from ray_tpu_torch.parallel.pipeline import stack_stages, unstack_stages

    stacked = stack_stages(tree_map(_T, tree), n_stages)
    return tree_map(_np, stacked), tree_map(_np, unstack_stages(stacked))


def sharding_rules(rules, names):
    """``ShardingRules(rules).spec(name)`` of each of ``names``."""
    from ray_tpu_torch.parallel.mesh import ShardingRules

    table = ShardingRules(rules)
    return [table.spec(name) for name in names]


def pipeline_cuda_default_errors(shape):
    """``cuda_default_errors`` for ``make_pipeline_train_step``."""
    from ray_tpu_torch.parallel.pipeline import make_pipeline_train_step

    return _errors({"make_pipeline_train_step": lambda:
                    make_pipeline_train_step(_cfg(shape), None, 2)[0](0)})


def param_specs(shape):
    """``param_specs``: nested dicts of tuples."""
    return tl.param_specs(_cfg(shape))


def data_specs():
    """``data_spec()`` and ``activation_spec()``."""
    return data_spec(), activation_spec()


# -- parallel/: one gloo group of rank processes per test module -------------

_ranks = None


def sp_start(world):
    """Start ``world`` rank processes in one gloo group (``_port_ranks``)."""
    global _ranks
    _ranks = _port_ranks.Ranks(world)
    atexit.register(_ranks.close)
    return world


def sp_call(name, *args, **kwargs):
    """``_port_ranks.<name>`` on every rank: the results in rank order."""
    return _ranks.call(name, *args, **kwargs)


def sp_stop():
    _ranks.close()


# -- llm/ --------------------------------------------------------------------


def _engine(shape, tree, ecfg):
    return PagedEngine(_cfg(shape), params_from_jax(tree, "cpu"),
                       EngineConfig(**ecfg), device="cpu")


async def _collect(eng, prompt, max_tokens, **kw):
    return [t async for t in eng.generate_stream(
        prompt, max_tokens=max_tokens, temperature=0.0, **kw)]


def engine_generate(shape, tree, ecfg, prompts, max_tokens=8, repeat=1):
    """Greedy tokens of one engine over ``repeat`` waves of concurrent
    ``prompts``, and its stats after each wave."""
    eng = _engine(shape, tree, ecfg)

    async def main():
        waves = []
        for _ in range(repeat):
            outs = await asyncio.gather(
                *[_collect(eng, p, max_tokens) for p in prompts])
            waves.append((outs, eng.stats()))
        return waves

    return asyncio.run(main())


def engine_mid_decode(shape, tree, ecfg, first_prompt, later):
    """One request decodes alone, then ``later`` arrive mid-decode."""
    eng = _engine(shape, tree, ecfg)

    async def main():
        g1 = eng.generate_stream(first_prompt, max_tokens=20)
        head = [await g1.__anext__() for _ in range(3)]
        rest = await asyncio.gather(*[_collect(eng, p, 8) for p in later])
        return [head + [t async for t in g1]] + list(rest)

    return asyncio.run(main()), eng.stats()


def engine_disaggregated(shape, tree, ecfg, prompts):
    """(local tokens, tokens admitted with KV prefilled in another pool,
    stats of the decode engine)."""
    cfg = _cfg(shape)
    p = params_from_jax(tree, "cpu")
    e = EngineConfig(**ecfg)
    prefill = _make_prefill(cfg, e)

    def remote_prefill(prompt):
        nb = -(-len(prompt) // e.kv_block_size)
        S = max(8, 1 << (len(prompt) - 1).bit_length())
        kc = torch.zeros((cfg.n_layers, nb + 1, e.kv_block_size,
                          cfg.n_kv_heads, cfg.head_dim))
        vc = torch.zeros_like(kc)
        toks = torch.zeros((S,), dtype=torch.long)
        toks[:len(prompt)] = torch.tensor(prompt)
        with torch.no_grad():
            logits = prefill(S, p, kc, vc, torch.arange(1, nb + 1), toks,
                             len(prompt))
        return _np(kc[:, 1:]), _np(vc[:, 1:]), _np(logits)

    local_eng = PagedEngine(cfg, p, e, device="cpu")
    decode_eng = PagedEngine(cfg, p, e, device="cpu")

    async def main():
        local = [await _collect(local_eng, q, 8) for q in prompts]
        disagg = [await _collect(decode_eng, q, 8,
                                 prefilled=remote_prefill(q))
                  for q in prompts]
        return local, disagg

    local, disagg = asyncio.run(main())
    return local, disagg, decode_eng.stats()


def engine_aborts(shape, tree, ecfg, prefix, n=4):
    """``n`` clients take one token and walk away; stats once the engine's
    abort sweep has run."""
    eng = _engine(shape, tree, ecfg)

    async def main():
        for i in range(n):
            gen = eng.generate_stream(prefix + [i], max_tokens=64)
            async for _ in gen:
                break  # one token, then disconnect
            await gen.aclose()
        for _ in range(200):
            await asyncio.sleep(0.01)
            st = eng.stats()
            if st["blocks_in_use"] == 0 and st["active_slots"] == 0:
                break
        return eng.stats()

    return asyncio.run(main())


def dense_generate(shape, tree, prompts, max_new_tokens, **kw):
    return generate(_cfg(shape), params_from_jax(tree, "cpu"), prompts,
                    max_new_tokens=max_new_tokens, **kw)


def stream_generate(shape, tree, prompt, max_new_tokens):
    return list(generate_stream(_cfg(shape), params_from_jax(tree, "cpu"),
                                prompt, max_new_tokens=max_new_tokens))


def naive_greedy(shape, tree, prompt, n):
    """Recompute-from-scratch greedy decoding through ``forward``."""
    cfg, p = _cfg(shape), params_from_jax(tree, "cpu")
    toks = list(prompt)
    with torch.no_grad():
        for _ in range(n):
            logits = tl.forward(cfg, p, torch.tensor([toks]))
            toks.append(int(torch.argmax(logits[0, -1])))
    return toks[len(prompt):]


def llm_server(checkpoint_path, max_new_tokens, batch, stream):
    server = LLMServer(LLMConfig(
        max_new_tokens=max_new_tokens, checkpoint_path=checkpoint_path,
        model_overrides=dict(dtype=torch.float32)), device="cpu")
    return server(batch), list(server(stream))


def import_check(root):
    """Import every ray_tpu_torch module in a fresh interpreter; returns its
    (exit code, stdout, stderr)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ray_tpu' or m.startswith('ray_tpu.')]\n"
        "assert len(names) >= 16, names\n"
        "assert {'ray_tpu_torch.parallel.mesh', "
        "'ray_tpu_torch.parallel.ring_attention', "
        "'ray_tpu_torch.parallel.ulysses'} <= set(names), names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout, out.stderr


# -- the harness itself --------------------------------------------------------


def sleep(seconds):
    """A call that outlasts a short ``_port_proc.spawn`` timeout."""
    time.sleep(seconds)
    return seconds


# -- models/vit.py, parallel/moe.py ------------------------------------------


def _vit_cfg(shape, impl):
    from ray_tpu_torch.models.vit import ViTConfig

    return ViTConfig(dtype=torch.float32, param_dtype=torch.float32,
                     attention_impl=impl, **shape)


def vit_patchify(shape, images):
    from ray_tpu_torch.models.vit import patchify

    return _np(patchify(_vit_cfg(shape, "xla"), _T(images)))


def vit_facts(images):
    """The tiny config's parameter count from ``init_params`` (seeded twice)
    and its forward on ``images``; the presets' ``num_params``."""
    from ray_tpu_torch.models import vit as tv

    cfg = tv.ViTConfig.tiny()
    p = tv.init_params(cfg, 0, device="cpu")
    again = tv.init_params(cfg, 0, device="cpu")
    logits = tv.forward(cfg, p, _T(images))
    return dict(
        n=sum(int(t.numel()) for t in tv.tree_leaves(p)),
        same=all(torch.equal(a, b) for a, b in zip(tv.tree_leaves(p),
                                                   tv.tree_leaves(again))),
        head_zero=bool((p["head"] == 0).all()),
        shape=tuple(logits.shape), dtype=str(logits.dtype),
        finite=bool(torch.isfinite(logits).all()),
        num_params={name: getattr(tv.ViTConfig, name)().num_params()
                    for name in ("tiny", "base", "large")},
        head_dim=tv.ViTConfig.base().head_dim,
        num_patches=tv.ViTConfig.base().num_patches)


def vit_forward(shape, tree, images, impl):
    from ray_tpu_torch.models.vit import forward as vit_fwd

    with torch.no_grad():
        return _np(vit_fwd(_vit_cfg(shape, impl),
                           params_from_jax(tree, "cpu"), _T(images)))


def vit_train(shape, tree, images, labels, steps, lr, impl="flash"):
    """Losses of ``steps`` steps of the ViT ``make_train_step`` on one
    device from the carried weights, and the parameters after them."""
    from ray_tpu_torch.models.vit import make_train_step as vit_step

    init_state, shard_state, train_step, dev = vit_step(
        _vit_cfg(shape, impl), learning_rate=lr, device="cpu")
    state = shard_state(init_state(params_from_jax(tree, "cpu")))
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, _T(images), _T(labels))
        losses.append(float(loss))
    return losses, tree_map(_np, state[0])


def moe_single(tree, x, top_k, capacity_factor, with_grads=False):
    """``moe_ffn`` on the carried parameters: (y, aux), and with
    ``with_grads`` the gradients of mean(y²)."""
    from ray_tpu_torch.parallel.moe import moe_ffn

    params = {k: _T(v).requires_grad_() for k, v in tree.items()}
    y, aux = moe_ffn(params, _T(x), top_k=top_k,
                     capacity_factor=capacity_factor)
    if not with_grads:
        return _np(y), float(aux)
    y.square().mean().backward()
    return _np(y), float(aux), {k: _np(p.grad) for k, p in params.items()}


def moe_route(logits, top_k, capacity):
    from ray_tpu_torch.parallel.moe import _route

    return tuple(_np(t) for t in _route(_T(logits), top_k, capacity))


def vit_moe_cuda_default_errors():
    """``cuda_default_errors`` for the ViT and MoE entry points."""
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.parallel.moe import init_moe_params

    cfg = vit.ViTConfig.tiny()
    return _errors({
        "vit.init_params": lambda: vit.init_params(cfg),
        "vit.make_train_step": lambda: vit.make_train_step(cfg)[0](0),
        "init_moe_params": lambda: init_moe_params(0, 16, 32, 8),
    })
