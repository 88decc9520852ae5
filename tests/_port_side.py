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


def _remote_prefill(cfg, p, e):
    """``prompt -> (k, v, last logits)`` prefilled in a pool of its own,
    as a remote prefill worker hands them to a decode engine."""
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

    return remote_prefill


def engine_disaggregated(shape, tree, ecfg, prompts):
    """(local tokens, tokens admitted with KV prefilled in another pool,
    stats of the decode engine)."""
    cfg = _cfg(shape)
    p = params_from_jax(tree, "cpu")
    e = EngineConfig(**ecfg)
    remote_prefill = _remote_prefill(cfg, p, e)
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
        "'ray_tpu_torch.parallel.ulysses', 'ray_tpu_torch.train', "
        "'ray_tpu_torch.train.trainer', "
        "'ray_tpu_torch.train.pipeline_actors', 'ray_tpu_torch.dag', "
        "'ray_tpu_torch.dag._compiled', "
        "'ray_tpu_torch.experimental.channel', "
        "'ray_tpu_torch.cluster_utils', "
        "'ray_tpu_torch.util.placement_group', 'ray_tpu_torch.serve', "
        "'ray_tpu_torch.serve._http', 'ray_tpu_torch.serve._grpc', "
        "'ray_tpu_torch.util.state', "
        "'ray_tpu_torch.llm.serving_patterns', 'ray_tpu_torch.data', "
        "'ray_tpu_torch.data.dataset', 'ray_tpu_torch.data._executor', "
        "'ray_tpu_torch.data._logical.planner', "
        "'ray_tpu_torch.data.datasource', "
        "'ray_tpu_torch._private.simnode', "
        "'ray_tpu_torch.scripts', 'ray_tpu_torch.rllib.env_runner', "
        "'ray_tpu_torch.rllib.ppo', 'ray_tpu_torch.rllib.impala', "
        "'ray_tpu_torch.rllib.appo', 'ray_tpu_torch.rllib.multi_agent', "
        "'ray_tpu_torch.util.actor_pool', 'ray_tpu_torch.util.queue', "
        "'ray_tpu_torch.util.multiprocessing', "
        "'ray_tpu_torch.util.joblib', "
        "'ray_tpu_torch.runtime_env', "
        "'ray_tpu_torch.util.collective', "
        "'ray_tpu_torch.util.collective.nccl_group', "
        "'ray_tpu_torch.experimental.rdt', "
        "'ray_tpu_torch.experimental.device_channel', "
        "'ray_tpu_torch.gpu.slice', 'ray_tpu_torch.gpu.preemption', "
        "'ray_tpu_torch.gpu.profiler', 'ray_tpu_torch.tune', "
        "'ray_tpu_torch.tune._scheduler', 'ray_tpu_torch.tune._search', "
        "'ray_tpu_torch.tune._session', 'ray_tpu_torch.tune._trial', "
        "'ray_tpu_torch.job_submission', "
        "'ray_tpu_torch.job_submission._manager', "
        "'ray_tpu_torch.job_submission._supervisor', "
        "'ray_tpu_torch.autoscaler', 'ray_tpu_torch.autoscaler.gcp', "
        "'ray_tpu_torch.autoscaler.launcher', "
        "'ray_tpu_torch.autoscaler.fake_provider', "
        "'ray_tpu_torch.dashboard'} <= set(names), names\n"
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


# -- rllib/ ------------------------------------------------------------------


def convert_nest(tree):
    """``params_from_jax`` of a nest of dicts, lists and tuples → the same
    nest of (numpy value, dtype name, torch type name) leaves."""
    from ray_tpu_torch.models.convert import nest_map

    return nest_map(lambda t: (_np(t), str(t.dtype), type(t).__name__),
                    params_from_jax(tree, "cpu"))


def rl_learner(kind, args, kwargs, weights=None, calls=(), target=False):
    """The port's ``ray_tpu_torch.rllib.<kind>(*args, **kwargs)`` on the
    CPU: ``weights`` (JAX's nest) copied in with ``set_weights`` (and, with
    ``target``, made its target network too, as JAX's APPO starts from its
    initial parameters), then each of ``calls``, (method, args, kwargs),
    run in order. Returns the calls' results and the final weights."""
    import ray_tpu_torch.rllib as tr

    lrn = getattr(tr, kind)(*args, device="cpu", **kwargs)
    if weights is not None:
        lrn.set_weights(weights)
    if target:
        lrn.target_params = params_from_jax(weights, "cpu")
    out = [getattr(lrn, name)(*a, **kw) for name, a, kw in calls]
    return out, lrn.get_weights()


def rl_policy_logits(weights, obs):
    """``policy_logits`` of JAX-nested ``weights`` on ``obs``."""
    from ray_tpu_torch.rllib.learner import policy_logits

    with torch.no_grad():
        return _np(policy_logits(params_from_jax(weights, "cpu"), _T(obs)))


def rl_mlp_apply(weights, x):
    from ray_tpu_torch.rllib.learner import mlp_apply

    with torch.no_grad():
        return _np(mlp_apply(params_from_jax(weights, "cpu"), _T(x)))


def rl_ppo_loss(weights, mb, clip, vf_coeff, entropy_coeff):
    """The port's PPO ``_loss`` (total, pg, vf, entropy) on a minibatch."""
    from ray_tpu_torch.rllib.learner import PPO_COLUMNS, _loss, batch_tensors

    with torch.no_grad():
        total, aux = _loss(params_from_jax(weights, "cpu"),
                           batch_tensors(mb, PPO_COLUMNS, "cpu"), clip,
                           vf_coeff, entropy_coeff)
    return [float(total), *(float(a) for a in aux)]


def rl_gae(*args, **kwargs):
    from ray_tpu_torch.rllib import compute_gae

    return compute_gae(*args, **kwargs)


def rl_replay(batches, capacity, seed, draws):
    """A port ``ReplayBuffer`` fed ``batches``: its length and ``draws``
    samples of the given sizes."""
    from ray_tpu_torch.rllib import ReplayBuffer

    buf = ReplayBuffer(capacity=capacity, seed=seed)
    for b in batches:
        buf.add_batch(b)
    return len(buf), [buf.sample(n) for n in draws]


def rl_connectors(obs, norm_chunks):
    """FlattenObs then a doubling Lambda on ``obs``; and NormalizeObs's
    output on each of ``norm_chunks`` in turn."""
    from ray_tpu_torch.rllib.connectors import (ConnectorPipeline,
                                                FlattenObs, Lambda,
                                                NormalizeObs)

    pipe = ConnectorPipeline([
        FlattenObs(),
        Lambda(lambda b: {**b, "obs": b["obs"] * 2.0}),
    ])
    norm = NormalizeObs()
    return (pipe({"obs": obs})["obs"],
            [norm({"obs": c})["obs"] for c in norm_chunks])


def rl_cuda_default_errors():
    """Each learner with no device: the error where CUDA is missing."""
    import ray_tpu_torch.rllib as tr

    return _errors(dict(
        PPOLearner=lambda: tr.PPOLearner(4, 2),
        VTraceLearner=lambda: tr.VTraceLearner(4, 2),
        APPOLearner=lambda: tr.APPOLearner(4, 2),
        DQNLearner=lambda: tr.DQNLearner(4, 2),
        SACLearner=lambda: tr.SACLearner(3, 1),
        BCLearner=lambda: tr.BCLearner(4, 2, discrete=True),
        CQLLearner=lambda: tr.CQLLearner(4, 2)))


# -- train/ --------------------------------------------------------------------


def _zeros_like_nest(skeleton):
    from ray_tpu_torch.models.convert import nest_map

    return nest_map(lambda a: torch.zeros(np.shape(a), dtype=torch.float32)
                    if isinstance(a, np.ndarray) else a, skeleton)


def ckpt_restore_whole(root, skeleton, how="load_consolidated", rank=0):
    """Restore the checkpoint at ``root`` into a whole skeleton of torch
    zeros shaped as ``skeleton``'s arrays (Python numbers kept), by
    ``how`` (``load_state`` reads rank file ``rank``): the result as
    numpy, or the ``ValueError``'s text."""
    from ray_tpu_torch.models.convert import nest_map
    from ray_tpu_torch.train import Checkpoint

    ckpt = Checkpoint(root)
    sk = _zeros_like_nest(skeleton)
    try:
        out = (ckpt.load_state(sk, rank) if how == "load_state"
               else ckpt.load_consolidated(sk))
    except ValueError as e:
        return str(e)
    return nest_map(lambda t: _np(t) if torch.is_tensor(t) else t, out)


def ckpt_num_ranks(root):
    from ray_tpu_torch.train import Checkpoint

    return Checkpoint(root).num_ranks()


def ckpt_snapshot_whole(arrays):
    """``snapshot_with_meta`` of whole tensors (no specs, no mesh)."""
    from ray_tpu_torch.train import snapshot_with_meta

    return snapshot_with_meta({k: _T(a) for k, a in arrays.items()})


def ckpt_manager_recovers(root):
    """``test_train.py::test_checkpoint_manager_recovers_existing`` on the
    port's ``CheckpointManager``: (finalize's result is not None, the new
    manager's latest path, the first's)."""
    from ray_tpu_torch.train import CheckpointManager

    mgr = CheckpointManager(root, "recover", num_to_keep=3)
    os.makedirs(mgr.staging_dir(0))
    np.savez(os.path.join(mgr.staging_dir(0), "rank_0.npz"), w=np.ones(2))
    done = mgr.finalize(0, {"loss": 1.0}, expected_ranks=1) is not None
    mgr2 = CheckpointManager(root, "recover", num_to_keep=3)
    return (done, mgr2.latest and mgr2.latest.path,
            mgr.latest and mgr.latest.path)


def ckpt_manager_memory_fs():
    """``test_storage_plane.py::test_checkpoint_roundtrip_through_memory_fs``
    on the port: save → finalize → top-K retention → restore → recovery,
    all through memory://. Returns what that test asserts."""
    from ray_tpu_torch.train import AsyncCheckpointWriter, CheckpointManager

    writer = AsyncCheckpointWriter()
    mgr = CheckpointManager("memory://port_ckpts", "run1", num_to_keep=2,
                            metric="loss", mode="min")
    w = torch.arange(6.0).reshape(2, 3)
    steps = []
    for step, loss in [(1, 5.0), (2, 3.0), (3, 4.0)]:
        writer.save({"w": w, "step": step}, mgr.staging_dir(step),
                    manifest={"metrics": {"loss": loss}}).result(60)
        ckpt = mgr.finalize(step, {"loss": loss}, expected_ranks=1)
        steps.append(ckpt and ckpt.step)
    restored = mgr.best.load_state({"w": torch.zeros(2, 3), "step": 0})
    mgr2 = CheckpointManager("memory://port_ckpts", "run1", num_to_keep=2,
                             metric="loss", mode="min")
    return dict(
        finalized=steps, kept=sorted(c.step for c in mgr.checkpoints),
        best=mgr.best.step, latest=mgr.latest.step,
        restored=_np(restored["w"]), restored_step=restored["step"],
        recovered=sorted(c.step for c in mgr2.checkpoints),
        recovered_best_loss=mgr2.best.metrics["loss"])


def ckpt_snapshot_owns(shape, tree, tokens, lr):
    """A snapshot of the train state taken before a step (whose AdamW
    updates parameters and moments in place) is unchanged after it: the
    snapshot, the same state's snapshot after the step, and a second
    snapshot of the pre-step state taken before the step. Also a
    ``save`` before the step: the file it writes holds the pre-step
    values."""
    import tempfile

    from ray_tpu_torch.train import (AsyncCheckpointWriter, Checkpoint,
                                     snapshot_to_host, train_state_tree)
    from ray_tpu_torch.train._checkpoint import _flatten_with_paths

    cfg = _cfg(shape)
    init_state, _, train_step, _ = tl.make_train_step(
        cfg, learning_rate=lr, loss_chunk=0, device="cpu")
    state = init_state(params_from_jax(tree, "cpu"))
    toks = _T(tokens)
    state, _ = train_step(state, toks)
    before = snapshot_to_host(train_state_tree(*state))
    copy = {k: v.copy() for k, v in before.items()}
    root = tempfile.mkdtemp(prefix="port_ckpt_")
    fut = AsyncCheckpointWriter().save(train_state_tree(*state), root)
    state, _ = train_step(state, toks)
    fut.result(60)
    after = snapshot_to_host(train_state_tree(*state))
    skeleton = train_state_tree(*init_state(1))
    from_file = Checkpoint(root).load_state(skeleton)
    file_vals = {k: (int(v) if k == "/1/0/0" else _np(v))
                 for k, v in _flatten_with_paths(from_file).items()}
    return before, copy, after, file_vals


def ckpt_fresh_state(shape, tree, lr):
    """The snapshot of ``train_state_tree`` of a state that has not
    stepped, and facts of a fresh optimizer's state after
    ``load_train_state`` of it."""
    from ray_tpu_torch.train import (load_train_state, snapshot_to_host,
                                     train_state_tree)
    from ray_tpu_torch.train._checkpoint import _flatten_with_paths

    init_state, _, _, _ = tl.make_train_step(
        _cfg(shape), learning_rate=lr, loss_chunk=0, device="cpu")
    params, opt = init_state(params_from_jax(tree, "cpu"))
    host = snapshot_to_host(train_state_tree(params, opt))
    params2, opt2 = init_state(1)
    load_train_state(train_state_tree(params, opt), params2, opt2)
    st = [opt2.state[p] for p in tl.tree_leaves(params2)]
    flat, flat2 = _flatten_with_paths(params), _flatten_with_paths(params2)
    return host, dict(
        built=len(st) == len(flat2),
        steps={float(s["step"]) for s in st},
        zero=all(not s["exp_avg"].any() and not s["exp_avg_sq"].any()
                 for s in st),
        dtypes={str(s["exp_avg"].dtype) for s in st},
        params_equal=flat.keys() == flat2.keys() and all(
            torch.equal(flat[k], flat2[k]) for k in flat))


# -- the runtime: tensors through the object plane, the engine's metrics -----


def _tensor_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, generator=g)
    return {
        "bf16": x.to(torch.bfloat16),
        "fp32_transposed": x.t(),  # not contiguous
        "int64_scalar": torch.tensor(7),
        "bool": x > 0,
        "empty": torch.empty(0, 4),
        "requires_grad": x.clone().requires_grad_(),
        "large_bf16": torch.randn(256, 1024, generator=g).to(torch.bfloat16),
    }


def _same_tensor(a, b) -> bool:
    return (type(a) is torch.Tensor and a.dtype == b.dtype
            and a.shape == b.shape and a.device == b.device
            and a.requires_grad == b.requires_grad
            and bool(torch.equal(a.detach(), b.detach())))


def tensor_roundtrip():
    """Each case through the port's serialize / deserialize (read-only
    bytes, as the shared-memory store hands them out): {name: (same
    tensor, out-of-band buffers)}."""
    from ray_tpu_torch._private import serialization as ser

    out = {}
    for name, t in _tensor_cases().items():
        so = ser.serialize({"t": t, "n": np.arange(3)})
        back = ser.deserialize(memoryview(so.to_bytes()))
        out[name] = (_same_tensor(back["t"], t)
                     and back["n"].tolist() == [0, 1, 2], len(so.buffers))
    return out


def tensor_cluster_roundtrip():
    """Tensors through a cluster of the port on the CPU: put by the driver
    and read by a task, made by a task and read by the driver. {name:
    (task saw the same tensor, driver got the same tensor)}."""
    import ray_tpu_torch as rt

    cases = _tensor_cases()

    @rt.remote
    def echo(t, want_sum):
        import torch as th

        return float(t.detach().double().sum()) == want_sum, t.clone()

    rt.init(num_cpus=2)
    try:
        out = {}
        for name, t in cases.items():
            want = float(t.detach().double().sum())
            seen, back = rt.get(echo.remote(rt.put(t), want), timeout=120)
            out[name] = (seen, _same_tensor(back, t))
        return out
    finally:
        rt.shutdown()


def _gauges():
    from ray_tpu_torch.util.metrics import snapshot_all

    return sorted((s["name"], s["value"]) for s in snapshot_all()
                  if s["name"].startswith("rt_llm_")
                  and s["type"] == "gauge")


def engine_metrics(shape, tree, ecfg, prompts, max_tokens):
    """The engine's gauges from the port's metrics registry once every
    prompt has its first token (all admitted), then once all finished."""
    from ray_tpu_torch.util.metrics import reset_registry

    reset_registry()
    eng = _engine(shape, tree, ecfg)

    async def main():
        gens = [eng.generate_stream(p, max_tokens=max_tokens,
                                    temperature=0.0) for p in prompts]
        for g in gens:
            await g.__anext__()
        mid = _gauges()
        for g in gens:
            async for _ in g:
                pass
        return mid, _gauges()

    return asyncio.run(main())


# -- train/pipeline_actors.py ------------------------------------------------


def pipeline_actors(shape, tree, tokens, lr, steps, n_stages, n_micro):
    """``ActorPipeline`` then ``CompiledActorPipeline`` on a CPU cluster of
    the port, from the carried weights (``tree``, None: the port's
    ``init_params`` from seed 0): {"eager" / "compiled": (losses of
    ``steps`` steps on ``tokens``, each stage's ``stats``)}."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train.pipeline_actors import (ActorPipeline,
                                                     CompiledActorPipeline)

    cfg = _cfg(shape)
    rt.init(num_cpus=4)
    try:
        out = {}
        for name, klass in (("eager", ActorPipeline),
                            ("compiled", CompiledActorPipeline)):
            pipe = klass(cfg, n_stages, n_micro, learning_rate=lr, seed=0,
                         params=tree, device="cpu")
            try:
                losses = [pipe.train_step(tokens, timeout=300)
                          for _ in range(steps)]
                if name == "compiled":
                    pipe.teardown()
                out[name] = (losses, pipe.stage_stats())
            finally:
                pipe.shutdown()
        return out
    finally:
        rt.shutdown()


def train_from_seed(shape, tokens, lr, steps, seed=0):
    """Losses of the port's ``make_train_step`` from ``init_params(seed)``."""
    cfg = _cfg(shape)
    init_state, shard_state, train_step, dev = tl.make_train_step(
        cfg, learning_rate=lr, device="cpu")
    state = shard_state(init_state(seed))
    toks = _T(tokens).to(dev)
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, toks)
        losses.append(float(loss))
    return losses


# -- the serve apps: llm/__init__.py, llm/serving_patterns.py ----------------


def _llm_config(checkpoint_path, max_new_tokens):
    return LLMConfig(max_new_tokens=max_new_tokens,
                     checkpoint_path=checkpoint_path,
                     model_overrides=dict(dtype=torch.float32))


def apps_start(num_cpus):
    """A cluster of the port in this process, traced (``list_spans``)."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=num_cpus, system_config={"tracing_enabled": True})
    atexit.register(apps_stop)


def apps_stop():
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve

    if rt.is_initialized():
        try:
            serve.shutdown()
        finally:
            rt.shutdown()


def openai_app(checkpoint_path, max_new_tokens):
    """``build_openai_app`` on the CPU and the HTTP ingress: the base URL."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_openai_app

    build_openai_app(_llm_config(checkpoint_path, max_new_tokens),
                     deployment_name="v1", device="cpu")
    return serve.start(http_port=0)


def _actor_ids():
    """Every actor's id, the serve controller's among them."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.util.state import list_actors

    serve.status()  # the controller, made now if it is not yet
    return {a["actor_id"] for a in list_actors()}


def _delete_and_reap(name, before, timeout=60.0):
    """``serve.delete`` the app, then the states of the actors made since
    ``before``: once its replica is dead (the actors its ingress made live
    on, as in the JAX package), and after this kills those."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.util.state import list_actors

    def made():
        return [a for a in list_actors() if a["actor_id"] not in before]

    def wait(done):
        deadline = time.monotonic() + timeout
        while not done(made()) and time.monotonic() < deadline:
            time.sleep(0.2)
        return made()

    replica = f"serve:{name}:"
    serve.delete(name)
    wait(lambda m: all(a["state"] == "DEAD" for a in m
                       if a["name"].startswith(replica)))
    time.sleep(1.0)  # the replica's death is recorded: its actors stay
    deleted = {(a["name"].startswith(replica), a["state"]) for a in made()}
    cw = rt.get_core_worker()
    for a in made():
        if a["state"] == "ALIVE":
            cw.run_sync(cw.kill_actor(bytes.fromhex(a["actor_id"]), True), 30)
    killed = wait(lambda m: all(a["state"] == "DEAD" for a in m))
    return sorted(deleted), sorted({a["state"] for a in killed})


def pd_app(checkpoint_path, max_new_tokens, ecfg, prompts):
    """``build_pd_app`` (1 prefill worker, 2 decode engines) on the CPU:
    each prompt's completion in turn, the ingress's stats, and the states
    of its actors after ``serve.delete`` (``_delete_and_reap``)."""
    from ray_tpu_torch.llm.serving_patterns import build_pd_app

    before = _actor_ids()
    handle = build_pd_app(_llm_config(checkpoint_path, max_new_tokens),
                          num_prefill=1, num_decode=2,
                          deployment_name="pd", engine_config=ecfg,
                          device="cpu")
    outs = [handle.remote({"prompt": p}).result(timeout=300)
            for p in prompts]
    stats = handle.method("stats").remote().result(timeout=60)
    return outs, stats, _delete_and_reap("pd", before)


def dp_app(checkpoint_path, max_new_tokens, ecfg, prompts):
    """``build_dp_app`` (dp 2) on the CPU, the prompts sent at once: each
    completion, and the engines' states after ``serve.delete``
    (``_delete_and_reap``)."""
    from ray_tpu_torch.llm.serving_patterns import build_dp_app

    before = _actor_ids()
    handle = build_dp_app(_llm_config(checkpoint_path, max_new_tokens),
                          dp_size=2, deployment_name="dp",
                          engine_config=ecfg, device="cpu")
    refs = [handle.remote({"prompt": p}) for p in prompts]
    outs = [r.result(timeout=300) for r in refs]
    return outs, _delete_and_reap("dp", before)


def engine_streams(checkpoint_path, max_new_tokens, ecfg, prompts):
    """An ``LLMEngine`` actor on the CPU: each prompt's streamed token ids
    (the prompts streamed at once), and its stats."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import LLMEngine

    eng = LLMEngine.remote(_llm_config(checkpoint_path, max_new_tokens),
                           EngineConfig(**ecfg), device="cpu")
    try:
        gens = [eng.completions_stream.options(
            num_returns="streaming").remote(p) for p in prompts]
        toks = [[rt.get(r, timeout=120) for r in g] for g in gens]
        return toks, rt.get(eng.stats.remote(), timeout=60)
    finally:
        rt.kill(eng)


def batch_completions(checkpoint_path, max_new_tokens, prompts, parallelism):
    """``batch_completions`` over ``from_items`` on the CPU: each row's
    (prompt, completion)."""
    import ray_tpu_torch.data as rd
    from ray_tpu_torch.llm import batch_completions as run

    ds = rd.from_items([{"prompt": p} for p in prompts],
                       parallelism=parallelism)
    rows = run(_llm_config(checkpoint_path, max_new_tokens), ds,
               device="cpu").take_all()
    return [(str(r["prompt"]), str(r["completion"])) for r in rows]


def data_device_put(columns):
    """``test_torch_data_parity.py``'s ``_device_put_batches`` on the
    port, ``device="cpu"``: each column's (dtype name, values) or the
    error's type name; then whether ``device_put=True`` without a device
    raises where CUDA is absent."""
    import ray_tpu_torch as rt
    import ray_tpu_torch.data as rd

    rt.init(num_cpus=2)
    try:
        batches = {}
        for name, col in columns.items():
            ds = rd.Dataset(_refs=[rt.put({"c": col})])
            try:
                (batch,) = list(ds.iter_batches(
                    batch_size=None, device_put=True, device="cpu"))
                t = batch["c"]
                assert t.device.type == "cpu"
                vals = (t.float() if t.dtype == torch.bfloat16 else t)
                batches[name] = (str(t.dtype).split(".")[-1],
                                 vals.numpy().tolist())
            except Exception as e:  # the type of the refusal is compared
                batches[name] = type(e).__name__
        ds = rd.Dataset(_refs=[rt.put({"c": np.arange(3)})])
        try:
            list(ds.iter_batches(device_put=True))
            error = None
        except RuntimeError as e:
            error = str(e)
        return dict(batches=batches, default_device=dict(
            cuda_available=torch.cuda.is_available(), error=error))
    finally:
        rt.shutdown()


def spans(limit=4000):
    from ray_tpu_torch.util import tracing

    return tracing.list_spans(limit=limit)


def llm_names():
    from ray_tpu_torch import llm
    from ray_tpu_torch.llm import serving_patterns

    return list(llm.__all__), list(serving_patterns.__all__)


def apps_cuda_default_errors():
    """What the apps' model holders raise on the default device without
    CUDA ({name: message}); None where one built (a machine with CUDA)."""
    from ray_tpu_torch.llm import LLMEngine
    from ray_tpu_torch.llm.serving_patterns import PrefillWorker

    out = {"cuda_available": torch.cuda.is_available()}
    for name, make in (("LLMEngine", lambda: LLMEngine._cls(LLMConfig())),
                       ("PrefillWorker",
                        lambda: PrefillWorker._cls(LLMConfig()))):
        try:
            make()
            out[name] = None
        except RuntimeError as e:
            out[name] = str(e)
    return out


# -- rllib algorithms ----------------------------------------------------------


def _rl_pipeline(names):
    """A port ``ConnectorPipeline`` of the named connectors (no-arg
    classes of ``rllib/connectors.py``), or None for no names."""
    from ray_tpu_torch.rllib import connectors

    if not names:
        return None
    return connectors.ConnectorPipeline(
        [getattr(connectors, n)() for n in names])


def rl_runner(cls, args, kwargs, weights, calls, connectors=()):
    """The port's ``EnvRunner`` or ``MultiAgentEnvRunner`` built in this
    process (the actor's class, ``_cls``) with ``connectors`` as its
    env_to_module pipeline, given ``weights``, then each of ``calls``,
    (method, args, kwargs), in order: each result, or ("raised", type,
    message)."""
    import ray_tpu_torch.rllib as tr

    kwargs = dict(kwargs)
    if connectors:
        kwargs["env_to_module"] = _rl_pipeline(connectors)
    r = getattr(tr, cls)._cls(*args, **kwargs)
    r.set_weights(weights)
    out = []
    for name, a, kw in calls:
        try:
            out.append(getattr(r, name)(*a, **kw))
        except Exception as e:  # compared with JAX's runner's error
            out.append(("raised", type(e).__name__, str(e)))
    return out


def rl_start(num_cpus):
    """A cluster of the port in this process, for the algorithms."""
    import ray_tpu_torch as rt

    rt.init(num_cpus=num_cpus)
    atexit.register(rt.shutdown)


def _rl_config(kind, builder, env_maker=None, rows=None, offline=None,
               device="cpu"):
    """``ray_tpu_torch.rllib.<kind>Config()`` after ``builder``'s calls,
    (method, args, kwargs); ``env_maker`` (cloudpickled bytes) as a
    multi-agent env; ``rows`` as a Dataset given to ``offline_data`` with
    ``offline``'s keywords; then ``training(device=device)`` unless
    ``device`` is None (the learners' own default)."""
    import cloudpickle

    import ray_tpu_torch.data as rtd
    import ray_tpu_torch.rllib as tr

    cfg = getattr(tr, f"{kind}Config")()
    if env_maker is not None:
        cfg.environment(cloudpickle.loads(env_maker))
    if rows is not None:
        cfg.offline_data(rtd.from_items(rows, parallelism=4),
                         **(offline or {}))
    for name, a, kw in builder:
        if kw.get("env_to_module"):  # connector names: a port pipeline
            kw = dict(kw, env_to_module=_rl_pipeline(kw["env_to_module"]))
        getattr(cfg, name)(*a, **kw)
    if device is not None:
        cfg.training(device=device)
    return cfg


def rl_algo(kind, builder, weights=None, iters=1, restore=None, save=None,
            evaluate=None, stop_above=None, deadline_s=None, episodes=None,
            **cfg_kw):
    """Build ``kind`` on the CPU (``_rl_config``), restore the checkpoint
    at ``restore`` or copy in ``weights``, run up to ``iters`` iterations
    (fewer once an episode return mean passes ``stop_above`` or
    ``deadline_s`` has passed), save a checkpoint to ``save``; the results,
    the final weights, with ``evaluate`` BC's or CQL's greedy actions on
    those observations, with ``episodes`` the algorithm's ``evaluate``."""
    algo = _rl_config(kind, builder, **cfg_kw).build()
    try:
        if restore is not None:
            algo.restore_checkpoint(restore)
        elif weights is not None:
            algo.set_weights(weights)
        start, results = time.monotonic(), []
        for _ in range(iters):
            results.append(algo.train())
            ret = results[-1].get("episode_return_mean", float("nan"))
            if stop_above is not None and ret > stop_above:
                break
            if deadline_s is not None and (
                    time.monotonic() - start > deadline_s):
                break
        if save is not None:
            algo.save_checkpoint(save)
        out = {"results": results, "weights": algo.get_weights()}
        if evaluate is not None:
            out["actions"] = [algo.learner.act(o) for o in evaluate]
        if episodes is not None:
            out["evaluate"] = algo.evaluate(num_episodes=episodes)
    finally:
        if hasattr(algo, "stop"):
            algo.stop()
    return out


def rl_build_errors(cases):
    """What building each config raises: {name: (type, message)}, or None
    where it built. ``cases``: {name: (kind, builder, cfg keywords)}."""
    out = {"cuda_available": torch.cuda.is_available()}
    for name, (kind, builder, kw) in cases.items():
        try:
            algo = _rl_config(kind, builder, **kw).build()
            out[name] = None
            if hasattr(algo, "stop"):
                algo.stop()
        except Exception as e:
            out[name] = (type(e).__name__, str(e))
    return out


def rl_names():
    import ray_tpu_torch.rllib as tr

    return list(tr.__all__), sorted(n for n in dir(tr)
                                    if not n.startswith("_"))


# -- util/collective, experimental/rdt, experimental/device_channel ----------

_COL_MEMBERS = []


def col_start(num_cpus, world):
    """A cluster of the port in this process and ``world`` member actors
    (``_col_cases.Member``, shipped by value)."""
    import cloudpickle

    import _col_cases
    import ray_tpu_torch as rt

    cloudpickle.register_pickle_by_value(_col_cases)
    rt.init(num_cpus=num_cpus)
    atexit.register(rt.shutdown)
    member = rt.remote(num_cpus=1)(_col_cases.Member)
    _COL_MEMBERS[:] = [member.remote(r, "ray_tpu_torch") for r in range(world)]
    rt.get([m.call.remote(cloudpickle.dumps(lambda r, p: r))
            for m in _COL_MEMBERS], timeout=120)


def col_run(case, world, *args):
    """``_col_cases.<case>(rank, "ray_tpu_torch", *args)`` on the first
    ``world`` members at once: the results in rank order."""
    import cloudpickle

    import _col_cases
    import ray_tpu_torch as rt

    fn = cloudpickle.dumps(getattr(_col_cases, case))
    return rt.get([m.call.remote(fn, *args) for m in _COL_MEMBERS[:world]],
                  timeout=120)


def col_world_one(x):
    """``_col_cases.world_one`` in this process (a gloo group of one)."""
    import _col_cases

    return _col_cases.world_one(0, "ray_tpu_torch", "gloo", "world-one", x)


def col_groups_beside_default(storage, tag):
    """``_col_cases.port_groups_beside_default`` as a 2-worker TorchTrainer
    on this process's cluster: the reports."""
    import _col_cases
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    result = TorchTrainer(
        _col_cases.port_groups_beside_default,
        train_loop_config={"tag": tag},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name=tag, storage_path=storage)).fit()
    return result.metrics_history


def rdt_cases():
    """``test_rdt.py``'s in-process cases on the port: {name: facts}."""
    import gc

    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.experimental.rdt import device_object_manager

    def roundtrip(v):
        return ser.deserialize(memoryview(ser.serialize(v).to_bytes()))

    out = {}
    x = torch.arange(1024.0) * 2.0
    xb = x.to(torch.bfloat16)
    out["same_process_is"] = (roundtrip(x) is x, roundtrip(xb) is xb)

    y = torch.linspace(0.0, 1.0, 333, dtype=torch.bfloat16)
    expect = y.clone()
    blob = ser.serialize(y).to_bytes()
    del y
    gc.collect()
    back = ser.deserialize(memoryview(blob))
    out["dropped_rebuild"] = (type(back).__name__, str(back.dtype),
                              bool(torch.equal(back, expect)))

    tree = {"w": torch.ones(4, 4), "meta": "adam", "step": 7}
    t = roundtrip(tree)
    out["pytree"] = (t["meta"], t["step"], t["w"] is tree["w"])

    GLOBAL_CONFIG.apply_system_config({"device_object_transport": False})
    try:
        z = torch.arange(16.0)
        n_before = len(device_object_manager())
        blob = ser.serialize(z).to_bytes()
        n_after = len(device_object_manager())
        zb = ser.deserialize(memoryview(blob))
        out["flag_off"] = (n_after == n_before, zb is z,
                           bool(torch.equal(zb, z)))
    finally:
        GLOBAL_CONFIG.apply_system_config({"device_object_transport": True})
    return out


def rdt_changed_since_put():
    """A tensor written in place after the put (AdamW's way), one whose
    storage was freed (resized to 0, ZeRO's way), one whose data was
    swapped, and a view written through its base: each get a host rebuild
    with the put-time values, never the written tensor; an untouched one a
    device hit. {case: (hit, equal to the put-time values, stats delta)}."""
    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.experimental.rdt import device_object_manager

    stats = device_object_manager().stats
    base = torch.arange(12.0).reshape(3, 4)
    param = torch.nn.Parameter(torch.ones(4))
    param.grad = torch.ones(4)

    def sgd_step(t):  # t is param.detach(), as a state_dict holds it
        torch.optim.SGD([param], lr=0.5).step()

    cases = {
        "untouched": (torch.arange(8.0), lambda t: None),
        "add_": (torch.arange(8.0), lambda t: t.add_(1)),
        "optimizer": (param.detach(), sgd_step),
        # a CPU tensor's put maps its storage into numpy, which makes the
        # storage non-resizable: free it by setting it empty (ZeRO-3's
        # ``p.data = torch.empty(0)`` moves the tensor to a storage of 0 bytes)
        "storage_freed": (torch.arange(8.0), lambda t: t.set_()),
        "data_swapped": (torch.arange(8.0),
                         lambda t: setattr(t, "data", torch.zeros(8))),
        "view_of_base": (base[1], lambda t: base.add_(100)),
    }
    out = {}
    for name, (t, change) in cases.items():
        blob = ser.serialize(t).to_bytes()
        put_time = t.clone()
        change(t)
        before = dict(stats)
        got = ser.deserialize(memoryview(blob))
        delta = {k: stats[k] - before[k] for k in stats}
        out[name] = (got is t, bool(torch.equal(got, put_time)), delta)
    return out


def rdt_cluster():
    """``test_rdt.py::test_through_object_plane_tasks`` on a cluster of the
    port: a task's tensor read by another task (rebuilt there) and by the
    driver; a large tensor the driver put read back by the driver (the
    tensor itself), and after ``add_`` the put-time values."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.experimental.rdt import device_object_manager

    @rt.remote
    def make():
        import torch as th

        return th.full((64, 64), 3.0)

    @rt.remote
    def consume(a):
        import torch as th

        from ray_tpu_torch.experimental.rdt import device_object_manager as m

        return (type(a) is th.Tensor, float(a.sum()),
                m().stats["host_rebuilds"] >= 1)

    rt.init(num_cpus=2)
    try:
        ref = make.remote()
        seen = rt.get(consume.remote(ref), timeout=60)
        val = rt.get(ref, timeout=60)
        local = torch.arange(100_000, dtype=torch.float32)  # > inline max
        r2 = rt.put(local)
        stats = device_object_manager().stats
        hits = stats["device_hits"]
        same = rt.get(r2, timeout=60) is local
        hit = stats["device_hits"] - hits
        local.add_(1)
        again = rt.get(r2, timeout=60)
        return {"task": seen, "driver": (type(val).__name__, float(val[0, 0])),
                "put_get_is": same, "hit": hit,
                "after_add": (again is local,
                              bool(torch.equal(again, local - 1)))}
    finally:
        rt.shutdown()


def rdt_stats_program():
    """``test_stats_count_as_jax_does``'s program on the port: the counters'
    deltas."""
    import gc

    from ray_tpu_torch._private import serialization as ser
    from ray_tpu_torch.experimental.rdt import device_object_manager

    stats = device_object_manager().stats
    before = dict(stats)
    x = torch.arange(64.0)
    blob = ser.serialize(x).to_bytes()
    assert ser.deserialize(memoryview(blob)) is x
    del x
    gc.collect()
    assert torch.equal(ser.deserialize(memoryview(blob)),
                       torch.arange(64.0))
    return {k: stats[k] - before[k] for k in stats}


def col_backend_path(world):
    """``world`` ranks of a gloo group as threads of this process, outside
    any cluster (``RT_COLLECTIVE_COORD`` names the store), so every op
    takes the process group's own collectives (no shared-memory path):
    {rank: {op: equal to its numpy twin}} on integer-valued data, numpy
    and CPU tensors alike."""
    import functools
    import socket
    import threading

    from ray_tpu_torch.util.collective.nccl_group import NcclCollectiveGroup

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ["RT_COLLECTIVE_COORD"] = f"127.0.0.1:{port}"
    xs = [np.random.default_rng(70 + r).integers(-3, 4, (world, 6)).astype(
        np.float32) for r in range(world)]
    npop = {"sum": np.add, "product": np.multiply, "max": np.maximum,
            "min": np.minimum}
    out, errors = {}, []

    def rank_main(rank):
        try:
            grp = NcclCollectiveGroup(world, rank, "threads", "gloo")
            got = {}
            for kind, x in (("numpy", xs[rank]),
                            ("tensor", torch.from_numpy(xs[rank].copy()))):
                def eq(v, want):
                    v = v.numpy() if isinstance(v, torch.Tensor) else v
                    return bool(np.array_equal(v, want)) and (
                        isinstance(v, np.ndarray))
                for op in npop:
                    got[f"{kind}_allreduce_{op}"] = eq(
                        grp.allreduce(x[0], op), functools.reduce(
                            npop[op], [a[0] for a in xs]))
                    got[f"{kind}_reducescatter_{op}"] = eq(
                        grp.reducescatter(x, op), functools.reduce(
                            npop[op], [a[rank] for a in xs]))
                got[f"{kind}_broadcast"] = eq(grp.broadcast(x[1], 1),
                                              xs[1][1])
                got[f"{kind}_allgather"] = eq(grp.allgather(x[1]),
                                              np.stack([a[1] for a in xs]))
                got[f"{kind}_permute"] = eq(
                    grp.permute(x[0], [(r, (r + 1) % world)
                                       for r in range(world)]),
                    xs[(rank - 1) % world][0])
                got[f"{kind}_unchanged"] = eq(x, xs[rank])
            grp.barrier()
            grp.destroy()
            out[rank] = got
        except Exception as e:  # reported to the caller
            errors.append(f"rank {rank}: {e!r}")

    try:
        threads = [threading.Thread(target=rank_main, args=(r,))
                   for r in range(world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        del os.environ["RT_COLLECTIVE_COORD"]
    if errors:
        raise RuntimeError("; ".join(errors))
    return out


def profiler_captures(root):
    """``gpu/profiler.py`` on the CPU: ``capture_local`` around a workload,
    then on a port cluster ``capture_on_node`` of the capturing task's own
    worker (JAX's ``test_jax_profiler_capture``) and of an actor through
    the listener its ``init_profiler(0)`` started. Returns the trace files,
    whether the local trace holds the workload's ``aten::mm``, and the
    pids of this process and of the actor."""
    import json

    import ray_tpu_torch as rt
    from ray_tpu_torch.gpu import profiler
    from ray_tpu_torch.util.state import list_nodes

    def names(path):
        with open(path) as f:
            return {e.get("name") for e in json.load(f)["traceEvents"]}

    local_dir = profiler.capture_local(
        os.path.join(root, "local"),
        workload=lambda: torch.mm(torch.ones(8, 8), torch.ones(8, 8)))
    local = sorted(os.path.join(local_dir, f) for f in os.listdir(local_dir))

    @rt.remote
    class Profiled:
        def start(self):
            from ray_tpu_torch.gpu import profiler as p

            return os.getpid(), p.init_profiler(0), p.init_profiler(0)

    rt.init(num_cpus=2)
    try:
        node = list_nodes()[0]["node_id"]
        files = profiler.capture_on_node(node, os.path.join(root, "prof"),
                                         duration_s=0.5)
        actor = Profiled.remote()
        actor_pid, port, again = rt.get(actor.start.remote(), timeout=120)
        actor_files = profiler.capture_on_node(node, None, duration_s=0.5,
                                               port=port)
        rt.kill(actor)
    finally:
        rt.shutdown()
    return dict(local=local, local_mm="aten::mm" in names(local[0]),
                files=files, actor_pid=actor_pid, port=port, again=again,
                actor_files=actor_files, pid=os.getpid())


# -- the dashboard (tests/test_torch_dashboard.py) ------------------------

_DASH = {}


def dash_start(num_cpus):
    """A port cluster in this process and its dashboard on a port the
    system picks: the dashboard's URL and the node's hex id."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.core_worker import get_core_worker
    from ray_tpu_torch.dashboard import start_dashboard

    rt.init(num_cpus=num_cpus)
    atexit.register(dash_stop)
    url = start_dashboard(port=0)
    return {"url": url, "again": start_dashboard(port=0),
            "node": get_core_worker().node_id_hex}


def dash_stop():
    import ray_tpu_torch as rt
    from ray_tpu_torch.dashboard import stop_dashboard

    if rt.is_initialized():
        try:
            stop_dashboard()
        finally:
            rt.shutdown()


def dash_workload():
    """``test_dashboard_endpoints``' work: a named actor that answers and a
    task that bumps a user counter, then sleeps past a metrics flush."""
    import ray_tpu_torch as rt

    @rt.remote
    def traced():
        from ray_tpu_torch.util.metrics import Counter

        Counter("dash_test_counter").inc(2)
        time.sleep(1.2)  # let telemetry flush
        return 1

    @rt.remote
    class DashActor:
        def ping(self):
            return "pong"

    a = DashActor.options(name="dash-actor").remote()
    _DASH["actor"] = a
    return rt.get(a.ping.remote(), timeout=60), rt.get(traced.remote(),
                                                       timeout=60)


def dash_kill_actor():
    import ray_tpu_torch as rt

    rt.kill(_DASH.pop("actor"))


def dash_series():
    """``test_web_frontend_and_metrics_export``'s work: a traced task (the
    per-hop histogram) and the LLM serving / autoscaler series set in this
    driver."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.util.metrics import Counter, Gauge

    GLOBAL_CONFIG.apply_system_config({"tracing_enabled": True})

    @rt.remote
    def hop_probe():
        return 1

    got = rt.get(hop_probe.remote(), timeout=60)
    Gauge("rt_llm_kv_blocks_in_use",
          "paged-KV blocks held by admitted requests").set(3)
    Gauge("rt_llm_batch_occupancy",
          "active decode slots / max_num_seqs").set(0.5)
    Counter("rt_llm_prefix_hits_total",
            "prefix-cache block hits at admission").inc(4)
    Gauge("rt_serve_target_replicas", "autoscaler target replica count",
          ("deployment",)).set(2, {"deployment": "dash-d"})
    return got


def dash_long_task(seconds):
    """Submit a task that sleeps ``seconds`` (a leased worker to profile);
    ``dash_long_result`` waits for it."""
    import ray_tpu_torch as rt

    @rt.remote
    def long_task():
        time.sleep(seconds)
        return 1

    _DASH["long"] = long_task.remote()


def dash_long_result():
    import ray_tpu_torch as rt

    return rt.get(_DASH.pop("long"), timeout=60)


# -- util/tracing.py: the engine's and the train step's spans ---------------


def _flagged(on: bool):
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.util import tracing

    GLOBAL_CONFIG.apply_system_config({"tracing_enabled": on})
    tracing.clear_local_spans()


def _spans_engine(shape, ecfg):
    cfg = _cfg(shape)
    return PagedEngine(cfg, tl.init_params(cfg, 0, device="cpu"),
                       EngineConfig(**ecfg), device="cpu")


def _probe_steps(eng):
    """(active, cached) read from the engine's state at each decode call."""
    seen, decode = [], eng._decode

    def probed(*a):
        act = eng.active.copy()
        seen.append((int(act.sum()), int(eng.lens[act].sum())))
        return decode(*a)

    eng._decode = probed
    return seen


def _serve_some(eng, prompts, max_tokens):
    async def main():
        return await asyncio.gather(
            *[_collect(eng, p, max_tokens) for p in prompts])

    return asyncio.run(main())


def engine_spans(shape, ecfg, prompts, max_tokens):
    """With the tracing flag on: the engine's buffered spans, its own
    (active, cached) at each decode step, its step count and its
    ``gathered`` positions a step; then a forced collection's spans."""
    import gc

    from ray_tpu_torch.util import tracing

    _flagged(True)
    try:
        eng = _spans_engine(shape, ecfg)
        seen = _probe_steps(eng)
        _serve_some(eng, prompts, max_tokens)
        eng._worker.shutdown(wait=True)
        spans = tracing.local_spans()
        gc.collect()
        gcs = [s for s in tracing.local_spans() if s["name"] == "host.gc"]
        return dict(spans=spans, seen=seen, steps=eng.steps, gc=gcs,
                    gathered=eng.ecfg.max_num_seqs * eng.max_blocks * eng.bs)
    finally:
        _flagged(False)


def train_spans(shape, tokens, steps):
    """With the flag on: the spans of ``steps`` train steps."""
    from ray_tpu_torch.util import tracing

    _flagged(True)
    try:
        train_from_seed(shape, tokens, 1e-3, steps)
        return [s for s in tracing.local_spans()
                if s["name"].startswith("train.")]
    finally:
        _flagged(False)


def spans_off(shape, ecfg, prompts, tokens):
    """With the flag off and no profiler: (buffered spans, the names of the
    ``record_function``s entered) over an engine run and a train step
    (torch's optimizer enters one of its own on every step)."""
    from torch.autograd import profiler as ap

    from ray_tpu_torch.util import tracing

    _flagged(False)
    entered = []
    enter = ap.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return enter(self)

    ap.record_function.__enter__ = counted
    try:
        _serve_some(_spans_engine(shape, ecfg), prompts, 4)
        train_from_seed(shape, tokens, 1e-3, 1)
        return tracing.local_spans(), sorted(set(entered))
    finally:
        ap.record_function.__enter__ = enter


def spans_profiled(shape, ecfg, prompts, max_tokens, tmpdir):
    """The flag off, a CPU profiler started on the engine's worker thread as
    the benchmark's traced run starts it: (the buffered spans' names, for
    each worker span that ``progspans`` maps, the distance in microseconds
    from its mapped start and end to its own annotation's, the largest
    residual of the mapping)."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "portbench"))
    import devtrace
    import progspans

    from ray_tpu_torch.util import tracing

    _flagged(False)
    eng = _spans_engine(shape, ecfg)
    path = os.path.join(tmpdir, "trace.json")

    async def main():
        loop = asyncio.get_running_loop()
        prof = await loop.run_in_executor(eng._worker, devtrace.Profile, path)
        await loop.run_in_executor(eng._worker, prof.open)
        outs = await asyncio.gather(
            *[_collect(eng, p, max_tokens) for p in prompts])
        await loop.run_in_executor(eng._worker, prof.stop)
        return outs

    asyncio.run(main())
    eng._worker.shutdown(wait=True)
    tr = devtrace.Trace(path)
    m = progspans.mapped(tr)
    ann = {}
    for ts, end, name in tr.spans:
        ann.setdefault(name, []).append((ts, end))
    dists = []
    for s in m.spans:
        if s.thread not in m.profiled or s.manual:
            continue
        near = min(ann.get(s.name, []), key=lambda a: abs(a[0] - s.ts),
                   default=None)
        if near is not None:
            dists.append((s.name, abs(near[0] - s.ts), abs(near[1] - s.end)))
    return ([s["name"] for s in tracing.local_spans()], dists,
            m.residual_us, m.split())


def engine_threads(shape, ecfg, prompts):
    """The threads that put into a request queue and that set or bump an
    engine metric, over local admissions (prefix hits among them) and
    admissions with KV prefilled elsewhere; and the loop's own thread."""
    import threading

    from ray_tpu_torch.util.metrics import Counter, Gauge

    seen = {"put": set(), "metric": set()}
    put, gset, cinc = asyncio.Queue.put_nowait, Gauge.set, Counter.inc

    def put_nowait(self, item):
        seen["put"].add(threading.get_ident())
        return put(self, item)

    def gauge_set(self, *a, **k):
        seen["metric"].add(threading.get_ident())
        return gset(self, *a, **k)

    def counter_inc(self, *a, **k):
        seen["metric"].add(threading.get_ident())
        return cinc(self, *a, **k)

    cfg = _cfg(shape)
    p = tl.init_params(cfg, 0, device="cpu")
    e = EngineConfig(**ecfg)
    eng = PagedEngine(cfg, p, e, device="cpu")
    remote_prefill = _remote_prefill(cfg, p, e)

    async def main():
        loop_thread = threading.get_ident()
        local = await asyncio.gather(*[_collect(eng, q, 6) for q in prompts])
        again = await asyncio.gather(*[_collect(eng, q, 6) for q in prompts])
        moved = [await _collect(eng, q, 6, prefilled=remote_prefill(q))
                 for q in prompts]
        return loop_thread, local, again, moved

    asyncio.Queue.put_nowait = put_nowait
    Gauge.set, Counter.inc = gauge_set, counter_inc
    try:
        loop_thread, local, again, moved = asyncio.run(main())
    finally:
        asyncio.Queue.put_nowait = put
        Gauge.set, Counter.inc = gset, cinc
    return dict(loop=loop_thread, put=sorted(seen["put"]),
                metric=sorted(seen["metric"]), local=local, again=again,
                moved=moved, stats=eng.stats())
