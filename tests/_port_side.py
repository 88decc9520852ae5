"""The PyTorch side of the ``test_torch_*.py`` parity tests.

These functions run in the child process that ``_port_proc.spawn`` starts,
never in a pytest worker (``_port_proc`` says why). Inputs and outputs are
numpy arrays and plain Python values, so the JAX side of each test stays in
the worker and compares like with like on the same numpy inputs.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys

import numpy as np
import torch

from ray_tpu_torch.llm import LLMConfig, LLMServer
from ray_tpu_torch.llm._engine import EngineConfig, PagedEngine, _make_prefill
from ray_tpu_torch.llm._generate import generate, generate_stream
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import flash_attention as tfa

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
    return losses, tl._map(_np, state[0]), (tfa.flash_fwd_launches,) + \
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
    """A stand-in for ``torch.distributed.DeviceMesh`` of ``n`` devices
    (a real one of more than one device needs as many processes)."""

    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


def train_step_mesh(shape, n):
    """The error text ``make_train_step`` raises on a mesh of ``n`` devices
    (None if it accepts it)."""
    try:
        tl.make_train_step(_cfg(shape), mesh=_Mesh(n), device="cpu")
    except NotImplementedError as e:
        return str(e)
    return None


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
        "assert len(names) >= 12, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout, out.stderr
