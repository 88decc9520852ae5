"""Llama-family decoder in PyTorch — counterpart of ``ray_tpu/models/llama.py``.

Plain functions on a parameter dict with the JAX package's keys, shapes and
``(L, in, out)`` orientation: ``tok_emb``, stacked ``layers`` {ln1, ln2, wq,
wk, wv, wo, w1, w2, w3}, ``norm``, ``lm_head``. Weights therefore move 1:1
between the two packages (``models/convert.py``). The layer stack runs as a
Python loop over the leading layer axis where JAX scans it. bf16
activations, fp32 RMSNorm statistics and softmax; RoPE, GQA and SwiGLU
follow Llama-2/3.

``attention_impl``: "xla" is plain PyTorch attention (the name is the JAX
package's); "flash" projects straight to (b, h, s, hd) and calls the flash
attention kernels on CUDA (K1 forward, K2/K3 backward). "ring" and
"ulysses" shard the sequence over a mesh's sp axis
(``parallel/ring_attention.py``: K4 forward, K5 backward on CUDA;
``parallel/ulysses.py``: all-to-alls around K1-K3) and take plain
attention without one (mesh None or sp 1), as in the JAX package.

On a mesh (``parallel/mesh.py``: one process a position) the weights are
replicated: the batch is sharded over dp and the sequence over sp, and
each rank computes its own (b/dp, s/sp) block. fsdp, tp and pp shard the
weights in the JAX package; the port raises ``NotImplementedError`` on
them (the sharded-training slice).

``make_train_step`` is the training step: AdamW as optax's, the chunked
loss, the remat modes as ``torch.utils.checkpoint``, and on a dp x sp mesh
one all-reduce of the gradients a step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.parallel.mesh import axis_index, mesh_shape, stage, to_wire


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 4096
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    # attention implementation: "xla" (plain torch), "flash" (the flash
    # attention kernels on CUDA), "ring" / "ulysses" (sequence parallel over
    # a mesh's sp axis; "xla" without one)
    attention_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                   ffn_dim=11008, **kw)

    @classmethod
    def llama3_8b(cls, **kw) -> "LlamaConfig":
        return cls(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                   n_kv_heads=8, ffn_dim=14336, rope_theta=500000.0, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        """Test/CI-size config."""
        return cls(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                   n_kv_heads=2, ffn_dim=256, max_seq_len=256, **kw)

    def num_params(self) -> int:
        hd = self.head_dim
        per_layer = (
            self.dim * self.n_heads * hd          # wq
            + 2 * self.dim * self.n_kv_heads * hd  # wk, wv
            + self.n_heads * hd * self.dim         # wo
            + 3 * self.dim * self.ffn_dim          # w1, w2, w3 (w2 transposed)
            + 2 * self.dim                         # ln1, ln2
        )
        return (
            self.vocab_size * self.dim             # tok_emb
            + self.n_layers * per_layer
            + self.dim                             # final norm
            + self.dim * self.vocab_size           # lm_head
        )


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def init_params(cfg: LlamaConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random weights N(0, 1/fan_in) from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (default CUDA). Stacked layer weights are drawn
    one layer at a time, so the fp32 draw never holds more than one layer."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    hd = cfg.head_dim
    pd = cfg.param_dtype
    L = cfg.n_layers

    def dense(fan_in, shape):
        out = torch.empty(shape, dtype=pd, device=dev)
        for part in (out if len(shape) == 3 else [out]):
            part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                       * (1.0 / math.sqrt(fan_in)))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=dev)

    return {
        "tok_emb": dense(cfg.dim, (cfg.vocab_size, cfg.dim)),
        "layers": {
            "ln1": ones((L, cfg.dim)),
            "ln2": ones((L, cfg.dim)),
            "wq": dense(cfg.dim, (L, cfg.dim, cfg.n_heads * hd)),
            "wk": dense(cfg.dim, (L, cfg.dim, cfg.n_kv_heads * hd)),
            "wv": dense(cfg.dim, (L, cfg.dim, cfg.n_kv_heads * hd)),
            "wo": dense(cfg.n_heads * hd, (L, cfg.n_heads * hd, cfg.dim)),
            "w1": dense(cfg.dim, (L, cfg.dim, cfg.ffn_dim)),
            "w3": dense(cfg.dim, (L, cfg.dim, cfg.ffn_dim)),
            "w2": dense(cfg.ffn_dim, (L, cfg.ffn_dim, cfg.dim)),
        },
        "norm": ones((cfg.dim,)),
        "lm_head": dense(cfg.dim, (cfg.dim, cfg.vocab_size)),
    }


def layer_params(params: Dict[str, Any], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked layer weights (views)."""
    return {name: w[i] for name, w in params["layers"].items()}


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    # fp32 statistics even under bf16 activations
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms).to(x.dtype) * weight.to(x.dtype)


def rope_tables(cfg: LlamaConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (..., seq) int → cos/sin (..., seq, head_dim/2), fp32."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        / half)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, hd); cos/sin: (b, s, hd/2) or (s, hd/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope_bhsd(x: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor) -> torch.Tensor:
    """x: (b, h, s, hd); cos/sin: (s, hd/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos, sin = cos[None, None, :, :], sin[None, None, :, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def _attention_xla(q, k, v, causal: bool = True):
    """Plain attention; fp32 softmax. q: (b, s, h, hd), k/v (b, s, kv, hd)."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    if kv != h:  # GQA: repeat kv heads
        rep = h // kv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(hd)
    # bf16 operands are exact in fp32, so this is JAX's
    # preferred_element_type=float32 product
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sk = k.shape[1]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(
            sk - sq)
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(cfg: LlamaConfig, q, k, v, mesh=None):
    """q: (b, s, h, hd), k/v (b, s, kvh, hd): on a mesh with sp > 1, this
    rank's sequence shard."""
    sp = mesh_shape(mesh)["sp"]
    if cfg.attention_impl == "ring" and sp > 1:
        from ray_tpu_torch.parallel.ring_attention import \
            ring_attention_sharded

        return ring_attention_sharded(q, k, v, mesh, causal=True)
    if cfg.attention_impl == "ulysses" and sp > 1:
        from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

        return ulysses_attention_sharded(q, k, v, mesh, causal=True)
    if cfg.attention_impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True)
    return _attention_xla(q, k, v, causal=True)


def _ffn(cfg: LlamaConfig, h, p):
    dt = cfg.dtype
    x = rms_norm(h, p["ln2"], cfg.norm_eps)
    gate = F.silu(x @ p["w1"].to(dt))
    up = x @ p["w3"].to(dt)
    return (gate * up) @ p["w2"].to(dt)


def _layer(cfg: LlamaConfig, mesh, h, layer_params, cos, sin,
           remat_ffn: bool = False):
    p = layer_params
    hd = cfg.head_dim
    b, s, _ = h.shape
    dt = cfg.dtype

    x = rms_norm(h, p["ln1"], cfg.norm_eps)
    if cfg.attention_impl == "flash":
        # bhsd hot path: projections emit (b, h, s, hd) directly, the
        # kernel's layout
        from ray_tpu_torch.ops.flash_attention import flash_attention_bhsd

        wq = p["wq"].to(dt).reshape(cfg.dim, cfg.n_heads, hd)
        wk = p["wk"].to(dt).reshape(cfg.dim, cfg.n_kv_heads, hd)
        wv = p["wv"].to(dt).reshape(cfg.dim, cfg.n_kv_heads, hd)
        q = torch.einsum("bsd,dhk->bhsk", x, wq)
        k = torch.einsum("bsd,dhk->bhsk", x, wk)
        v = torch.einsum("bsd,dhk->bhsk", x, wv)
        q = apply_rope_bhsd(q, cos, sin)
        k = apply_rope_bhsd(k, cos, sin)
        o = flash_attention_bhsd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
        wo = p["wo"].to(dt).reshape(cfg.n_heads, hd, cfg.dim)
        attn = torch.einsum("bhsk,hkd->bsd", o, wo)
    else:
        q = (x @ p["wq"].to(dt)).reshape(b, s, cfg.n_heads, hd)
        k = (x @ p["wk"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
        v = (x @ p["wv"].to(dt)).reshape(b, s, cfg.n_kv_heads, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attention(cfg, q, k, v, mesh)
        attn = attn.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(dt)
    h = h + attn
    if remat_ffn:
        return h + checkpoint(_ffn, cfg, h, p, use_reentrant=False,
                              preserve_rng_state=False)
    return h + _ffn(cfg, h, p)


def _check_mesh(cfg: LlamaConfig, mesh) -> Dict[str, int]:
    """The mesh's axis sizes; raises on a mesh the port does not run."""
    shape = mesh_shape(mesh)
    sharded = {a: shape[a] for a in ("fsdp", "tp", "pp") if shape[a] > 1}
    if sharded:
        raise NotImplementedError(
            f"a mesh with {sharded} shards the weights: that needs the "
            "sharded training slice (FSDP / tensor / pipeline parallel), "
            "not ported yet; dp and sp are")
    if shape["sp"] > 1 and cfg.attention_impl not in ("ring", "ulysses"):
        raise ValueError(
            f"attention_impl {cfg.attention_impl!r} attends within one "
            f"rank's block; a sequence sharded over sp={shape['sp']} needs "
            "'ring' or 'ulysses'")
    return shape


def _mesh_block(cfg: LlamaConfig, mesh, b: int, s: int):
    """(rows, positions): the slices of a global (b, s) batch that this
    rank computes on ``mesh``, the batch over dp and the sequence over
    sp, as the JAX package's sharding (``P(BATCH_AXES, "sp")``) places
    them."""
    shape = _check_mesh(cfg, mesh)
    dp, sp = shape["dp"], shape["sp"]
    if b % dp or s % sp:
        raise ValueError(f"batch {b} and sequence {s} must divide by dp={dp} "
                         f"and sp={sp}")
    bi, si = axis_index(mesh, "dp"), axis_index(mesh, "sp")
    return (slice(bi * b // dp, (bi + 1) * b // dp),
            slice(si * s // sp, (si + 1) * s // sp))


def forward(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            mesh=None, positions: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """tokens (b, s) int → logits (b, s, vocab) in fp32.

    On a ``mesh`` (dp x sp; every rank calls it together) ``tokens`` is the
    GLOBAL batch, as JAX's global array, and the result is this rank's
    block of the logits: (b/dp, s/sp, vocab) at rows [dp_idx·b/dp, ...)
    and positions [sp_idx·s/sp, ...), RoPE'd at those global positions."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device)
    if mesh is not None:
        rows, cols = _mesh_block(cfg, mesh, b, s)
        tokens = tokens[rows, cols]
        positions = (positions[rows] if positions.dim() == 2
                     else positions)[..., cols]
    dt = cfg.dtype
    h = params["tok_emb"].to(dt)[tokens]
    cos, sin = rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        h = _layer(cfg, mesh, h, layer_params(params, i), cos, sin)
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    return (h @ params["lm_head"].to(dt)).float()


def loss_fn(cfg: LlamaConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy; tokens (b, s)."""
    logits = forward(cfg, params, tokens[:, :-1])
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.mean()


# ---------------------------------------------------------------------------
# training step factory
# ---------------------------------------------------------------------------

# AdamW as the JAX package's ``optax.adamw(learning_rate)``: optax's defaults,
# weight decay 1e-4 on every leaf, norms included (torch's default is 1e-2)
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4


def adamw(leaves, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)`` over ``leaves``: decoupled decay on
    every leaf; the fused kernel on CUDA (PyTorch's own optimizer kernel,
    as the JAX package left the optimizer to XLA)."""
    return torch.optim.AdamW(
        leaves, lr=learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS,
        weight_decay=WEIGHT_DECAY,
        fused=True if leaves[0].is_cuda else None)


def _dots_saveable(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable`` as a selective-checkpoint
    policy: save the products with no batch dimension, which are the weight
    products (``x @ W`` lowers to ``mm``; the bhsd branch's einsum
    projections to a ``bmm`` over a batch of one), and recompute the rest:
    the batched attention products, the flash kernels and every
    elementwise op."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_layer(cfg: LlamaConfig, mesh, remat):
    """``_layer`` under one remat mode of ``make_train_step``."""
    if remat == "ffn":
        return partial(_layer, cfg, mesh, remat_ffn=True)
    layer = partial(_layer, cfg, mesh)
    if remat == "dots":
        return partial(checkpoint, layer, use_reentrant=False,
                       preserve_rng_state=False,
                       context_fn=partial(create_selective_checkpoint_contexts,
                                          _dots_saveable))
    if remat:
        return partial(checkpoint, layer, use_reentrant=False,
                       preserve_rng_state=False)
    return layer


def _backbone(cfg: LlamaConfig, params, tokens, positions, layer):
    h = params["tok_emb"].to(cfg.dtype)[tokens]
    cos, sin = rope_tables(cfg, positions)
    # one unbind per stacked weight: its backward stacks the layers'
    # gradients once, where indexing would make a full-size zero tensor for
    # every layer
    stacked = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        h = layer(h, {name: ws[i] for name, ws in stacked.items()}, cos, sin)
    return rms_norm(h, params["norm"], cfg.norm_eps)


def _chunk_nll(cfg: LlamaConfig, lm_head, h_c, tgt_c, mask_c):
    """Masked NLL sum over one sequence chunk. tgt -1 = no target."""
    logits = (h_c @ lm_head.to(cfg.dtype)).float()
    logp = torch.log_softmax(logits, dim=-1)
    tgt = tgt_c.clamp_min(0).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    return (nll * mask_c).sum()


def compute_loss(cfg: LlamaConfig, params, tokens: torch.Tensor, remat=False,
                 loss_chunk: int = 512, mesh=None) -> torch.Tensor:
    """The loss ``make_train_step`` differentiates: next-token NLL, mean over
    the positions that have a target.

    The forward runs on the FULL sequence and position s-1, which has no
    target, is masked out instead of sliced off (so the attention kernels
    see s, not s-1). The (b, s, vocab) fp32 logits are the largest
    activations: when ``loss_chunk`` divides s into more than one chunk,
    each chunk's logits are made under ``torch.utils.checkpoint``, so only
    one chunk's are live in either direction.

    On a ``mesh`` ``tokens`` is the global batch: the targets are built on
    it before this rank's block is cut out (so a shard's last position
    targets the next shard's first token), and the block's NLL sum is
    divided by the GLOBAL count of positions with a target, so the ranks'
    losses add up to the global mean."""
    b, s = tokens.shape
    targets = torch.cat([tokens[:, 1:], torch.full(
        (b, 1), -1, dtype=tokens.dtype, device=tokens.device)], dim=1)
    denom = (targets >= 0).float().sum()
    positions = torch.arange(s, device=tokens.device)
    if mesh is not None:
        rows, cols = _mesh_block(cfg, mesh, b, s)
        tokens, targets = tokens[rows, cols], targets[rows, cols]
        positions = positions[cols]
        s = tokens.shape[1]
    h = _backbone(cfg, params, tokens, positions,
                  _remat_layer(cfg, mesh, remat))
    mask = (targets >= 0).float()
    chunk = loss_chunk
    if chunk and s % chunk == 0 and s > chunk:
        total = 0.0
        for c0 in range(0, s, chunk):
            cut = slice(c0, c0 + chunk)
            total = total + checkpoint(
                _chunk_nll, cfg, params["lm_head"], h[:, cut], targets[:, cut],
                mask[:, cut], use_reentrant=False, preserve_rng_state=False)
        return total / denom
    return _chunk_nll(cfg, params["lm_head"], h, targets, mask) / denom


def _leaves(params) -> list:
    if isinstance(params, dict):
        return [t for v in params.values() for t in _leaves(v)]
    return [params]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _all_reduce_sum(tensors):
    """Sum each tensor over every rank of the default group, in place, as
    one flat fp32 buffer (one collective; through host memory on gloo)."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    wire = to_wire(flat, stage(None))
    dist.all_reduce(wire)
    flat = wire.to(flat.device)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def make_train_step(cfg: LlamaConfig, mesh=None, learning_rate: float = 3e-4,
                    remat=False, loss_chunk: int = 512, device=None):
    """Build (init_state, shard_state, train_step, data_device).

    The JAX package's ``make_train_step`` on one device (``mesh`` None or
    of one device) or on a ``DeviceMesh`` with dp and sp axes
    (``MeshSpec(dp=.., sp=..).build()``, one process a position; every rank
    calls each function together). A mesh with fsdp, tp or pp above 1 (the
    sharded-training path) raises ``NotImplementedError``. ``device``
    defaults to CUDA. State = (params, optimizer): AdamW as
    ``optax.adamw(learning_rate)``, the parameters replicated on every rank
    (from the same seed or the same parameter dict). ``remat`` selects the
    memory / FLOPs trade per layer, each a ``torch.utils.checkpoint``
    (non-reentrant):
      False  — save all layer activations
      "ffn"  — recompute only the FFN block
      "dots" — save the weight products, recompute the rest (JAX's
               ``dots_with_no_batch_dims_saveable``); a ring layer's
               forward, and its transfers, run again in the recompute
      True   — recompute the whole layer
    """
    ranks = math.prod(_check_mesh(cfg, mesh).values())
    dev = resolve_device(device)

    def init_state(seed_or_params=0):
        """(params, optimizer) from a seed (``init_params``) or from a
        parameter dict (e.g. ``params_from_jax``), copied onto the device."""
        if isinstance(seed_or_params, dict):
            params = _map(lambda t: t.detach().to(dev, copy=True),
                          seed_or_params)
        else:
            params = init_params(cfg, seed_or_params, device=dev)
        leaves = _leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return params, adamw(leaves, learning_rate)

    def shard_state(state):
        """Place a (params, optimizer) state: on one device it already is."""
        return state

    def train_step(state, tokens):
        """One AdamW step on ``tokens`` (b, s) on the device: on a mesh the
        GLOBAL batch, of which each rank computes its block. Parameters
        and moments are updated in place, the port's stand-in for JAX's
        donated state: the step keeps no second copy. On a mesh the
        gradients and the loss are summed over the ranks before the
        update. Returns (state, loss), the loss a 0-dim tensor (the global
        one) that is not synchronised."""
        params, opt = state
        opt.zero_grad(set_to_none=True)
        loss = compute_loss(cfg, params, tokens, remat, loss_chunk, mesh)
        loss.backward()
        loss = loss.detach()
        if ranks > 1:
            _all_reduce_sum([t.grad for t in _leaves(params)] + [loss])
        opt.step()
        return state, loss

    return init_state, shard_state, train_step, dev

