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
attention without one (mesh None or sp 1), as in the JAX package. "xla" and
"flash" on a mesh with sp > 1 run the program JAX's GSPMD runs there:
"xla" all-gathers K and V over sp and attends from the rank's query block
to the whole sequence; "flash" all-gathers q, k and v, runs the kernels
on the whole sequence (GSPMD cannot split a custom call) and keeps the
rank's rows of the output.

On a mesh (``parallel/mesh.py``: one process a position) the batch is
sharded over dp x fsdp and the sequence over sp, and each rank computes its
own (b/(dp·fsdp), s/sp) block; tp ranks take the same block. Each rank
holds only its blocks of the weights, as ``param_specs`` (the JAX
package's table) places them: fsdp splits each weight's "other" dim and
is gathered at use (``_sharded.use``, ZeRO-3), and tp splits the heads and
the FFN columns, Megatron style: wq/wk/wv and w1/w3 column parallel (a
rank's contiguous heads, so GQA's head map holds locally), wo and w2 row
parallel, ``copy_to`` in front of each column-parallel product and
``reduce_from`` after each row-parallel one. The attention kernels run on
the rank's own heads. An axis need not divide what it splits: the blocks
are then GSPMD's (``parallel/mesh.py::block_range``), the gathers cut the
padding off, and where tp does not split the heads every tp rank runs
attention on all of them (``_sharded.heads_split``). pp, which no spec
names, is a replica axis here, as in JAX; ``parallel/pipeline.py`` lays
the layers' stages over it.

``make_train_step`` is the training step: AdamW as optax's, on each rank's
shards, the chunked loss, the remat modes as ``torch.utils.checkpoint``,
and on a mesh one all-reduce of a flat gradient buffer per group a step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models._sharded import (adamw, gather_heads,
                                          heads_split, own_columns,
                                          sum_gradients, use)
from ray_tpu_torch.parallel.mesh import (P, all_gather, all_reduce_sum,
                                        axis_index, copy_to, data_spec,
                                        gather_from, gather_full, mesh_shape,
                                        reduce_from, shard_of,
                                        shard_train_state, tree_leaves,
                                        tree_map)


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
# parameter init + sharding specs
# ---------------------------------------------------------------------------


def param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """The JAX package's ``param_specs``, key for key: the spec (``P``) of
    each weight. The leading axis of layer weights is the layer axis,
    never sharded; tp splits the 'parallel' dim (Megatron column / row),
    fsdp the other."""
    return {
        "tok_emb": P("fsdp", "tp"),
        "layers": {
            "ln1": P(None, None),
            "ln2": P(None, None),
            "wq": P(None, "fsdp", "tp"),
            "wk": P(None, "fsdp", "tp"),
            "wv": P(None, "fsdp", "tp"),
            "wo": P(None, "tp", "fsdp"),
            "w1": P(None, "fsdp", "tp"),
            "w3": P(None, "fsdp", "tp"),
            "w2": P(None, "tp", "fsdp"),
        },
        "norm": P(None),
        "lm_head": P("fsdp", "tp"),
    }


# one layer's weight as ``_layer`` gets it: its spec without the layer axis
_LAYER_SPECS = {name: spec[1:] for name, spec in
                param_specs(None)["layers"].items()}


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


def shard_params(cfg: LlamaConfig, params: Dict[str, Any], mesh,
                 device=None) -> Dict[str, Any]:
    """This rank's blocks of the global ``params`` on ``mesh``
    (``param_specs``), copied to ``device`` (default: each leaf's own):
    what ``forward``, ``loss_fn`` and the train step take on a mesh. Only
    the blocks are copied."""
    def cut(t, spec):
        block = shard_of(t.detach(), spec, mesh)
        return block.to(device or t.device, copy=True)

    return tree_map(cut, params, param_specs(cfg))


def gather_state(cfg: LlamaConfig, state, mesh) -> Dict[str, Any]:
    """The global parameters of a sharded (params, optimizer) state, on
    every rank (new tensors, no gradient): for tests, checks and
    checkpoints. Every rank calls it together."""
    return tree_map(lambda t, spec: gather_full(t.detach(), spec, mesh),
                    state[0], param_specs(cfg))


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


def _attention_xla(q, k, v, causal: bool = True, q_offset=None):
    """Plain attention; fp32 softmax. q: (b, sq, h, hd), k/v (b, sk, kv, hd).

    The causal mask keeps key positions up to ``q_offset`` plus the query's
    own: by default sk - sq (a bottom-right mask), on a sequence-sharded
    mesh the query block's global start."""
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
            sk - sq if q_offset is None else q_offset)
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(cfg: LlamaConfig, q, k, v, mesh=None):
    """q: (b, s, h, hd), k/v (b, s, kvh, hd): on a mesh with sp > 1, this
    rank's sequence shard; with tp > 1, this rank's heads, or every head
    where tp does not split them."""
    sp = mesh_shape(mesh)["sp"]
    if cfg.attention_impl == "ring" and sp > 1:
        from ray_tpu_torch.parallel.ring_attention import \
            ring_attention_sharded

        return ring_attention_sharded(q, k, v, mesh, causal=True)
    if cfg.attention_impl == "ulysses" and sp > 1:
        return _ulysses(cfg, q, k, v, mesh)
    if cfg.attention_impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return _on_whole_sequence(flash_attention, q, k, v, mesh, dim=1)
    if sp > 1:
        # "xla" on a sequence-sharded mesh: GSPMD's K/V all-gather, then
        # the rank's queries against the whole sequence
        k, v = (all_gather(t, mesh, "sp", dim=1) for t in (k, v))
        return _attention_xla(q, k, v, causal=True,
                              q_offset=axis_index(mesh, "sp") * q.shape[1])
    return _attention_xla(q, k, v, causal=True)


def _ulysses(cfg: LlamaConfig, q, k, v, mesh):
    """Ulysses on a rank's heads (q/k/v: (b, s/sp, heads, hd), the heads
    this tp rank holds, or all of them). Where a rank's share of the heads
    does not divide by sp, it runs as GSPMD runs JAX's Ulysses, whose
    ``shard_map`` spec keeps the heads whole over tp: the heads gathered
    over tp, Ulysses on all of them, the rank's heads of the output kept
    (the gather's backward keeps them too)."""
    from ray_tpu_torch.parallel.ulysses import ulysses_attention_sharded

    sp = mesh_shape(mesh)["sp"]
    if q.shape[2] == cfg.n_heads or (q.shape[2] % sp == 0
                                     and k.shape[2] % sp == 0):
        return ulysses_attention_sharded(q, k, v, mesh, causal=True)
    h, i = q.shape[2], axis_index(mesh, "tp")
    q, k, v = (gather_from(t, mesh, "tp", dim=2) for t in (q, k, v))
    return ulysses_attention_sharded(q, k, v, mesh, causal=True).narrow(
        2, i * h, h)


def _on_whole_sequence(attn, q, k, v, mesh, dim: int):
    """Causal ``attn`` of this rank's sequence block (along ``dim``) on a
    mesh with sp > 1 as GSPMD runs a kernel it cannot split: q, k and v
    all-gathered over sp, ``attn`` on the whole sequence, this rank's rows
    kept (the gathers' backward reduce-scatters dq, dk and dv). Without sp,
    ``attn`` on the block itself."""
    if mesh_shape(mesh)["sp"] == 1:
        return attn(q, k, v, causal=True)
    s, i = q.shape[dim], axis_index(mesh, "sp")
    q, k, v = (all_gather(t, mesh, "sp", dim=dim) for t in (q, k, v))
    return attn(q, k, v, causal=True).narrow(dim, i * s, s)


def _weight(cfg: LlamaConfig, mesh, p, name: str):
    """Layer weight ``name`` in the compute dtype, gathered for use (fsdp
    splits each layer weight's model dim)."""
    return use(mesh, p[name].to(cfg.dtype), _LAYER_SPECS[name], cfg.dim)


def _embed(cfg: LlamaConfig, mesh, tok_emb, tokens):
    """tokens → (b, s, dim) activations: tok_emb's vocab gathered over
    fsdp at use, this tp rank's dim columns looked up, the columns
    gathered over tp (the backward keeps the rank's columns)."""
    e = use(mesh, tok_emb.to(cfg.dtype), param_specs(cfg)["tok_emb"],
            cfg.vocab_size)
    return gather_from(e[tokens], mesh, "tp", dim=-1, size=cfg.dim)


def _head(cfg: LlamaConfig, mesh, lm_head):
    """lm_head at use, in the compute dtype: this rank's vocab columns
    (column parallel over tp), its dim gathered over fsdp. The loss
    gathers it once for all its chunks."""
    return use(mesh, lm_head.to(cfg.dtype), param_specs(cfg)["lm_head"],
               cfg.dim)


def _logits(cfg: LlamaConfig, mesh, h, head):
    """h (..., dim) → logits (..., vocab) by ``head`` (``_head``): the
    logits' columns are gathered over tp, so a rank holds its rows' logits
    whole, the contract of ``forward``."""
    return gather_from(copy_to(h, mesh, "tp") @ head, mesh, "tp", dim=-1,
                       size=cfg.vocab_size)


def _ffn(cfg: LlamaConfig, mesh, h, p):
    x = copy_to(rms_norm(h, p["ln2"], cfg.norm_eps), mesh, "tp")
    gate = F.silu(x @ _weight(cfg, mesh, p, "w1"))
    up = x @ _weight(cfg, mesh, p, "w3")
    return reduce_from((gate * up) @ _weight(cfg, mesh, p, "w2"), mesh, "tp")


def _layer(cfg: LlamaConfig, mesh, h, layer_params, cos, sin,
           remat_ffn: bool = False):
    p = layer_params
    hd = cfg.head_dim
    b, s, _ = h.shape
    tp = mesh_shape(mesh)["tp"]
    # this tp rank's heads, where tp splits them (``heads_split``)
    nh, nkv = cfg.n_heads // tp, cfg.n_kv_heads // tp
    wq, wk, wv, wo = (_weight(cfg, mesh, p, n) for n in ("wq", "wk", "wv",
                                                         "wo"))

    x = copy_to(rms_norm(h, p["ln1"], cfg.norm_eps), mesh, "tp")
    if not heads_split(mesh, cfg.n_heads, cfg.n_kv_heads):
        # every head on every tp rank, from q, k and v gathered over tp
        q, k, v = (gather_heads(x @ w, mesh, n, hd) for w, n in (
            (wq, cfg.n_heads), (wk, cfg.n_kv_heads), (wv, cfg.n_kv_heads)))
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        o = attention(cfg, q, k, v, mesh)
        attn = own_columns(o.reshape(b, s, cfg.n_heads * hd), mesh) @ wo
    elif cfg.attention_impl == "flash":
        # bhsd hot path: projections emit (b, h, s, hd) directly, the
        # kernel's layout
        from ray_tpu_torch.ops.flash_attention import flash_attention_bhsd

        q = torch.einsum("bsd,dhk->bhsk", x, wq.reshape(cfg.dim, nh, hd))
        k = torch.einsum("bsd,dhk->bhsk", x, wk.reshape(cfg.dim, nkv, hd))
        v = torch.einsum("bsd,dhk->bhsk", x, wv.reshape(cfg.dim, nkv, hd))
        q = apply_rope_bhsd(q, cos, sin)
        k = apply_rope_bhsd(k, cos, sin)
        o = _on_whole_sequence(flash_attention_bhsd, q.contiguous(),
                               k.contiguous(), v.contiguous(), mesh, dim=2)
        attn = torch.einsum("bhsk,hkd->bsd", o, wo.reshape(nh, hd, cfg.dim))
    else:
        q = (x @ wq).reshape(b, s, nh, hd)
        k = (x @ wk).reshape(b, s, nkv, hd)
        v = (x @ wv).reshape(b, s, nkv, hd)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attention(cfg, q, k, v, mesh)
        attn = attn.reshape(b, s, nh * hd) @ wo
    h = h + reduce_from(attn, mesh, "tp")
    if remat_ffn:
        return h + checkpoint(_ffn, cfg, mesh, h, p, use_reentrant=False,
                              preserve_rng_state=False)
    return h + _ffn(cfg, mesh, h, p)


def forward(cfg: LlamaConfig, params: Dict[str, Any], tokens: torch.Tensor,
            mesh=None, positions: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """tokens (b, s) int → logits (b, s, vocab) in fp32.

    On a ``mesh`` (every rank calls it together) ``params`` are this rank's
    blocks (``shard_params``) and ``tokens`` is the GLOBAL batch, as JAX's
    global array; the result is this rank's block of the logits:
    (b/(dp·fsdp), s/sp, vocab) at rows [(dp_idx·fsdp + fsdp_idx)·b/(dp·fsdp),
    ...) and positions [sp_idx·s/sp, ...), RoPE'd at those global
    positions, every vocab column on every tp rank."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    if mesh is not None:
        tokens = shard_of(tokens, data_spec(), mesh)
        positions = shard_of(positions, data_spec() if positions.dim() == 2
                             else P("sp"), mesh)
    h = _embed(cfg, mesh, params["tok_emb"], tokens)
    cos, sin = rope_tables(cfg, positions)
    for i in range(cfg.n_layers):
        h = _layer(cfg, mesh, h, layer_params(params, i), cos, sin)
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    return _logits(cfg, mesh, h, _head(cfg, mesh, params["lm_head"])
                   ).float()


def loss_fn(cfg: LlamaConfig, params, tokens: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy; tokens (b, s).

    On a ``mesh`` (every rank calls it together) ``tokens`` is the global
    batch and ``forward`` gives this rank's block: its NLL against the same
    block of the targets is summed over the data axes (dp, fsdp, sp; tp
    ranks hold the same block) and divided by the global b (s - 1), so
    every rank returns the global loss. Its gradient reaches this rank's
    block alone: summed over the data axes, as ``make_train_step`` sums
    gradients, it is the global loss's. The s - 1 inputs are padded at
    the end to a multiple of sp (JAX's sharding takes uneven blocks; the
    port's sequence-parallel attention takes equal ones): causal
    attention keeps the padding from every real position, and its
    targets are masked out."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    count = targets.numel()
    if mesh is not None:
        pad = -inputs.shape[1] % mesh_shape(mesh)["sp"]
        inputs = F.pad(inputs, (0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
        targets = shard_of(targets, data_spec(), mesh)
    logits = forward(cfg, params, inputs, mesh)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.clamp(min=0)[..., None].long()
                        )[..., 0]
    if mesh is None:
        return nll.mean()
    local = torch.where(targets >= 0, nll, 0.0).sum()
    total = local.detach().clone()
    all_reduce_sum([total], mesh, DATA_AXES)
    return (local + (total - local.detach())) / count


# ---------------------------------------------------------------------------
# training step factory
# ---------------------------------------------------------------------------

def _dots_saveable(ctx, op, *args, **kwargs):
    """JAX's ``dots_with_no_batch_dims_saveable`` as a selective-checkpoint
    policy: save the products with no batch dimension, which are the weight
    products (``x @ W`` lowers to ``mm``; the bhsd branch's einsum
    projections to a ``bmm`` over a batch of one), and recompute the rest:
    the batched attention products, the flash kernels and every
    elementwise op. A collective's output (a weight gathered over fsdp, an
    activation summed over tp) is no product: the collective runs again
    in the recompute, as under ``jax.checkpoint``."""
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


def _backbone(cfg: LlamaConfig, mesh, params, tokens, positions, layer):
    h = _embed(cfg, mesh, params["tok_emb"], tokens)
    cos, sin = rope_tables(cfg, positions)
    # one unbind per stacked weight: its backward stacks the layers'
    # gradients once, where indexing would make a full-size zero tensor for
    # every layer
    stacked = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        h = layer(h, {name: ws[i] for name, ws in stacked.items()}, cos, sin)
    return rms_norm(h, params["norm"], cfg.norm_eps)


def _chunk_nll(cfg: LlamaConfig, mesh, head, h_c, tgt_c, mask_c):
    """Masked NLL sum over one sequence chunk. tgt -1 = no target."""
    logits = _logits(cfg, mesh, h_c, head).float()
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
        tokens, targets = (shard_of(t, data_spec(), mesh)
                           for t in (tokens, targets))
        positions = shard_of(positions, P("sp"), mesh)
        s = tokens.shape[1]
    h = _backbone(cfg, mesh, params, tokens, positions,
                  _remat_layer(cfg, mesh, remat))
    mask = (targets >= 0).float()
    head = _head(cfg, mesh, params["lm_head"])
    chunk = loss_chunk
    if chunk and s % chunk == 0 and s > chunk:
        total = 0.0
        for c0 in range(0, s, chunk):
            cut = slice(c0, c0 + chunk)
            total = total + checkpoint(
                _chunk_nll, cfg, mesh, head, h[:, cut],
                targets[:, cut], mask[:, cut], use_reentrant=False,
                preserve_rng_state=False)
        return total / denom
    return _chunk_nll(cfg, mesh, head, h, targets, mask) / denom


# the axes whose ranks hold different data: the loss, and every gradient
# the model's collectives have not summed already, are summed over them
DATA_AXES = ("dp", "fsdp", "sp")


def make_train_step(cfg: LlamaConfig, mesh=None, learning_rate: float = 3e-4,
                    remat=False, loss_chunk: int = 512, device=None):
    """Build (init_state, shard_state, train_step, data_device).

    The JAX package's ``make_train_step`` on one device (``mesh`` None or
    of one device) or on a ``DeviceMesh`` with dp, fsdp, tp and sp axes
    (``MeshSpec(...).build()``, one process a position; every rank calls
    each function together; an axis need not divide the weights it
    splits). pp, which no spec names, is a replica axis, as in JAX: each
    pp slice computes the same step (the pipeline over pp is
    ``parallel/pipeline.py``). ``device`` defaults to CUDA. State =
    (params, optimizer): this rank's blocks of the parameters
    (``param_specs``) and AdamW as ``optax.adamw(learning_rate)`` on them,
    so the moments are sharded as their parameters are (``gather_state``
    gives the global parameters). ``remat`` selects the
    memory / FLOPs trade per layer, each a ``torch.utils.checkpoint``
    (non-reentrant):
      False  — save all layer activations
      "ffn"  — recompute only the FFN block
      "dots" — save the weight products, recompute the rest (JAX's
               ``dots_with_no_batch_dims_saveable``); a layer's forward
               collectives (fsdp gathers, tp all-reduces, ring transfers)
               run again in the recompute, as under ``jax.checkpoint``
      True   — recompute the whole layer
    """
    shape = mesh_shape(mesh)
    dev = resolve_device(device)
    specs = param_specs(cfg)
    sharded = shape["fsdp"] > 1 or shape["tp"] > 1

    def init_state(seed_or_params=0):
        """(params, optimizer) from a seed (``init_params``) or from a
        global parameter dict (e.g. ``params_from_jax``): this rank's
        blocks copied onto the device. From a seed every rank first draws
        the global parameters on the device, the same on every rank; at
        Llama-3-8B's size that transient whole copy (32 GB in fp32) is
        more than a sharded run means to hold, and drawing each block
        alone is left to a later change."""
        if isinstance(seed_or_params, dict):
            params = shard_params(cfg, seed_or_params, mesh, dev)
        else:
            params = init_params(cfg, seed_or_params, device=dev)
            if sharded:
                params = shard_params(cfg, params, mesh)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return params, adamw(leaves, learning_rate)

    def shard_state(state):
        """Place a (params, optimizer) state on the mesh as JAX's
        ``shard_state`` does: a state of global parameters (and their
        moments) is cut to this rank's blocks in place
        (``parallel.mesh.shard_train_state``); one from ``init_state``
        already is."""
        params, opt = state
        # tok_emb is split on both dims whenever fsdp or tp is: a leaf of
        # its global shape means a global state
        if sharded and params["tok_emb"].shape == (cfg.vocab_size, cfg.dim):
            shard_train_state(params, opt, specs, mesh)
        return params, opt

    def train_step(state, tokens):
        """One AdamW step on ``tokens`` (b, s) on the device: on a mesh the
        GLOBAL batch, of which each rank computes its block. Parameters
        and moments are updated in place, the port's stand-in for JAX's
        donated state: the step keeps no second copy. On a mesh the
        gradients and the loss are summed over the data axes before the
        update, one flat buffer a group. Returns (state, loss), the loss a
        0-dim tensor (the global one) that is not synchronised."""
        params, opt = state
        opt.zero_grad(set_to_none=True)
        loss = compute_loss(cfg, params, tokens, remat, loss_chunk, mesh)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            sum_gradients(params, specs, mesh, DATA_AXES, extra=[loss])
        opt.step()
        return state, loss

    return init_state, shard_state, train_step, dev
