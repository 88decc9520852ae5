"""Vision Transformer in PyTorch — counterpart of ``ray_tpu/models/vit.py``.

Plain functions on a parameter dict with the JAX package's keys, shapes and
``(L, in, out)`` orientation: ``patch_emb``, ``patch_bias``, ``pos_emb``,
stacked ``layers`` {ln1/ln2 scale and bias, wq, wk, wv, wo, w1, b1, w2,
b2}, ``norm_scale``, ``norm_bias``, ``head``, ``head_bias``; weights move
1:1 between the two packages (``models/convert.py``). Images are NHWC, as
in the JAX package. ``patchify`` is a reshape and the patch embedding one
product; the layer stack runs as a Python loop over the leading layer axis
where JAX scans it. bf16 activations, fp32 LayerNorm statistics (population
variance, eps 1e-6), tanh-approximated GELU (``jax.nn.gelu``'s default),
mean-pooled tokens and an fp32 head.

``attention_impl``: "flash" calls ``ops/flash_attention.py::flash_attention``
unmasked (``causal=False``): K1 forward, K2 and K3 backward on CUDA, at
ViT-B/16's head_dim 64 and its 196 patches (a sequence no 64-row tile
divides). "xla" is plain attention as the JAX package writes it.

On a mesh (``parallel/mesh.py``: one process a position) the batch is
sharded over dp x fsdp and every other axis holds the same rows; each rank
holds its blocks of the weights as ``param_specs`` (the JAX package's
table) places them, and runs Llama's machinery (``models/_sharded.py``):
the fsdp gather at use; Megatron tp with wq/wk/wv and w1 column parallel
(b1 and head_bias split with their columns), wo and w2 row parallel; tp
gathers of the patch embedding's and the head's columns; attention on a
rank's own heads, or on all of them where tp does not split the heads
(ViT-B/16's 12 over tp 8); the gradient sums by group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models._sharded import (adamw, gather_heads,
                                          heads_split, own_columns,
                                          sum_gradients, use)
from ray_tpu_torch.parallel.mesh import (BATCH_AXES, P, copy_to, gather_from,
                                        gather_full, mesh_shape, reduce_from,
                                        shard_of, shard_train_state,
                                        tree_leaves, tree_map)


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    attention_impl: str = "flash"  # "flash" (the kernels) | "xla" (plain)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size * self.patch_size

    @classmethod
    def base(cls, **kw) -> "ViTConfig":  # ViT-B/16
        return cls(**kw)

    @classmethod
    def large(cls, **kw) -> "ViTConfig":  # ViT-L/16
        return cls(dim=1024, n_layers=24, n_heads=16, mlp_dim=4096, **kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, dim=64, n_layers=2,
                   n_heads=4, mlp_dim=128, num_classes=10, **kw)

    def num_params(self) -> int:
        per_layer = (
            4 * self.dim * self.dim          # wq wk wv wo
            + 2 * self.dim * self.mlp_dim    # w1 w2
            + self.mlp_dim + self.dim        # biases
            + 4 * self.dim                   # 2 LN scale+bias
        )
        return (
            self.patch_dim * self.dim + self.dim       # patch embed + bias
            + self.num_patches * self.dim              # pos emb
            + self.n_layers * per_layer
            + 2 * self.dim                             # final LN
            + self.dim * self.num_classes + self.num_classes
        )


def param_specs(cfg: ViTConfig) -> Dict[str, Any]:
    """The JAX package's ``param_specs``, key for key: qkv/w1 column
    parallel (tp on the output dim), wo/w2 row parallel; fsdp shards the
    other dim."""
    return {
        "patch_emb": P("fsdp", "tp"),
        "patch_bias": P(None),
        "pos_emb": P(None, "fsdp"),
        "layers": {
            "ln1_scale": P(None, None), "ln1_bias": P(None, None),
            "ln2_scale": P(None, None), "ln2_bias": P(None, None),
            "wq": P(None, "fsdp", "tp"),
            "wk": P(None, "fsdp", "tp"),
            "wv": P(None, "fsdp", "tp"),
            "wo": P(None, "tp", "fsdp"),
            "w1": P(None, "fsdp", "tp"),
            "b1": P(None, "tp"),
            "w2": P(None, "tp", "fsdp"),
            "b2": P(None, "fsdp"),
        },
        "norm_scale": P(None), "norm_bias": P(None),
        "head": P("fsdp", "tp"),
        "head_bias": P("tp"),
    }


# one layer's weight as ``_layer`` gets it: its spec without the layer axis
_LAYER_SPECS = {name: spec[1:] for name, spec in
                param_specs(None)["layers"].items()}


def init_params(cfg: ViTConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """The JAX package's initialisation from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default CUDA): dense weights N(0,
    1/fan_in), pos_emb N(0, 0.02²), biases zero, LayerNorm scales one, and
    the head zero (so a first step's gradient reaches only the head)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    pd = cfg.param_dtype
    L, D, M = cfg.n_layers, cfg.dim, cfg.mlp_dim

    def normal(shape, std):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(pd)

    def dense(shape, fan_in):
        return normal(shape, 1.0 / math.sqrt(fan_in))

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    return {
        "patch_emb": dense((cfg.patch_dim, D), cfg.patch_dim),
        "patch_bias": zeros(D),
        "pos_emb": normal((cfg.num_patches, D), 0.02),
        "layers": {
            "ln1_scale": ones(L, D), "ln1_bias": zeros(L, D),
            "ln2_scale": ones(L, D), "ln2_bias": zeros(L, D),
            "wq": dense((L, D, D), D),
            "wk": dense((L, D, D), D),
            "wv": dense((L, D, D), D),
            "wo": dense((L, D, D), D),
            "w1": dense((L, D, M), D),
            "b1": zeros(L, M),
            "w2": dense((L, M, D), M),
            "b2": zeros(L, D),
        },
        "norm_scale": ones(D),
        "norm_bias": zeros(D),
        "head": zeros(D, cfg.num_classes),
        "head_bias": zeros(cfg.num_classes),
    }


def shard_params(cfg: ViTConfig, params: Dict[str, Any], mesh,
                 device=None) -> Dict[str, Any]:
    """This rank's blocks of the global ``params`` on ``mesh``
    (``param_specs``), copied to ``device`` (default: each leaf's own)."""
    def cut(t, spec):
        return shard_of(t.detach(), spec, mesh).to(device or t.device,
                                                   copy=True)

    return tree_map(cut, params, param_specs(cfg))


def gather_state(cfg: ViTConfig, state, mesh) -> Dict[str, Any]:
    """The global parameters of a sharded (params, optimizer) state, on
    every rank (no gradient). Every rank calls it together."""
    return tree_map(lambda t, spec: gather_full(t.detach(), spec, mesh),
                    state[0], param_specs(cfg))


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The JAX package's LayerNorm: fp32 mean and population variance,
    scale and bias applied in fp32, the result in x's dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


def _attention(cfg: ViTConfig, q, k, v):
    """Bidirectional attention, (b, s, h, hd) layout."""
    if cfg.attention_impl == "flash":
        from ray_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=False)
    # the JAX package's plain version: logits in the compute dtype scaled
    # by 1/sqrt(hd) in that dtype, softmax in fp32, probabilities cast back
    scale = 1.0 / torch.tensor(math.sqrt(cfg.head_dim), dtype=q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _weight(cfg: ViTConfig, mesh, p, name: str):
    """Layer weight ``name`` in the compute dtype, gathered for use (fsdp
    splits each layer weight's model dim)."""
    return use(mesh, p[name].to(cfg.dtype), _LAYER_SPECS[name], cfg.dim)


def _layer(cfg: ViTConfig, mesh, h, p):
    dt, hd = cfg.dtype, cfg.head_dim
    b, s, d = h.shape
    wq, wk, wv, wo = (_weight(cfg, mesh, p, n) for n in ("wq", "wk", "wv",
                                                         "wo"))
    x = copy_to(layer_norm(h, p["ln1_scale"], p["ln1_bias"], cfg.norm_eps),
                mesh, "tp")
    if heads_split(mesh, cfg.n_heads):
        # this tp rank's heads (wq's columns, wo's rows: head-major)
        nh = cfg.n_heads // mesh_shape(mesh)["tp"]
        q, k, v = ((x @ w).reshape(b, s, nh, hd) for w in (wq, wk, wv))
        attn = _attention(cfg, q, k, v).reshape(b, s, nh * hd) @ wo
    else:
        # every head on every tp rank, from q, k and v gathered over tp
        q, k, v = (gather_heads(x @ w, mesh, cfg.n_heads, hd)
                   for w in (wq, wk, wv))
        o = _attention(cfg, q, k, v).reshape(b, s, d)
        attn = own_columns(o, mesh) @ wo
    h = h + reduce_from(attn, mesh, "tp")
    x = copy_to(layer_norm(h, p["ln2_scale"], p["ln2_bias"], cfg.norm_eps),
                mesh, "tp")
    x = F.gelu(x @ _weight(cfg, mesh, p, "w1") + p["b1"].to(dt),
               approximate="tanh")
    b2 = use(mesh, p["b2"].to(dt), _LAYER_SPECS["b2"], cfg.dim)
    return h + (reduce_from(x @ _weight(cfg, mesh, p, "w2"), mesh, "tp")
                + b2)


def patchify(cfg: ViTConfig, images: torch.Tensor) -> torch.Tensor:
    """(b, H, W, C) -> (b, num_patches, patch_dim) by reshapes: patches in
    row-major order, each patch's pixels row-major, channels innermost."""
    b = images.shape[0]
    p, n = cfg.patch_size, cfg.image_size // cfg.patch_size
    x = images.reshape(b, n, p, n, p, cfg.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, n * n, cfg.patch_dim)


def _backbone(cfg: ViTConfig, mesh, params, images, layer):
    """images (b, H, W, C) → the final LayerNorm's (b, num_patches, dim)."""
    dt = cfg.dtype
    specs = param_specs(cfg)
    emb = use(mesh, params["patch_emb"].to(dt), specs["patch_emb"],
              cfg.patch_dim)
    # the embedding's columns are split over tp: gathered, the backward
    # keeps the rank's columns
    h = gather_from(patchify(cfg, images).to(dt) @ emb, mesh, "tp", dim=-1,
                    size=cfg.dim)
    pos = use(mesh, params["pos_emb"].to(dt), specs["pos_emb"], cfg.dim)
    h = h + params["patch_bias"].to(dt) + pos
    # one unbind per stacked weight (see models/llama.py::_backbone)
    stacked = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.n_layers):
        h = layer(h, {name: ws[i] for name, ws in stacked.items()})
    return layer_norm(h, params["norm_scale"], params["norm_bias"],
                      cfg.norm_eps)


def _logits(cfg: ViTConfig, mesh, params, h):
    """Mean-pooled h (b, s, dim) → fp32 logits (b, num_classes): the head's
    class columns (and head_bias) split over tp and gathered after."""
    head = use(mesh, params["head"].float(), param_specs(cfg)["head"],
               cfg.dim)
    pooled = copy_to(h.mean(dim=1).float(), mesh, "tp")
    return gather_from(pooled @ head + params["head_bias"].float(), mesh,
                       "tp", dim=-1, size=cfg.num_classes)


# images and labels: the batch over both data axes, the rest whole
IMAGE_SPEC = P(BATCH_AXES, None, None, None)
LABEL_SPEC = P(BATCH_AXES)


def forward(cfg: ViTConfig, params: Dict[str, Any], images: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """images (b, H, W, C) → logits (b, num_classes), fp32.

    On a ``mesh`` (every rank calls it together) ``params`` are this rank's
    blocks (``shard_params``) and ``images`` the GLOBAL batch; the result
    is this rank's block of the logits, rows [(dp_idx·fsdp + fsdp_idx)·
    b/(dp·fsdp), ...), every class on every tp rank."""
    if mesh is not None:
        images = shard_of(images, IMAGE_SPEC, mesh)
    h = _backbone(cfg, mesh, params, images, partial(_layer, cfg, mesh))
    return _logits(cfg, mesh, params, h)


def compute_loss(cfg: ViTConfig, params, images: torch.Tensor,
                 labels: torch.Tensor, remat=False, mesh=None
                 ) -> torch.Tensor:
    """Cross-entropy of the logits on integer ``labels`` (b,), the mean
    over the batch: the loss ``make_train_step`` differentiates. On a
    ``mesh`` ``images`` and ``labels`` are the global batch and the rank's
    NLL sum over its rows is divided by the global b, so the ranks' losses
    (one a data block; tp ranks share theirs) add up to the global mean."""
    b = labels.shape[0]
    layer = partial(_layer, cfg, mesh)
    if remat:
        layer = partial(checkpoint, layer, use_reentrant=False,
                        preserve_rng_state=False)
    if mesh is not None:
        images = shard_of(images, IMAGE_SPEC, mesh)
        labels = shard_of(labels, LABEL_SPEC, mesh)
    logits = _logits(cfg, mesh, params,
                     _backbone(cfg, mesh, params, images, layer))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    return nll.sum() / b


def make_train_step(cfg: ViTConfig, mesh=None, learning_rate: float = 1e-3,
                    remat=False, device=None):
    """Build (init_state, shard_state, train_step, data_device), as the
    port's ``models/llama.py::make_train_step``: on one device (``mesh``
    None) or on a ``DeviceMesh`` with dp, fsdp and tp axes (one process a
    position; every rank calls each function together; pp, as in JAX, is
    a replica axis). State = (params, optimizer): this rank's
    blocks of the parameters (``param_specs``) and AdamW as
    ``optax.adamw(learning_rate)`` on them. ``remat`` recomputes each layer
    in the backward (``jax.checkpoint``'s counterpart). ``device`` defaults
    to CUDA."""
    shape = mesh_shape(mesh)
    dev = resolve_device(device)
    specs = param_specs(cfg)
    sharded = shape["fsdp"] > 1 or shape["tp"] > 1

    def init_state(seed_or_params=0):
        """(params, optimizer) from a seed (``init_params``, drawn whole on
        every rank, then cut) or from a global parameter dict (e.g.
        ``params_from_jax``): this rank's blocks on the device."""
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
        """A state of global parameters (and their moments) cut to this
        rank's blocks in place (``parallel.mesh.shard_train_state``); one
        from ``init_state`` already is."""
        params, opt = state
        # patch_emb is split on both dims whenever fsdp or tp is
        if sharded and params["patch_emb"].shape == (cfg.patch_dim, cfg.dim):
            shard_train_state(params, opt, specs, mesh)
        return params, opt

    def train_step(state, images, labels):
        """One AdamW step on ``images`` (b, H, W, C) and ``labels`` (b,) on
        the device, on a mesh the GLOBAL batch. Parameters and moments are
        updated in place. On a mesh the gradients and the loss are summed
        over dp and fsdp before the update (``_sharded.sum_gradients``).
        Returns (state, loss), the loss a 0-dim tensor (the global one)
        that is not synchronised."""
        params, opt = state
        opt.zero_grad(set_to_none=True)
        loss = compute_loss(cfg, params, images, labels, remat, mesh)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            sum_gradients(params, specs, mesh, BATCH_AXES, extra=[loss])
        opt.step()
        return state, loss

    return init_state, shard_state, train_step, dev


__all__ = [
    "ViTConfig",
    "forward",
    "init_params",
    "make_train_step",
    "param_specs",
    "patchify",
]
