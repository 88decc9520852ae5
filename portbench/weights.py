"""Weights drawn by the benchmark from the run's seed, on the device, in the
type they are served or trained in, in the port's parameter-dict layout
(``tok_emb``, stacked ``layers`` {ln1, ln2, wq, wk, wv, wo, w1, w2, w3} in
(L, in, out) orientation, ``norm``, ``lm_head``). The same tensors go to
the program and to the reference; the program's own ``init_params`` is not
used. One ``torch.randn`` call a leaf, from one generator on the device."""

from __future__ import annotations

import math
from typing import Dict

import torch

import traffic
import yardstick


def draw(mc: Dict, seed: int, device, dtype) -> Dict:
    """N(0, 1/fan_in) projections and embedding, norms 1."""
    w = yardstick.dims(mc)
    gen = torch.Generator(device=device).manual_seed(traffic.torch_seed(seed, 0))
    L, d, hd = w["n_layers"], w["dim"], w["head_dim"]
    qd, kvd, f = w["n_heads"] * hd, w["n_kv_heads"] * hd, w["ffn"]

    def dense(fan_in, *shape):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        "tok_emb": dense(d, w["vocab"], d),
        "layers": {
            "ln1": ones(L, d), "ln2": ones(L, d),
            "wq": dense(d, L, d, qd), "wk": dense(d, L, d, kvd),
            "wv": dense(d, L, d, kvd), "wo": dense(qd, L, qd, d),
            "w1": dense(d, L, d, f), "w3": dense(d, L, d, f),
            "w2": dense(f, L, f, d),
        },
        "norm": ones(d),
        "lm_head": dense(d, d, w["vocab"]),
    }


def leaves(params: Dict) -> Dict[str, torch.Tensor]:
    """Flat {name: tensor} of a parameter dict, names as ``layers.wq``."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": t for n, t in v.items()})
        else:
            out[k] = v
    return out


def checksum(params: Dict) -> Dict[str, float]:
    """Per-leaf float64 sums: two draws from one seed must match exactly."""
    return {k: sum(float(c.double().sum()) for c in t.reshape(-1).split(1 << 26))
            for k, t in leaves(params).items()}
