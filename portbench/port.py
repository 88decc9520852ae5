"""The program as the benchmark builds it: the port's ``LlamaConfig`` from a
configuration file's fields (no preset of the program is used)."""

from __future__ import annotations

from typing import Dict

import yardstick


def llama_config(mc: Dict, param_dtype, **kw):
    import torch

    from ray_tpu_torch.models.llama import LlamaConfig

    w = yardstick.dims(mc)
    cfg = LlamaConfig(vocab_size=w["vocab"], dim=w["dim"],
                      n_layers=w["n_layers"], n_heads=w["n_heads"],
                      n_kv_heads=w["n_kv_heads"], ffn_dim=w["ffn"],
                      rope_theta=float(mc["rope_theta"]),
                      norm_eps=float(mc["rms_norm_eps"]),
                      dtype=getattr(torch, mc["run"]["compute_dtype"]),
                      param_dtype=param_dtype, **kw)
    if cfg.head_dim != w["head_dim"]:
        raise ValueError(f"head_dim {w['head_dim']} is not dim / heads")
    return cfg


def passes(checks: Dict) -> bool:
    """Whether every compared number keeps its limit; ``checks`` is
    {name: (value, "<=" or ">=", limit)}."""
    return all((v <= lim) if op == "<=" else (v >= lim)
               for v, op, lim in checks.values())
