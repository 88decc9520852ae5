"""Carries weights from the JAX package into the port.

The caller turns the JAX parameter pytree into nested numpy arrays
(``jax.tree.map(np.asarray, params)``), so the port never imports JAX.
Keys, shapes, orientation and values come across unchanged, for every
model family (``llama.py``, ``vit.py``): both packages store dense weights
as ``(L, in, out)``, so nothing is transposed. The rllib learners' MLPs
(``rllib/learner.py::init_mlp``) are lists of ``{"w", "b"}`` dicts: lists
and tuples cross as they are too.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch twin: widen exactly,
        # then narrow back on the torch side
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)  # a copy: JAX's buffers are read-only


def nest_map(fn, tree):
    """``fn`` on each leaf of a nest of dicts, lists and tuples: the same
    nest of its results."""
    if isinstance(tree, dict):
        return {k: nest_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(nest_map(fn, v) for v in tree)
    return fn(tree)


def params_from_jax(tree, device) -> Any:
    """A nest (dicts, lists, tuples) of numpy arrays → the same nest of
    torch tensors on ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    return nest_map(lambda a: _to_tensor(a, dev), tree)
