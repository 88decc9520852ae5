"""Carries weights from the JAX package into the port.

The caller turns the JAX parameter pytree into nested numpy arrays
(``jax.tree.map(np.asarray, params)``), so the port never imports JAX.
Keys, shapes, orientation and values come across unchanged, for every
model family (``llama.py``, ``vit.py``): both packages store dense weights
as ``(L, in, out)``, so nothing is transposed.
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


def params_from_jax(tree, device) -> Any:
    """Nested dict of numpy arrays → the same nest of torch tensors on
    ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)
