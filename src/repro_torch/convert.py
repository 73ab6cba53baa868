"""Hand a JAX params or cache pytree to the port, and tensors back to numpy.

The reference's parameters reach this module as numpy arrays (the caller
runs ``jax.tree.map(np.asarray, tree)``), so nothing here imports JAX.
numpy has no native bfloat16: JAX's bf16 arrays arrive with the
``ml_dtypes`` extension dtype named ``"bfloat16"``, whose bits are taken
over unchanged through a uint16 view.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One numpy array (or scalar) -> a tensor on ``device``, dtype kept."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def params_from_jax(np_tree: Any, device="cuda") -> Any:
    """The reference's params pytree or cache dict (nested dicts of numpy
    arrays) -> the same nesting of tensors on ``device``: stacked
    per-layer leaves keep their leading layer axis ``(L, ...)``, caches
    their ``(L, B, C, Hkv, hd)`` layout."""
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, device) for k, v in np_tree.items()}
    return tensor_from_numpy(np_tree, device)


def to_numpy(t: Any) -> Any:
    """Tensors (nested in dicts) -> numpy; bf16 is widened to float32."""
    if isinstance(t, dict):
        return {k: to_numpy(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return t
