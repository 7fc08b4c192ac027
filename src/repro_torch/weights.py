"""Weight bridge: the JAX package's parameter tree, as numpy, into torch.

The JAX package's ``init_params`` draws its weights with ``jax.random``,
which torch cannot reproduce, so tests hand the JAX parameter tree across
as numpy arrays and both packages run on the same weights.  The bridge
keeps the tree exactly as it is:

* the stacked layer axis (every per-layer leaf keeps its leading
  ``num_layers`` axis);
* factored ``{"u", "v"}`` low-rank weights, which ``matmul_w`` executes
  as two thin matmuls in both packages;
* each leaf's dtype, so the f32 exceptions of ``cast_params``
  (``a_log``, ``d_skip``, ``dt_bias``, ``router``) stay f32 and are
  handled by the port's ``cast_params`` exactly as by the JAX one.

Nothing here imports JAX: any object numpy can convert (a JAX array
included) is accepted as a leaf.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf_to_torch(a: Any, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16; the value is exact in f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Convert a nested dict (or list/tuple) of arrays into the same
    structure of torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def params_to_numpy(tree: Any) -> Any:
    """The inverse bridge: torch tensors to numpy (bf16 leaves as f32)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
