"""JAX params -> port params.

The port's params tree has the JAX package's structure leaf for leaf (dicts,
tuples, empty tuples for weightless modules), so conversion is a tree map.
The input is the JAX params as numpy, as
``jax.tree_util.tree_map(np.asarray, params)`` gives them; this module reads
only numpy and imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from l2hmc_tpu_torch.config import resolve_device


def params_from_jax(tree: Any, device=None) -> Any:
    """Nested dict/tuple/list of numpy arrays -> the same tree of float32
    tensors on ``device`` (``cuda`` unless the caller says otherwise)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        arr = np.asarray(node)
        if arr.dtype.kind != "f":
            raise TypeError(f"expected a float array leaf, got dtype {arr.dtype}")
        return torch.as_tensor(arr.astype(np.float32), device=dev)

    return conv(tree)
