"""JAX params and optimizer state -> the port's.

The port's params tree has the JAX package's structure leaf for leaf (dicts,
tuples, empty tuples for weightless modules), so conversion is a tree map.
The input is the JAX params as numpy, as
``jax.tree_util.tree_map(np.asarray, params)`` gives them; this module reads
only numpy and imports no JAX. The same holds for optax's Adam state, whose
per-leaf moments ``adam_moment_leaves`` lists in the order of the port's flat
vectors (``train/optim.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from l2hmc_tpu_torch.config import resolve_device
from l2hmc_tpu_torch.train.optim import tree_leaves


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


def _find_adam(state: Any):
    """The node with ``mu``, ``nu`` and ``count`` inside an optax state
    (a chain's tuple, ``apply_if_finite``'s ``inner_state``), or None."""
    if all(hasattr(state, a) for a in ("mu", "nu", "count")):
        return state
    if hasattr(state, "inner_state"):
        return _find_adam(state.inner_state)
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def adam_moment_leaves(opt_state: Any) -> tuple[list, list]:
    """(first-moment leaves, second-moment leaves) of the Adam state inside
    an optax optimizer state, as numpy arrays in the params tree's leaf
    order (dict keys sorted), which is the order of the port's flat
    vectors."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in this optimizer state")
    return ([np.asarray(a) for a in tree_leaves(adam.mu)],
            [np.asarray(a) for a in tree_leaves(adam.nu)])

