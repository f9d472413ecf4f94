"""Checkpoint and resume (counterpart of ``l2hmc_tpu/io/checkpoint.py``).

A checkpoint is one ``torch.save`` file of a plain tree: the state's
tensors moved to the CPU, a ``torch.Generator`` as its state (a byte tensor)
in place of the JAX package's typed PRNG key, Python numbers as they are.
Everything needed to rebuild the sampler is explicit: the state plus the
config (with its ``mask_seed``) as a JSON sidecar ``<path>.config.json``.
Loading uses ``weights_only=True``, so a checkpoint holds nothing but
tensors, numbers and containers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import torch

_GENERATOR = "__torch_generator_state__"


def _pack(node: Any) -> Any:
    """The state as a tree of dicts, lists, CPU tensors and numbers."""
    if isinstance(node, torch.Generator):
        return {_GENERATOR: node.get_state(), "device": str(node.device)}
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, dict):
        return {k: _pack(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):  # NamedTuples too
        return [_pack(v) for v in node]
    return node


def _unpack(saved: Any, target: Any) -> Any:
    """``saved`` in the structure, devices and container types of ``target``."""
    if isinstance(target, torch.Generator):
        gen = torch.Generator(device=target.device)
        gen.set_state(saved[_GENERATOR])
        return gen
    if isinstance(target, torch.Tensor):
        if tuple(saved.shape) != tuple(target.shape):
            raise ValueError(
                f"checkpoint leaf of shape {tuple(saved.shape)}, expected {tuple(target.shape)}")
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        return {k: _unpack(saved[k], v) for k, v in target.items()}
    if isinstance(target, (tuple, list)):
        if len(saved) != len(target):
            raise ValueError(f"checkpoint node of {len(saved)} entries, expected {len(target)}")
        items = [_unpack(s, t) for s, t in zip(saved, target)]
        if hasattr(target, "_fields"):
            return type(target)(*items)
        return type(target)(items)
    return type(target)(saved) if target is not None else saved


def save_checkpoint(path: str, state: Any, config: Any = None) -> None:
    """Save a state tree (e.g. a ``VaeState``) and, beside it, an optional
    dataclass config as JSON."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(_pack(state), tmp)
    os.replace(tmp, path)
    if config is not None:
        cfg = dataclasses.asdict(config) if dataclasses.is_dataclass(config) else dict(config)
        with open(path + ".config.json", "w") as f:
            json.dump(cfg, f, indent=2, default=str)


def restore_checkpoint(path: str, target: Any) -> Any:
    """Restore into the structure of ``target`` (a state of the right
    shapes, whose tensors' devices the result takes)."""
    saved = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return _unpack(saved, target)


def load_config(path: str) -> Optional[dict]:
    cfg_path = os.path.abspath(path) + ".config.json"
    if not os.path.exists(cfg_path):
        return None
    with open(cfg_path) as f:
        return json.load(f)


def config_from_dict(cls, d: dict):
    """Rebuild a dataclass config from its JSON dict (``save_checkpoint``'s
    sidecar). Unknown keys are ignored; values are coerced through the field
    default's type, since JSON gives tuples back as lists and
    ``default=str`` turns exotic values into strings. Config and
    ``mask_seed`` together rebuild the sampler, masks included."""
    base = cls()
    fields = {f.name for f in dataclasses.fields(cls)}
    overrides = {}
    for k, v in d.items():
        if k not in fields or v is None:
            continue
        current = getattr(base, k)
        if isinstance(current, bool):
            overrides[k] = v if isinstance(v, bool) else str(v).lower() in ("1", "true", "yes")
        elif isinstance(current, tuple):
            overrides[k] = tuple(v)
        elif current is not None:
            overrides[k] = type(current)(v)
        else:
            overrides[k] = v
    return dataclasses.replace(base, **overrides)
