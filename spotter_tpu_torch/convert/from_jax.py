"""Carry the JAX package's flax params across into the port's `state_dict`.

Takes params as a nested dict of numpy arrays (`jax.device_get` of the
flax tree, or any loader's output) and imports neither JAX nor flax. The
port names every submodule after its flax module, so the mapping is a
rename of the leaf plus a fixed layout change:

- conv `kernel` HWIO (4-D) -> `weight` OIHW;
- dense `kernel` (in, out) (2-D) -> `weight` (out, in);
- LayerNorm and GroupNorm `scale` -> `weight`;
- FrozenBatchNorm `scale`/`bias`/`mean`/`var` -> buffers `weight`/`bias`/
  `running_mean`/`running_var`;
- any other leaf (RT-DETR's `query_embed`; the OWL towers' token and
  position tables and `class_embedding`; Deformable-DETR's `level_embed`
  and `query_embeddings`) keeps its name and layout.

Shared modules stay shared: RT-DETR's `query_pos_head` is one module used
by every decoder layer, and Deformable-DETR's `class_head`/`bbox_head`
(without box refinement) one pair for every layer, on both sides. Any key
the port does not have, and any port key the params do not supply, raises.
"""

from typing import Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _rename(path: str, array: np.ndarray) -> tuple[str, np.ndarray]:
    parent, _, leaf = path.rpartition(".")
    if leaf == "kernel":
        if array.ndim == 4:  # HWIO -> OIHW
            array = array.transpose(3, 2, 0, 1)
        elif array.ndim == 2:  # (in, out) -> (out, in)
            array = array.T
        else:
            raise ValueError(f"{path}: kernel of rank {array.ndim} has no mapping")
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf == "mean":
        leaf = "running_mean"
    elif leaf == "var":
        leaf = "running_var"
    return (f"{parent}.{leaf}" if parent else leaf), array


def state_dict_from_jax(params: Mapping, model: nn.Module) -> dict[str, torch.Tensor]:
    """Nested flax params -> a `model.load_state_dict`-ready dict.

    Raises ValueError on a params key with no counterpart in `model`, on a
    `model` key the params leave unset, and on any shape mismatch.
    """
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    unmapped = []
    for path, array in _flatten(params).items():
        key, array = _rename(path, array)
        if key not in expected:
            unmapped.append(path)
            continue
        target = expected[key]
        if tuple(array.shape) != tuple(target.shape):
            raise ValueError(
                f"{path} -> {key}: shape {array.shape} != port shape {tuple(target.shape)}"
            )
        out[key] = torch.from_numpy(np.array(array, copy=True)).to(target.dtype)
    unused = sorted(set(expected) - set(out))
    if unmapped or unused:
        raise ValueError(
            f"params without a port key: {sorted(unmapped)}; "
            f"port keys without params: {unused}"
        )
    return out


def load_from_jax(model: nn.Module, params: Mapping) -> nn.Module:
    """Load flax params into `model` in place (strict) and return it."""
    model.load_state_dict(state_dict_from_jax(params, model), strict=True)
    return model
