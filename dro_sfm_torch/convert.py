"""Carry weights from the JAX package's variable tree into the port.

The port names its submodules after the JAX parameter tree, so the mapping
is a rule per leaf with no table of renames: the path joined with dots is
the module path, and

* a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW); ``bias`` stays;
* BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  become ``weight``/``bias``/``running_mean``/``running_var``, plus the
  ``num_batches_tracked`` counter that torch keeps and flax does not.

The fused ``convzr*`` GRU convs keep their z-then-r layout. An upstream torch
checkpoint reaches the port through
`tools/convert_torch_weights.py:convert_dro_checkpoint` (numpy) and then
`from_jax_variables`.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _leaves(value, (*path, key))
        else:
            yield (*path, key), np.asarray(value)


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (nested dicts of arrays, as
    ``net.init`` returns them) -> the port's ``state_dict``."""
    state: Dict[str, torch.Tensor] = {}
    stats = variables.get("batch_stats", {})
    bn_modules = {path[:-1] for path, _ in _leaves(stats)}
    for path, value in _leaves(variables["params"]):
        module, leaf = path[:-1], path[-1]
        if module in bn_modules:
            name = _BN_PARAMS[leaf]
        elif leaf == "kernel":
            if value.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected an HWIO conv "
                                 f"kernel, got shape {value.shape}")
            name, value = "weight", value.transpose(3, 2, 0, 1)
        elif leaf == "bias":
            name = "bias"
        else:
            raise ValueError(f"no rule for parameter {'/'.join(path)}")
        state[".".join((*module, name))] = torch.from_numpy(
            np.ascontiguousarray(value, dtype=np.float32))
    for path, value in _leaves(stats):
        module = ".".join(path[:-1])
        state[f"{module}.{_BN_STATS[path[-1]]}"] = torch.from_numpy(
            np.ascontiguousarray(value, dtype=np.float32))
    for module in bn_modules:
        state[".".join((*module, "num_batches_tracked"))] = torch.tensor(0)
    return state
