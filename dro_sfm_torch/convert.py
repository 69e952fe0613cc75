"""Carry weights from the JAX package's variable tree into the port.

The port names its submodules after the JAX parameter tree, so the mapping
is a rule per leaf with no table of renames: the path joined with dots is
the module path, and

* a conv ``kernel`` (HWIO) becomes ``weight`` (OIHW); ``bias`` stays;
* BatchNorm ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  become ``weight``/``bias``/``running_mean``/``running_var``, plus the
  ``num_batches_tracked`` counter that torch keeps and flax does not.

The fused ``convzr*`` GRU convs keep their z-then-r layout. An upstream torch
checkpoint reaches the port through `torch_weights.py:convert_dro_checkpoint`
(numpy) and then `from_jax_variables`. `to_jax_variables` is the inverse.

The optimizer's state maps the same way (`optimizer_state_from_jax`,
`optimizer_state_to_jax`): the JAX package's optax state, serialized by
flax's ``to_state_dict``, is a ``multi_transform`` over the groups "depth"
and "pose" (``inner_states/<group>/inner_state``), behind index ``1`` of a
chain when the global-norm clip is on (the clip's empty state is ``0``).
Each group is a chain: Adam ``0/{count,mu,nu}`` then, with a weight decay,
an empty ``1``, then the schedule's ``count``; SGD ``0/trace`` then the
schedule's ``count``. ``mu``, ``nu`` and ``trace`` follow the params tree,
with an empty map where a leaf belongs to the other group. They become
torch's ``exp_avg``, ``exp_avg_sq`` and ``momentum_buffer`` by the leaf rule
above; Adam's ``count`` becomes each parameter's ``step``.
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


class LayoutMismatch(ValueError):
    """A serialized optax state whose layout is not the one this optimizer
    would have in the JAX package."""


def _bn_modules(state_dict) -> set:
    return {k[:-len(".running_mean")] for k in state_dict if k.endswith(".running_mean")}


def _jax_param_path(name: str, bn_modules) -> Tuple[Tuple[str, ...], bool]:
    """A parameter's path in the JAX params tree, and whether its value is
    a conv weight (OIHW here, HWIO there)."""
    module, leaf = name.rsplit(".", 1)
    path = tuple(module.split("."))
    if module in bn_modules:
        return (*path, {"weight": "scale", "bias": "bias"}[leaf]), False
    if leaf == "weight":
        return (*path, "kernel"), True
    if leaf == "bias":
        return (*path, "bias"), False
    raise ValueError(f"no rule for parameter {name}")


def _to_numpy(value: torch.Tensor, conv: bool) -> np.ndarray:
    value = value.detach().cpu()
    if conv:
        if value.ndim != 4:
            raise ValueError(f"expected an OIHW conv weight, got shape {tuple(value.shape)}")
        value = value.permute(2, 3, 1, 0)
    return np.ascontiguousarray(value.numpy())


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _get(tree: Dict, path: Tuple[str, ...]):
    for p in path:
        tree = tree[p]
    return tree


def to_jax_variables(state_dict) -> Dict[str, Dict]:
    """The port's ``state_dict`` -> ``{"params": ..., "batch_stats": ...}``
    of numpy arrays, the inverse of `from_jax_variables`: OIHW -> HWIO,
    BatchNorm names back, ``num_batches_tracked`` dropped."""
    bn = _bn_modules(state_dict)
    variables: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    stats = {"running_mean": "mean", "running_var": "var"}
    for name, value in state_dict.items():
        module, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        if leaf in stats:
            _set(variables["batch_stats"], (*module.split("."), stats[leaf]),
                 _to_numpy(value, False))
            continue
        path, conv = _jax_param_path(name, bn)
        _set(variables["params"], path, _to_numpy(value, conv))
    return variables


def _optax_groups(net: torch.nn.Module, optimizer):
    """(group, kind, decay, [(name, param), ...]) for the JAX package's two
    groups in its order; a group that holds no parameter has an empty list."""
    names = {id(p): n for n, p in net.named_parameters()}
    torch_opt = optimizer.torch_optimizer
    kind = "sgd" if isinstance(torch_opt, torch.optim.SGD) else "adam"
    members = {g: [(names[id(p)], p) for p in pg["params"]]
               for g, pg in zip(optimizer.groups, torch_opt.param_groups)}
    return [(g, kind, optimizer.decays.get(g, 0.0), members.get(g, []))
            for g in ("depth", "pose")]


def _moment(state, key, param):
    value = state.get(key)
    return torch.zeros_like(param) if value is None else value


def optimizer_state_to_jax(net: torch.nn.Module, optimizer, step: int) -> Dict:
    """The serialized optax state that the JAX package's ``make_optimizer``
    would hold for this net and optimizer after ``step`` updates, with the
    torch moments (zeros where a parameter has none yet) as numpy arrays."""
    sd = net.state_dict()
    bn = _bn_modules(sd)
    paths = {n: _jax_param_path(n, bn) for n, _ in net.named_parameters()}
    count = np.asarray(step, np.int32)
    groups: Dict[str, Dict] = {}
    for g, kind, decay, members in _optax_groups(net, optimizer):
        keys = ("exp_avg", "exp_avg_sq") if kind == "adam" else ("momentum_buffer",)
        moments = []
        for key in keys:
            tree: Dict = {}
            for path, _ in paths.values():        # masked leaves: empty maps
                _set(tree, path, {})
            for name, p in members:
                path, conv = paths[name]
                _set(tree, path, _to_numpy(
                    _moment(optimizer.torch_optimizer.state.get(p, {}), key, p), conv))
            moments.append(tree)
        if kind == "adam":
            chain = {"0": {"count": count, "mu": moments[0], "nu": moments[1]}}
            if decay > 0:
                chain["1"] = {}
            chain[str(len(chain))] = {"count": count}
        else:
            chain = {"0": {"trace": moments[0]}, "1": {"count": count}}
        groups[g] = {"inner_state": chain}
    state = {"inner_states": groups}
    return {"0": {}, "1": state} if optimizer.clip_grad_norm > 0 else state


def _flat_leaves(tree, path=()) -> Dict[Tuple[str, ...], tuple]:
    """Path -> shape of every array leaf (empty maps, which stand for masked
    leaves and empty states, have none)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, (*path, k)))
        else:
            out[(*path, k)] = tuple(np.shape(v))
    return out


def optimizer_state_from_jax(opt_state: Dict, net: torch.nn.Module, optimizer) -> None:
    """Load the JAX package's serialized optax state into ``optimizer``.
    Raises `LayoutMismatch`, and changes nothing, unless its array leaves
    are exactly those this optimizer's layout has, with the same shapes."""
    want = _flat_leaves(optimizer_state_to_jax(net, optimizer, 0))
    got = _flat_leaves(opt_state) if isinstance(opt_state, dict) else {}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()), key=str)
        raise LayoutMismatch(f"{len(diff)} leaves differ, first "
                             f"{'/'.join(map(str, diff[0][0]))} {diff[0][1]}")
    root = opt_state["1"] if optimizer.clip_grad_norm > 0 else opt_state
    bn = _bn_modules(net.state_dict())
    index = {id(p): i for i, p in enumerate(
        p for pg in optimizer.torch_optimizer.param_groups for p in pg["params"])}
    state = {}
    for g, kind, _, members in _optax_groups(net, optimizer):
        chain = root["inner_states"][g]["inner_state"]
        for name, p in members:
            path, conv = _jax_param_path(name, bn)

            def moment(tree):
                value = torch.from_numpy(np.ascontiguousarray(_get(tree, path)))
                return value.permute(3, 2, 0, 1).contiguous() if conv else value

            if kind == "adam":
                state[index[id(p)]] = {
                    "step": torch.tensor(float(chain["0"]["count"]), dtype=torch.float32),
                    "exp_avg": moment(chain["0"]["mu"]),
                    "exp_avg_sq": moment(chain["0"]["nu"])}
            else:
                state[index[id(p)]] = {"momentum_buffer": moment(chain["0"]["trace"])}
    sd = optimizer.torch_optimizer.state_dict()
    optimizer.torch_optimizer.load_state_dict({"state": state,
                                               "param_groups": sd["param_groups"]})
