"""Weights from elsewhere: pretrained encoder trunks and partial loads.

The port's copy of `dro_sfm_tpu/training/init_weights.py`. Both functions
work on the JAX package's variable tree (``{"params": ..., "batch_stats":
...}`` of numpy arrays), so that they adopt what the JAX functions adopt;
`warm_start` carries a net there (`convert.to_jax_variables`), applies them
in the JAX trainer's order and loads the result back strictly
(`convert.from_jax_variables`).

* `graft_pretrained_encoders`: a converted single-image ResNet-18 trunk
  (flax msgpack, written offline by `tools/convert_torch_weights.py`) on
  each of the three encoders; conv1 is replicated and divided by the image
  count where an encoder takes a stacked image pair.
* `load_partial_network`: every array of a saved checkpoint (the JAX
  package's or the port's) or bare variables file whose path (after a
  prefix ``remap``) and shape match the target; the rest keeps its
  initialisation.
"""
from __future__ import annotations

import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dro_sfm_torch.convert import from_jax_variables, to_jax_variables
from dro_sfm_torch.utils.msgpack import unpackb

ENCODER_NAMES = ("fnet", "cnet_depth", "cnet_pose")


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def _set_path(tree: Dict, path: Tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _copy_tree(tree: Dict) -> Dict:
    """A copy of the maps (flax's ``to_state_dict`` of a dict); leaves shared."""
    return {k: _copy_tree(v) if isinstance(v, dict) else v for k, v in tree.items()}


def load_msgpack_tree(path: str) -> Dict:
    with open(path, "rb") as f:
        return unpackb(f.read())


def graft_pretrained_encoders(variables: Dict, trunk: Dict,
                              verbose: bool = True) -> Dict:
    """Graft a converted single-image ResNet-18 trunk (``{"params": ...,
    "batch_stats": ...}``, 3-channel conv1) onto every encoder of
    ``variables``; an encoder whose conv1 takes a stacked pair gets the
    kernel replicated and divided by the image count. Returns new
    variables; everything outside the trunks keeps its values. Raises when
    nothing matched."""
    params = _copy_tree(variables["params"])
    stats = _copy_tree(variables.get("batch_stats", {}))
    trunk_p = _flatten(trunk["params"])
    trunk_s = _flatten(trunk.get("batch_stats", {}))
    n_grafted = 0
    for enc in ENCODER_NAMES:
        if enc not in params:
            continue
        for src, dst_tree in ((trunk_p, params), (trunk_s, stats)):
            for path, value in src.items():
                node = dst_tree.get(enc, {})
                ok = True
                for p in path:
                    if not isinstance(node, dict) or p not in node:
                        ok = False
                        break
                    node = node[p]
                if not ok:
                    continue
                value = np.asarray(value)
                if path == ("conv1", "kernel") and node.shape[2] != value.shape[2]:
                    n_img = node.shape[2] // value.shape[2]
                    value = np.concatenate([value] * n_img, axis=2) / n_img
                if value.shape != node.shape:
                    raise ValueError(
                        f"pretrained {enc}/{'/'.join(path)}: shape "
                        f"{value.shape} vs model {node.shape}")
                _set_path(dst_tree, (enc, *path), value.astype(node.dtype))
                n_grafted += 1
    if verbose:
        print(f"pretrained encoders: grafted {n_grafted} arrays onto "
              f"{[e for e in ENCODER_NAMES if e in params]}")
    if n_grafted == 0:
        raise ValueError("pretrained encoder graft matched nothing — "
                         "wrong msgpack or model structure")
    out = dict(variables)
    out["params"] = params
    out["batch_stats"] = stats
    return out


def _saved_variables(path: str) -> Dict:
    """``{"params", "batch_stats"}`` of a checkpoint of the port (a zip
    file), or of a flax msgpack file: a JAX checkpoint (or its ``payload``)
    or bare variables."""
    if zipfile.is_zipfile(path):
        from dro_sfm_torch.training.checkpoint import load_checkpoint
        return to_jax_variables(load_checkpoint(path)["payload"]["net"])
    raw = load_msgpack_tree(path)
    if "payload" in raw:
        raw = raw["payload"]
    return {"params": raw.get("params", {}), "batch_stats": raw.get("batch_stats", {})}


def load_partial_network(variables: Dict, ckpt_path: str,
                         remap: Optional[Dict[str, str]] = None,
                         verbose: bool = True) -> Dict:
    """Adopt every array of ``ckpt_path`` whose path (leading components
    renamed by ``remap``, e.g. ``{"depth_net": ""}``) and shape match
    ``variables``; print the adopted and skipped counts; raise when nothing
    matched."""
    src = _saved_variables(ckpt_path)

    def apply_remap(path: Tuple[str, ...]) -> Tuple[str, ...]:
        if not remap:
            return path
        parts = list(path)
        for old, new in remap.items():
            old_parts = tuple(old.split("/"))
            if tuple(parts[:len(old_parts)]) == old_parts:
                repl = [p for p in new.split("/") if p]
                parts = repl + parts[len(old_parts):]
        return tuple(parts)

    out = {"params": _copy_tree(variables["params"]),
           "batch_stats": _copy_tree(variables.get("batch_stats", {}))}
    adopted, skipped = 0, 0
    for col in ("params", "batch_stats"):
        flat_target = _flatten(out[col])
        for path, value in _flatten(src[col]).items():
            path = apply_remap(path)
            tgt = flat_target.get(path)
            if tgt is None or np.shape(value) != np.shape(tgt):
                skipped += 1
                continue
            _set_path(out[col], path, np.asarray(value).astype(np.asarray(tgt).dtype))
            adopted += 1
    if verbose:
        print(f"partial load from {ckpt_path}: adopted {adopted} arrays, "
              f"skipped {skipped}")
    if adopted == 0:
        raise ValueError(f"partial load from {ckpt_path} matched nothing")
    return {**variables, **out}


def warm_start(net: torch.nn.Module, pretrained_encoders: str = "",
               checkpoint_path: str = "", verbose: bool = True) -> None:
    """The JAX trainer's warm start, in its order: graft the encoder trunks
    of ``pretrained_encoders``, then adopt what matches from
    ``checkpoint_path``; the net takes the result strictly."""
    if not (pretrained_encoders or checkpoint_path):
        return
    variables = to_jax_variables(net.state_dict())
    if pretrained_encoders:
        variables = graft_pretrained_encoders(
            variables, load_msgpack_tree(pretrained_encoders), verbose=verbose)
    if checkpoint_path:
        variables = load_partial_network(variables, checkpoint_path, verbose=verbose)
    net.load_state_dict(from_jax_variables(variables), strict=True)
