"""Upstream torch weights for the port: torchvision trunks, the VGG16 of the
perceptual loss and the reference's DRO checkpoints.

The port's copy of the numpy maps of `tools/convert_torch_weights.py`
(`conv_w`, `convert_resnet18_encoder`, `convert_vgg16_percep`,
`convert_dro_checkpoint` and its stride-8 `_DRO_ENCODER_HEADS`, copied as
they are) and of its `emit_framework_ckpt`, which here writes the JAX
package's checkpoint with the port's own msgpack writer and config. The
trees are the JAX package's ``{"params", "batch_stats"}``; the port's
readers take them (`convert.from_jax_variables`, `init_weights.warm_start`,
`models/sfm.py:make_percep_fn`, `inference.load_model`, `Trainer(resume=)`).

Two readers, neither of which imports yacs:

* `read_torch_state`: a plain state dict (torchvision's ``.pth``), read with
  ``torch.load(weights_only=True)``;
* `read_reference_ckpt`: the reference's ``.ckpt``, whose config is pickled
  as a ``yacs.config.CfgNode``, read through a restricted unpickler
  (`ReferenceUnpickler`) that admits torch's tensor rebuilds, its dtypes and
  devices, the builtin containers and ``CfgNode`` (as `ReferenceConfig`, a
  plain ``dict``), and refuses every other global by name.
"""
from __future__ import annotations

import _compat_pickle
import collections
import json
import os
import pickle
import types
from typing import Any, Dict, Optional

import numpy as np
import torch


def conv_w(t):
    """OIHW -> HWIO."""
    return np.transpose(np.asarray(t), (2, 3, 1, 0))


def _put(tree: dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_resnet18_encoder(state_dict: dict, num_input_images: int = 1) -> dict:
    """torchvision resnet18 (or the reference's ResNetEncoder trunk) -> the
    tree of `ResNetEncoder`'s trunk (conv1 and layers 1-3; the FPN head is
    trained from scratch). A 3-channel conv1 is replicated over
    ``num_input_images`` and divided by it, as the reference does for a
    stacked image pair; a multi-image conv1 is kept."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params: dict = {}
    batch_stats: dict = {}
    w1 = conv_w(sd["conv1.weight"])
    if num_input_images > 1 and w1.shape[2] == 3:
        w1 = np.concatenate([w1] * num_input_images, axis=2) / num_input_images
    _put(params, ("conv1", "kernel"), w1)

    def bn(src, dst):
        _put(params, (*dst, "scale"), sd[f"{src}.weight"])
        _put(params, (*dst, "bias"), sd[f"{src}.bias"])
        _put(batch_stats, (*dst, "mean"), sd[f"{src}.running_mean"])
        _put(batch_stats, (*dst, "var"), sd[f"{src}.running_var"])

    bn("bn1", ("bn1",))
    for li in (1, 2, 3):
        for bi in (0, 1):
            src, dst = f"layer{li}.{bi}", f"layer{li}_block{bi}"
            _put(params, (dst, "conv1", "kernel"), conv_w(sd[f"{src}.conv1.weight"]))
            _put(params, (dst, "conv2", "kernel"), conv_w(sd[f"{src}.conv2.weight"]))
            bn(f"{src}.bn1", (dst, "bn1"))
            bn(f"{src}.bn2", (dst, "bn2"))
            if f"{src}.downsample.0.weight" in sd:
                _put(params, (dst, "downsample_conv", "kernel"),
                     conv_w(sd[f"{src}.downsample.0.weight"]))
                bn(f"{src}.downsample.1", (dst, "downsample_bn"))
    return {"params": params, "batch_stats": batch_stats}


def convert_vgg16_percep(state_dict: dict) -> dict:
    """torchvision vgg16 -> the tree of `PercepNet` (its first three conv
    stages): ``features.{0,2,5,7,10,12,14}`` become ``conv0`` .. ``conv6``."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    return {"params": {f"conv{i}": {"kernel": conv_w(sd[f"features.{idx}.weight"]),
                                    "bias": sd[f"features.{idx}.bias"]}
                       for i, idx in enumerate((0, 2, 5, 7, 10, 12, 14))}}


# Reference module name -> the FPN head's path in an encoder's tree. Stride 8
# only, as in the JAX tool: a stride-4 checkpoint's ``upconv2*`` are not
# carried, so its strict load fails (ROADMAP C).
_DRO_ENCODER_HEADS = {
    "upconv1.0": ("upconv1",),
    "upconv1_fusion.0": ("upconv1_fusion",),
    "out_conv": ("out_conv",),
}


def convert_dro_checkpoint(state_dict: dict) -> dict:
    """A reference DRO checkpoint's state dict (``model.depth_net.`` or
    ``depth_net.`` prefixed) -> the `DepthPoseNet` tree: the three encoders
    with their FPN heads, the depth, pose and mask heads, and the update
    blocks under ``refinement/update_block_{depth,pose}/cell``, the mask
    branch under ``refinement/mask_head``, each GRU's separate ``convz`` and
    ``convr`` stacked z then r as ``convzr``."""
    sd = {k.replace("model.depth_net.", "").replace("depth_net.", ""): np.asarray(v)
          for k, v in state_dict.items()}
    out_params: dict = {}
    out_stats: dict = {}

    def convert_conv(src, dst, bias=True):
        _put(out_params, (*dst, "kernel"), conv_w(sd[f"{src}.weight"]))
        if bias and f"{src}.bias" in sd:
            _put(out_params, (*dst, "bias"), sd[f"{src}.bias"])

    for enc, n_img in (("fnet", 1), ("cnet_depth", 1), ("cnet_pose", 2)):
        sub = {k[len(enc) + 1:]: v for k, v in sd.items() if k.startswith(enc + ".")}
        tree = convert_resnet18_encoder(sub, num_input_images=n_img)
        out_params[enc] = tree["params"]
        out_stats[enc] = tree["batch_stats"]
        for src, dst in _DRO_ENCODER_HEADS.items():
            if f"{enc}.{src}.weight" in sd:
                convert_conv(f"{enc}.{src}", (enc, *dst))

    convert_conv("depth_head.conv1", ("depth_head", "conv1"))
    convert_conv("depth_head.conv2", ("depth_head", "conv2"))
    convert_conv("pose_head.conv1_pose", ("pose_head", "conv1"))
    convert_conv("pose_head.conv2_pose", ("pose_head", "conv2"))
    convert_conv("upmask_net.mask.0", ("upmask_net", "conv1"))
    convert_conv("upmask_net.mask.2", ("upmask_net", "conv2"))

    def update_block(prefix, kind):
        base = ("refinement", f"update_block_{kind}", "cell")
        letter = kind[0]
        enc_map = {"encoder.convc1": "convc1", "encoder.convc2": "convc2",
                   f"encoder.conv{letter}1": f"conv{letter}1",
                   f"encoder.conv{letter}2": f"conv{letter}2",
                   f"encoder.conv{letter}": f"conv{letter}"}
        if kind == "depth":
            convert_conv(f"{prefix}.depth_head.conv1", (*base, "head", "conv1"))
            convert_conv(f"{prefix}.depth_head.conv2", (*base, "head", "conv2"))
            convert_conv(f"{prefix}.mask.0", ("refinement", "mask_head", "mask1"))
            convert_conv(f"{prefix}.mask.2", ("refinement", "mask_head", "mask2"))
        else:
            convert_conv(f"{prefix}.pose_head.conv1_pose", (*base, "head", "conv1"))
            convert_conv(f"{prefix}.pose_head.conv2_pose", (*base, "head", "conv2"))
        for src, dst in enc_map.items():
            convert_conv(f"{prefix}.{src}", (*base, "encoder", dst))
        gru = f"{prefix}.{kind}_gru"
        for sfx in ("1", "2"):
            _put(out_params, (*base, "gru", f"convzr{sfx}", "kernel"), np.concatenate(
                [conv_w(sd[f"{gru}.convz{sfx}.weight"]),
                 conv_w(sd[f"{gru}.convr{sfx}.weight"])], axis=-1))
            _put(out_params, (*base, "gru", f"convzr{sfx}", "bias"), np.concatenate(
                [sd[f"{gru}.convz{sfx}.bias"], sd[f"{gru}.convr{sfx}.bias"]], axis=-1))
            convert_conv(f"{gru}.convq{sfx}", (*base, "gru", f"convq{sfx}"))

    update_block("update_block_depth", "depth")
    update_block("update_block_pose", "pose")
    return {"params": out_params, "batch_stats": out_stats}


# The reference config's paths that set the operating point.
_CARRIED = (("model", "name"),
            ("model", "depth_net", "name"),
            ("model", "depth_net", "version"),
            ("model", "params", "min_depth"),
            ("model", "params", "max_depth"),
            ("model", "params", "crop"),
            ("datasets", "augmentation", "image_shape"))


def framework_config(ref_config) -> Dict[str, Any]:
    """The port's config (as a dict) with the reference config's operating
    point carried over: model name, net name and version, depth range,
    crop and image shape, where the reference sets them."""
    from dro_sfm_torch.utils.config import load_config
    overrides: dict = {}
    for path in _CARRIED:
        node = ref_config or {}
        for p in path:
            node = node.get(p) if isinstance(node, dict) else None
        if node is None:
            continue
        _put(overrides, path, tuple(node) if isinstance(node, (list, tuple)) else node)
    return load_config(overrides=overrides).to_dict()


def emit_framework_ckpt(tree: dict, dst: str, ref_config, epoch: int = 0) -> None:
    """Write ``tree`` as the JAX package's checkpoint, ready for `scripts/eval.py`
    (either package's): flax msgpack of ``{params, batch_stats, opt_state: {},
    step: 0}`` and the ``<dst>.json`` sidecar with the epoch, the step and the
    config of `framework_config`."""
    from dro_sfm_torch.utils.msgpack import packb
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    payload = {"params": tree["params"], "batch_stats": tree.get("batch_stats", {}),
               "opt_state": {}, "step": np.asarray(0)}
    with open(dst, "wb") as f:
        f.write(packb(payload))
    with open(dst + ".json", "w") as f:
        json.dump({"epoch": int(epoch), "step": 0,
                   "config": framework_config(ref_config)}, f)


# -- reading -----------------------------------------------------------------

class ReferenceConfig(dict):
    """A ``yacs.config.CfgNode`` read without yacs: its keys and values as a
    ``dict`` (nested nodes too); yacs's own attributes are dropped."""

    def __setstate__(self, state):
        pass


_TORCH_REBUILDS = {("torch._utils", n) for n in (
    "_rebuild_tensor", "_rebuild_tensor_v2", "_rebuild_tensor_v3", "_rebuild_parameter",
    "_rebuild_parameter_with_state")} | {("torch._tensor", "_rebuild_from_type_v2")}
_ALLOWED = {("builtins", "set"): set, ("builtins", "frozenset"): frozenset,
            ("builtins", "bytearray"): bytearray, ("builtins", "complex"): complex,
            ("builtins", "slice"): slice,
            ("collections", "OrderedDict"): collections.OrderedDict,
            ("collections", "Counter"): collections.Counter,
            ("torch", "Tensor"): torch.Tensor, ("torch", "Size"): torch.Size,
            ("torch", "device"): torch.device,
            ("torch.nn.parameter", "Parameter"): torch.nn.Parameter,
            ("yacs.config", "CfgNode"): ReferenceConfig}


class ReferenceUnpickler(pickle.Unpickler):
    """An unpickler that builds only tensors, their storages, dtypes and
    devices, the builtin containers and the reference's config; any other
    global raises `pickle.UnpicklingError` naming it. (``torch.load``
    resolves the storage classes before this is asked.)"""

    def find_class(self, module: str, name: str):
        # Python 2's names, as protocol 2 writes builtins (``__builtin__``).
        module, name = _compat_pickle.NAME_MAPPING.get((module, name), (module, name))
        module = _compat_pickle.IMPORT_MAPPING.get(module, module)
        if (module, name) in _ALLOWED:
            return _ALLOWED[module, name]
        if module == "_codecs" and name == "encode":     # bytes under protocol 2
            import _codecs
            return _codecs.encode
        if (module, name) in _TORCH_REBUILDS:
            return getattr(__import__(module, fromlist=[name]), name)
        if module == "torch" and isinstance(getattr(torch, name, None), torch.dtype):
            return getattr(torch, name)
        raise pickle.UnpicklingError(
            f"refused global {module}.{name}: a reference checkpoint holds tensors, "
            "builtin containers and its yacs config only")


def _load(file, **kw):
    return ReferenceUnpickler(file, **kw).load()


# What `torch.load(pickle_module=)` reads through.
reference_pickle = types.SimpleNamespace(__name__="dro_sfm_torch.torch_weights",
                                         Unpickler=ReferenceUnpickler, load=_load)


def read_reference_ckpt(path: str) -> Any:
    """The object of a reference ``.ckpt`` (``{"state_dict", "config",
    "epoch", ...}``), its tensors on the CPU and its ``CfgNode`` config
    read as `ReferenceConfig`; raises `pickle.UnpicklingError` on a global
    that is not a tensor's, a dtype's, a device's, a builtin container's or
    ``yacs.config.CfgNode``."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=reference_pickle)


def read_torch_state(path: str) -> Any:
    """The object of a plain ``torch.save`` file (a torchvision state dict),
    read with ``torch.load(weights_only=True)`` on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def state_arrays(raw) -> Dict[str, Any]:
    """The state dict of a loaded file (its ``state_dict`` entry, or the
    file's object itself), tensors as numpy arrays."""
    sd = raw.get("state_dict", raw) if isinstance(raw, dict) else raw
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def reference_config(raw) -> Optional[dict]:
    """The config a reference ``.ckpt`` embeds ({} if none)."""
    return raw.get("config", {}) if isinstance(raw, dict) else {}


def reference_epoch(raw) -> int:
    return int(raw.get("epoch", 0)) if isinstance(raw, dict) else 0


def convert_reference_ckpt(src: str, dst: str) -> dict:
    """A reference ``.ckpt`` -> the eval-ready checkpoint ``dst`` (the config's
    operating point carried over). Returns the converted tree."""
    raw = read_reference_ckpt(src)
    tree = convert_dro_checkpoint(state_arrays(raw))
    emit_framework_ckpt(tree, dst, reference_config(raw), epoch=reference_epoch(raw))
    return tree
