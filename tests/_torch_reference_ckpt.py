"""Reference-format checkpoints for the port's weight tests, with no
download and no yacs.

`reference_state_dict` inverts `convert_dro_checkpoint`: a `DepthPoseNet`
variables tree (numpy) under the reference's module names, prefixed
``model.depth_net.``, with the ``num_batches_tracked`` counters torch keeps.
`write_reference_ckpt` saves ``{"state_dict", "config", "epoch"}`` as the
reference does, its config pickled as ``yacs.config.CfgNode`` (a stand-in
class registered under that name while the file is written, and removed
again, so yacs stays unimportable when the file is read) or as a plain
dict. `write_foreign_ckpt` pickles a global no reference checkpoint holds.
"""
import collections
import contextlib
import sys
import types

import numpy as np
import torch

ENCODERS = ("fnet", "cnet_depth", "cnet_pose")


def _oihw(kernel):
    return np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1)))


def reference_state_dict(variables, prefix="model.depth_net."):
    params, stats = variables["params"], variables["batch_stats"]
    out = {}

    def conv(dst, node):
        out[f"{dst}.weight"] = _oihw(node["kernel"])
        if "bias" in node:
            out[f"{dst}.bias"] = np.asarray(node["bias"])

    def bn(dst, p, s):
        out[f"{dst}.weight"] = np.asarray(p["scale"])
        out[f"{dst}.bias"] = np.asarray(p["bias"])
        out[f"{dst}.running_mean"] = np.asarray(s["mean"])
        out[f"{dst}.running_var"] = np.asarray(s["var"])
        out[f"{dst}.num_batches_tracked"] = np.asarray(0)

    for enc in ENCODERS:
        p, s = params[enc], stats[enc]
        conv(f"{enc}.conv1", p["conv1"])
        bn(f"{enc}.bn1", p["bn1"], s["bn1"])
        for li in (1, 2, 3):
            for bi in (0, 1):
                blk, src = f"layer{li}_block{bi}", f"{enc}.layer{li}.{bi}"
                conv(f"{src}.conv1", p[blk]["conv1"])
                conv(f"{src}.conv2", p[blk]["conv2"])
                bn(f"{src}.bn1", p[blk]["bn1"], s[blk]["bn1"])
                bn(f"{src}.bn2", p[blk]["bn2"], s[blk]["bn2"])
                if "downsample_conv" in p[blk]:
                    conv(f"{src}.downsample.0", p[blk]["downsample_conv"])
                    bn(f"{src}.downsample.1", p[blk]["downsample_bn"],
                       s[blk]["downsample_bn"])
        for head in ("upconv1", "upconv1_fusion", "upconv2", "upconv2_fusion"):
            if head in p:
                conv(f"{enc}.{head}.0", p[head])
        conv(f"{enc}.out_conv", p["out_conv"])
    conv("depth_head.conv1", params["depth_head"]["conv1"])
    conv("depth_head.conv2", params["depth_head"]["conv2"])
    conv("pose_head.conv1_pose", params["pose_head"]["conv1"])
    conv("pose_head.conv2_pose", params["pose_head"]["conv2"])
    conv("upmask_net.mask.0", params["upmask_net"]["conv1"])
    conv("upmask_net.mask.2", params["upmask_net"]["conv2"])
    ref = params["refinement"]
    for kind in ("depth", "pose"):
        block = f"update_block_{kind}"
        cell = ref[block]["cell"]
        for name, node in cell["encoder"].items():
            conv(f"{block}.encoder.{name}", node)
        if kind == "depth":
            conv(f"{block}.depth_head.conv1", cell["head"]["conv1"])
            conv(f"{block}.depth_head.conv2", cell["head"]["conv2"])
            conv(f"{block}.mask.0", ref["mask_head"]["mask1"])
            conv(f"{block}.mask.2", ref["mask_head"]["mask2"])
        else:
            conv(f"{block}.pose_head.conv1_pose", cell["head"]["conv1"])
            conv(f"{block}.pose_head.conv2_pose", cell["head"]["conv2"])
        gru = cell["gru"]
        for sfx in ("1", "2"):
            zr = gru[f"convzr{sfx}"]
            d = zr["kernel"].shape[-1] // 2
            for gate, part in (("z", slice(0, d)), ("r", slice(d, 2 * d))):
                conv(f"{block}.{kind}_gru.conv{gate}{sfx}",
                     {"kernel": np.asarray(zr["kernel"])[..., part],
                      "bias": np.asarray(zr["bias"])[part]})
            conv(f"{block}.{kind}_gru.convq{sfx}", gru[f"convq{sfx}"])
    return {prefix + k: v for k, v in out.items()}


@contextlib.contextmanager
def _registered(modules):
    """``modules`` (name -> module) importable for the body only."""
    saved = {k: sys.modules.get(k) for k in modules}
    sys.modules.update(modules)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _yacs_class():
    class CfgNode(dict):
        """yacs's node as pickled: a dict whose instance holds yacs's four
        bookkeeping attributes (a set among them)."""

        def __init__(self, init_dict=None):
            super().__init__({k: CfgNode(v) if isinstance(v, dict) else v
                              for k, v in (init_dict or {}).items()})
            self.__dict__["__immutable__"] = False
            self.__dict__["__deprecated_keys__"] = set()
            self.__dict__["__renamed_keys__"] = {}
            self.__dict__["__new_allowed__"] = False

    CfgNode.__module__, CfgNode.__qualname__ = "yacs.config", "CfgNode"
    return CfgNode


def write_reference_ckpt(path, state_dict, config, epoch=0, yacs=True):
    """``{"state_dict", "config", "epoch"}`` as the reference's
    ``torch.save`` writes it; tensors from ``state_dict``'s arrays."""
    sd = {k: torch.from_numpy(np.array(v)) for k, v in state_dict.items()}
    if not yacs:
        torch.save({"state_dict": sd, "config": config, "epoch": epoch}, path)
        return
    cfg_node = _yacs_class()
    pkg, mod = types.ModuleType("yacs"), types.ModuleType("yacs.config")
    mod.CfgNode, pkg.config = cfg_node, mod
    with _registered({"yacs": pkg, "yacs.config": mod}):
        torch.save({"state_dict": sd, "config": cfg_node(config), "epoch": epoch}, path)


def write_foreign_ckpt(path):
    """A checkpoint whose top level is an OrderedDict subclass of a module
    no reference checkpoint names."""
    mod = types.ModuleType("foreign.payload")

    class Payload(collections.OrderedDict):
        pass

    Payload.__module__, Payload.__qualname__ = "foreign.payload", "Payload"
    mod.Payload = Payload
    with _registered({"foreign": types.ModuleType("foreign"), "foreign.payload": mod}):
        torch.save(Payload(state_dict={"w": torch.zeros(2)}), path)
