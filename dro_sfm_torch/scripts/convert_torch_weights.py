"""Convert upstream torch weights into the trees the port (and the JAX
package) read.

    python -m dro_sfm_torch.scripts.convert_torch_weights resnet18 resnet18.pth out.msgpack
    python -m dro_sfm_torch.scripts.convert_torch_weights vgg16 vgg16.pth out.msgpack
    python -m dro_sfm_torch.scripts.convert_torch_weights dro-ckpt indoor_scannet.ckpt out.msgpack
    # an eval-ready checkpoint, the reference config's operating point carried:
    python -m dro_sfm_torch.scripts.convert_torch_weights dro-ckpt indoor_scannet.ckpt out.ckpt
    # then: python -m dro_sfm_torch.scripts.eval --checkpoint out.ckpt

The kinds and arguments of `tools/convert_torch_weights.py`, without flax or
yacs (`dro_sfm_torch/torch_weights.py`). ``resnet18`` and ``vgg16`` read a
plain state dict (``torch.load(weights_only=True)``); ``dro-ckpt`` reads the
reference's ``.ckpt`` through the restricted unpickler. A ``.msgpack`` tree is
what ``model.pretrained_encoders`` and ``model.loss.percep_pretrained`` name.
After writing, the output is loaded where the port uses it, on ``--device``
(the card by default): the ``.ckpt`` by `inference.load_model`, a DRO tree
strictly into `DepthPoseNet` of the reference config's version, a ResNet-18
trunk by the trainer's warm start, a VGG16 tree strictly into `PercepNet`.
"""
from __future__ import annotations

import argparse

KINDS = ("resnet18", "vgg16", "dro-ckpt")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="torch weights -> the port's trees")
    p.add_argument("kind", choices=KINDS)
    p.add_argument("src", help="torch state dict (.pth) or reference checkpoint (.ckpt)")
    p.add_argument("dst", help=".msgpack tree, or .ckpt (dro-ckpt: eval-ready)")
    p.add_argument("--device", default=None,
                   help="torch device of the load check (default: the CUDA card)")
    return p.parse_args(argv)


def load_check(kind: str, dst: str, version: str, device) -> str:
    """Load ``dst`` where the port uses it, on ``device``; returns what took it."""
    import torch

    from dro_sfm_torch.convert import from_jax_variables
    from dro_sfm_torch.models.depth_pose_net import DepthPoseNet
    from dro_sfm_torch.training.init_weights import load_msgpack_tree, warm_start
    if kind == "dro-ckpt" and dst.endswith(".ckpt"):
        from dro_sfm_torch.inference import load_model
        return f"load_model: DepthPoseNet {load_model(dst, device=device).version}"
    if kind == "vgg16":
        from dro_sfm_torch.models.percep import PercepNet
        PercepNet(device=device).load_state_dict(
            from_jax_variables(load_msgpack_tree(dst)), strict=True)
        return "PercepNet, strictly"
    net = DepthPoseNet(version=version, device=device,
                       generator=torch.Generator().manual_seed(0))
    if kind == "resnet18":
        warm_start(net, pretrained_encoders=dst, verbose=False)
        return f"the warm start of DepthPoseNet {version}'s three encoders"
    net.load_state_dict(from_jax_variables(load_msgpack_tree(dst)), strict=True)
    return f"DepthPoseNet {version}, strictly"


def main(argv=None) -> dict:
    args = parse_args(argv)
    from dro_sfm_torch import torch_weights as tw
    from dro_sfm_torch.utils.device import resolve_device
    from dro_sfm_torch.utils.msgpack import packb
    device = resolve_device(args.device)
    raw = (tw.read_reference_ckpt if args.kind == "dro-ckpt" else tw.read_torch_state)(
        args.src)
    state_dict = tw.state_arrays(raw)
    if args.kind == "resnet18":
        tree = tw.convert_resnet18_encoder(state_dict)
    elif args.kind == "vgg16":
        tree = tw.convert_vgg16_percep(state_dict)
    else:
        tree = tw.convert_dro_checkpoint(state_dict)
    ref_cfg = tw.reference_config(raw)
    if args.kind == "dro-ckpt" and args.dst.endswith(".ckpt"):
        tw.emit_framework_ckpt(tree, args.dst, ref_cfg, epoch=tw.reference_epoch(raw))
    else:
        with open(args.dst, "wb") as f:
            f.write(packb(tree))
    print(f"wrote {args.dst}")
    version = ((ref_cfg.get("model") or {}).get("depth_net") or {}).get("version")
    took = load_check(args.kind, args.dst, version or "it12-h-out", device)
    print(f"load check on {device}: {took}")
    return tree


if __name__ == "__main__":
    main()
