"""Export a checkpoint as a serving artifact of `torch.export` programs.

    python -m dro_sfm_torch.scripts.export --checkpoint x.ckpt --output serve/
        [--batch 1] [--views 2] [--image-shape H W] [--platforms cpu cuda]
        [--dynamic-batch] [--skip-check]

The port's counterpart of `scripts/export.py`. The checkpoint is the port's
or the JAX package's (`inference.load_model_and_config`); without a config
(the port's serving file) ``--image-shape`` is required. Writes
``<output>/model.<platform>.pt2`` for each platform and ``meta.json``
(`dro_sfm_torch.export_serving`), then checks each program against the live
network on its device (max |depth delta| and pose matrices within 1e-4)
unless ``--skip-check``. ``--platforms cuda`` needs the card and raises
without one.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="dro_sfm_torch serving export")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--views", type=int, default=2)
    p.add_argument("--image-shape", type=int, nargs=2, default=None)
    p.add_argument("--platforms", nargs="+", default=["cpu", "cuda"],
                   choices=["cpu", "cuda"])
    p.add_argument("--dynamic-batch", action="store_true",
                   help="export with a symbolic batch dimension (one program "
                        "serves any batch size)")
    p.add_argument("--skip-check", action="store_true",
                   help="skip the live-vs-frozen roundtrip check")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI; returns the programs' paths by platform."""
    args = parse_args(argv)
    from dro_sfm_torch.export_serving import export_serving_artifact, serving_roundtrip_check
    from dro_sfm_torch.inference import load_model_and_config
    from dro_sfm_torch.utils.device import resolve_device

    for platform in args.platforms:               # before any loading or writing
        resolve_device(platform)
    net, cfg = load_model_and_config(args.checkpoint, device=args.platforms[0])
    if args.image_shape is None and cfg is None:
        raise ValueError(f"{args.checkpoint} carries no config: pass --image-shape H W")
    shape = tuple(args.image_shape or cfg.datasets.augmentation.image_shape)
    meta = {"checkpoint": os.path.abspath(args.checkpoint), "version": net.version,
            "min_depth": net.min_depth, "max_depth": net.max_depth}
    paths = export_serving_artifact(net, args.output, args.batch, args.views, shape,
                                    platforms=args.platforms,
                                    dynamic_batch=args.dynamic_batch, meta_extra=meta)
    for platform, path in paths.items():
        print(f"exported {path} ({os.path.getsize(path) / 1e6:.1f} MB, {platform})")
    if not args.skip_check:
        for platform in args.platforms:
            err = serving_roundtrip_check(net, args.output, args.batch, args.views, shape,
                                          device=platform)
            print(f"roundtrip check OK on {platform} (max |depth delta| {err:.2e})")
    return paths


if __name__ == "__main__":
    main()
