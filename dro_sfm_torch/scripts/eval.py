"""Evaluation CLI of the port: load a checkpoint and its config, evaluate.

    python -m dro_sfm_torch.scripts.eval --checkpoint x.ckpt [--config y.yaml] [--half]
    python -m dro_sfm_torch.scripts.eval --checkpoint x.ckpt --device cpu

Runs the test datasets when the config has them (writing the ``.npz`` depth
files that ``save.depth`` asks for), else the validation datasets, on the
card unless ``--device cpu``. ``--half`` runs the network in bf16 (fp32
geometry). The metrics are printed as a table and as JSON.
"""
from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="dro_sfm_torch evaluation")
    parser.add_argument("--checkpoint", required=True, help=".ckpt file")
    parser.add_argument("--config", default=None,
                        help="a .yaml config to use in place of the checkpoint's")
    parser.add_argument("--half", action="store_true",
                        help="bf16 network, fp32 geometry")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from dro_sfm_torch.scripts.train import config_of
    from dro_sfm_torch.training.trainer import Trainer
    cfg = config_of(args.config or args.checkpoint)
    if args.half:
        cfg.model.depth_net.mixed_precision = True
    trainer = Trainer(cfg, resume=args.checkpoint, device=args.device)
    if trainer.test_datasets is not None:
        metrics = trainer.test(save_artifacts=True)
    else:
        metrics = trainer.validate()
    metrics = {k: float(v) for k, v in metrics.items()}
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
