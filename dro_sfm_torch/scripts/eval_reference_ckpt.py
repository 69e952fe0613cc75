"""One command from a reference checkpoint to its metric table.

    python -m dro_sfm_torch.scripts.eval_reference_ckpt outdoor_kitti.ckpt \
        --dataset KITTI --path /data/kitti --split splits/eigen_test.txt \
        --depth-type velodyne [--device cpu]

The counterpart of `tools/eval_reference_ckpt.py`, without flax or yacs:
the reference ``.ckpt`` is converted (`torch_weights.convert_reference_ckpt`)
into an eval-ready checkpoint with the reference config's operating point
(network version, depth range, crop, image shape), which the port's
`Trainer` evaluates on the test dataset named here, on the card unless
``--device`` names another. The four metric modes are printed beside the
README model-zoo row of the checkpoint's file name, then one JSON line of
the metrics, the row and their differences.
"""
from __future__ import annotations

import argparse
import json
import os

# README model-zoo rows, keyed by the published checkpoint's file name;
# None: not reported.
README_TABLE = {
    "outdoor_kitti.ckpt": {
        "abs_rel": 0.045, "sq_rel": 0.193, "rmse": 2.570, "rmse_log": 0.080,
        "a1": 0.971, "a2": 0.994, "a3": 0.998, "SILog": 0.079,
        "l1_inv": 0.003, "rot_ang": None, "t_ang": None, "t_cm": None},
    "outdoor_kitti_selfsup.ckpt": {
        "abs_rel": 0.053, "sq_rel": 0.346, "rmse": 3.037, "rmse_log": 0.102,
        "a1": 0.962, "a2": 0.990, "a3": 0.996, "SILog": 0.101,
        "l1_inv": 0.004, "rot_ang": None, "t_ang": None, "t_cm": None},
    "indoor_scannet.ckpt": {
        "abs_rel": 0.053, "sq_rel": 0.017, "rmse": 0.165, "rmse_log": 0.080,
        "a1": 0.967, "a2": 0.994, "a3": 0.998, "SILog": 0.078,
        "l1_inv": 0.033, "rot_ang": 0.472, "t_ang": 9.297, "t_cm": 1.160},
    "indoor_scannet_view5.ckpt": {
        "abs_rel": 0.047, "sq_rel": 0.014, "rmse": 0.151, "rmse_log": 0.072,
        "a1": 0.976, "a2": 0.996, "a3": 0.999, "SILog": 0.071,
        "l1_inv": 0.030, "rot_ang": 0.456, "t_ang": 8.502, "t_cm": 1.163},
    "indoor_scannet_selfsup.ckpt": {
        "abs_rel": 0.143, "sq_rel": 0.345, "rmse": 0.656, "rmse_log": 0.274,
        "a1": 0.896, "a2": 0.954, "a3": 0.969, "SILog": 0.272,
        "l1_inv": 0.106, "rot_ang": 0.609, "t_ang": 10.779, "t_cm": 1.393},
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="reference checkpoint -> converted eval -> README side-by-side")
    p.add_argument("checkpoint", help="reference torch .ckpt")
    p.add_argument("--dataset", required=True,
                   help="eval dataset registry name (KITTI, ScannetTest, ...)")
    p.add_argument("--path", required=True, help="dataset root directory")
    p.add_argument("--split", required=True, help="split file")
    p.add_argument("--depth-type", default="groundtruth")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--back-context", type=int, default=1)
    p.add_argument("--forward-context", type=int, default=1)
    p.add_argument("--out", default=None,
                   help="where to write the converted checkpoint (default: beside "
                        "the input)")
    p.add_argument("--expect", default=None,
                   help="README row to compare against (default: the checkpoint's "
                        "file name)")
    p.add_argument("--mode", default="pp_gt", choices=["raw", "pp", "gt", "pp_gt"],
                   help="metric mode of the comparison row (the README's numbers are "
                        "post-processed and scaled by the ground truth's median)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p.parse_args(argv)


def print_comparison(metrics: dict, readme_row, mode: str) -> dict:
    """The four metric modes beside the README row and, with a row, the
    differences in ``mode``; returns the differences."""
    from dro_sfm_torch.training.metrics import ALL_METRIC_NAMES
    suffix = "" if mode == "raw" else f"_{mode}"
    header = ["METRIC"] + list(ALL_METRIC_NAMES)
    widths = [max(10, len(h) + 2) for h in header]

    def fmt_row(label, values):
        cells = [f"{label:<{widths[0]}}"]
        for v, w in zip(values, widths[1:]):
            cells.append(f"{'-' if v is None else f'{v:.3f}':>{w}}")
        return "| " + " | ".join(cells) + " |"

    rule = "|" + "-" * (sum(widths) + 3 * len(widths) + 1) + "|"
    print(rule)
    print("| " + " | ".join(f"{h:>{w}}" if i else f"{h:<{w}}"
                            for i, (h, w) in enumerate(zip(header, widths))) + " |")
    for m in ("", "_pp", "_gt", "_pp_gt"):
        print(fmt_row("depth" + m, [metrics.get(f"{k}{m}") for k in ALL_METRIC_NAMES]))
    delta = {}
    if readme_row:
        print(fmt_row("README", [readme_row.get(k) for k in ALL_METRIC_NAMES]))
        ours = {k: metrics.get(f"{k}{suffix}") for k in ALL_METRIC_NAMES}
        delta = {k: ours[k] - readme_row[k] for k in ALL_METRIC_NAMES
                 if readme_row.get(k) is not None and ours[k] is not None}
        print(fmt_row(f"delta ({mode})", [delta.get(k) for k in ALL_METRIC_NAMES]))
    print(rule)
    return delta


def eval_config(out_ckpt: str, args):
    """The converted checkpoint's config, its test and validation sections
    on the dataset of the command line, no training dataset."""
    from dro_sfm_torch.utils.config import ConfigNode, prepare_config
    with open(out_ckpt + ".json") as f:
        cfg_dict = json.load(f)["config"]
    for section in ("test", "validation"):
        cfg_dict["datasets"][section] = {
            **cfg_dict["datasets"].get(section, {}),
            "dataset": [args.dataset], "path": [args.path], "split": [args.split],
            "depth_type": [args.depth_type], "batch_size": args.batch_size,
            "back_context": args.back_context, "forward_context": args.forward_context}
    cfg_dict["datasets"]["train"]["dataset"] = []
    cfg_dict["prepared"] = False
    return prepare_config(ConfigNode(cfg_dict))


def main(argv=None) -> dict:
    args = parse_args(argv)
    from dro_sfm_torch.torch_weights import convert_reference_ckpt
    from dro_sfm_torch.training.trainer import Trainer
    out_ckpt = args.out or os.path.splitext(args.checkpoint)[0] + ".converted.ckpt"
    convert_reference_ckpt(args.checkpoint, out_ckpt)
    print(f"converted -> {out_ckpt}")
    metrics = Trainer(eval_config(out_ckpt, args), resume=out_ckpt,
                      device=args.device).test()
    key = args.expect or os.path.basename(args.checkpoint)
    readme_row = README_TABLE.get(key)
    if readme_row is None:
        print(f"(no README model-zoo row named {key!r}; known: {sorted(README_TABLE)})")
    delta = print_comparison(metrics, readme_row, args.mode)
    result = {"metrics": {k: float(v) for k, v in metrics.items()},
              "readme_row": readme_row, "delta": delta}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
