"""The port's folder-against-folder depth metrics CLI against the JAX
package's (`scripts/evaluate_depth_maps.py`), on the CPU.

Folders of ``.npz`` depth maps and of uint16 ``.png`` maps (``depth * 256``,
written by OpenCV, as the JAX package writes them), each CLI with the same
flags: the printed lines are equal (names, and values to their 4 printed
decimals), and the port's mean vector lies within 1e-5 relative of the
values the JAX CLI computes (``compute_depth_metrics`` fp32, each pair's
metrics summed in fp64).
"""
import contextlib
import importlib.util
import io
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from dro_sfm_torch.scripts import evaluate_depth_maps as port_cli

ROOT = Path(__file__).resolve().parents[1]
H, W = 60, 80


def jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_depth_maps", ROOT / "scripts" / "evaluate_depth_maps.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_maps(folder, ext, depths):
    folder.mkdir()
    for i, d in enumerate(depths):
        path = str(folder / f"{i:03d}{ext}")
        if ext == ".npz":
            np.savez_compressed(path, depth=d)
        else:
            cv2.imwrite(path, (d * 256.0).astype(np.uint16))


@pytest.fixture(scope="module", params=[".npz", ".png"])
def folders(request, tmp_path_factory):
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.5, 70.0, size=(4, H, W)).astype(np.float32)
    gt[:, :5] = 0.0                                    # invalid rows
    pred = (gt * rng.uniform(0.7, 1.3, size=gt.shape) + 0.3).astype(np.float32)
    root = tmp_path_factory.mktemp(request.param[1:])
    write_maps(root / "pred", request.param, pred)
    write_maps(root / "gt", request.param, gt)
    return root


def run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return out.getvalue(), result


@pytest.mark.parametrize("flags", [
    [], ["--use-gt-scale"], ["--crop", "garg", "--min-depth", "1.0", "--max-depth", "50"],
    ["--crop", "eigen_nyu", "--use-gt-scale"],
], ids=["plain", "gt_scale", "garg", "eigen_nyu"])
def test_prints_the_jax_clis_vector(folders, flags, monkeypatch):
    import dro_sfm_tpu.utils.misc as misc
    monkeypatch.setattr(misc, "enable_compilation_cache", lambda: None)
    module = jax_cli()
    argv = ["--pred", str(folders / "pred"), "--gt", str(folders / "gt"), *flags]
    monkeypatch.setattr(sys, "argv", ["evaluate_depth_maps.py", *argv])
    want, _ = run(lambda _: module.main(), None)
    got, vector = run(port_cli.main, [*argv, "--device", "cpu"])
    assert got == want
    values = [float(line.split(":")[1]) for line in want.splitlines()]
    assert len(values) == 9
    np.testing.assert_allclose(vector, values, rtol=0, atol=5e-5 + 1e-12)
    # The JAX CLI's own sums, unrounded: its metrics and load_depth on each pair.
    from dro_sfm_tpu.training.metrics import MetricsConfig, compute_depth_metrics
    from dro_sfm_tpu.utils.depth import load_depth
    args = module.parse_args()
    cfg = MetricsConfig(crop=args.crop, min_depth=args.min_depth, max_depth=args.max_depth)
    names = sorted(p.name for p in (folders / "gt").iterdir())
    total = np.zeros(9)
    for name in names:
        gt, pred = (load_depth(str(folders / d / name))[None, ..., None] for d in ("gt", "pred"))
        total += np.asarray(compute_depth_metrics(gt, pred, cfg,
                                                  use_gt_scale=args.use_gt_scale))
    np.testing.assert_allclose(vector, total / len(names), rtol=1e-5)


def test_refuses_unpaired_folders(tmp_path):
    write_maps(tmp_path / "pred", ".npz", [np.ones((4, 4), np.float32)] * 2)
    write_maps(tmp_path / "gt", ".npz", [np.ones((4, 4), np.float32)])
    with pytest.raises(SystemExit, match="2 pred vs 1 gt files"):
        port_cli.main(["--pred", str(tmp_path / "pred"), "--gt", str(tmp_path / "gt"),
                       "--device", "cpu"])
