"""The port's model-zoo pipeline (`scripts/eval_reference_ckpt.py`) against
the JAX tool's `tools/eval_reference_ckpt.py:convert` plus the JAX
`Trainer.test` (CPU, fp32).

The input is a reference-format ``.ckpt`` of seed-0 `fill_variables` under
the reference's names (the inverse map of `tests/_torch_reference_ckpt.py`;
no upstream model code), with the operating point of
`tests/test_eval_reference_ckpt.py` (``it4-h-out-seq2``, 48x64, depth 0.2 to
20) and its fabricated ScanNet scene. The JAX tool reads the fixture with a
plain-dict config (its ``torch.load`` cannot read a ``CfgNode`` without
yacs); the port reads the same checkpoint with its config pickled as
``yacs.config.CfgNode``.

Both tools evaluate at the config default, ``mixed_precision: True``. So
the comparison runs twice:
- fp32: both with ``mixed_precision: False``, the JAX `Trainer` with
  ``warp_impl: gather`` (off the TPU its ``"pallas"`` is the matmul sampler
  with bf16 weights, not an fp32 reference, ROADMAP C). Every metric within
  1e-4 relative (1e-7 absolute near zero): the same weights and frames
  through fp32 forwards whose sums run in another order.
- the default, bf16: each tool as a user runs it. Every metric within 5e-2
  relative plus 1e-3 (the bf16 bar of the CPU tests): the two packages
  round at other points, the JAX sampler's tent weights in bf16 among
  them, and a1-a3 count pixels that cross their thresholds.
"""
import json
import os

import numpy as np
import pytest
import torch

from dro_sfm_tpu.training.trainer import Trainer as JaxTrainer
from dro_sfm_tpu.utils.config import ConfigNode as JaxConfigNode
from dro_sfm_tpu.utils.config import prepare_config as jax_prepare_config
from dro_sfm_torch.scripts import eval_reference_ckpt as port_tool
from tests._torch_reference_ckpt import reference_state_dict, write_reference_ckpt
from tests.test_eval_reference_ckpt import _write_scene
from tests.test_torch_convert_weights import CONFIG, dro_variables  # noqa: F401
from tools import eval_reference_ckpt as jax_tool

torch.set_num_threads(4)
ARGS = ["--dataset", "Scannet", "--split", "split.txt", "--batch-size", "1"]


BARS = {"fp32": (1e-4, 1e-7), "bf16": (5e-2, 1e-3)}


def jax_metrics(ref_ckpt, out_ckpt, root, fp32):
    """The JAX tool's pipeline: its `convert`, then `Trainer.test` at the
    checkpoint's operating point on the command line's dataset (in fp32
    with the fp32 sampler when ``fp32``)."""
    jax_tool.convert(ref_ckpt, out_ckpt)
    args = jax_tool.parse_args([ref_ckpt, "--path", str(root), *ARGS])
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
    if fp32:
        cfg_dict["model"]["depth_net"].update(mixed_precision=False, warp_impl="gather")
    cfg = jax_prepare_config(JaxConfigNode(cfg_dict))
    return {k: float(v) for k, v in JaxTrainer(cfg, resume=out_ckpt).test().items()}


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_pipeline_matches_jax(tmp_path, monkeypatch, dro_variables, capsys,  # noqa: F811
                              precision):
    monkeypatch.chdir(tmp_path)
    if precision == "fp32":
        eval_config = port_tool.eval_config

        def fp32_config(*args):
            cfg = eval_config(*args)
            cfg.model.depth_net.mixed_precision = False
            return cfg

        monkeypatch.setattr(port_tool, "eval_config", fp32_config)
    sd = reference_state_dict(dro_variables)
    plain = str(tmp_path / "plain" / "indoor_scannet.ckpt")
    yacs = str(tmp_path / "indoor_scannet.ckpt")
    os.makedirs(os.path.dirname(plain))
    write_reference_ckpt(plain, sd, CONFIG, epoch=3, yacs=False)
    write_reference_ckpt(yacs, sd, CONFIG, epoch=3, yacs=True)
    root = tmp_path / "scans"
    _write_scene(root)

    want = jax_metrics(plain, str(tmp_path / "jax.ckpt"), root, precision == "fp32")
    got = port_tool.main([yacs, "--path", str(root), *ARGS, "--device", "cpu"])
    out = capsys.readouterr().out

    assert os.path.exists(str(tmp_path / "indoor_scannet.converted.ckpt"))
    assert json.loads(out.strip().splitlines()[-1]) == got
    assert "README" in out and "delta (pp_gt)" in out
    metrics = got["metrics"]
    assert set(metrics) == set(want)
    rel, floor = BARS[precision]
    for k, v in want.items():
        assert np.isfinite(metrics[k]), k
        assert abs(metrics[k] - v) <= rel * abs(v) + floor, (k, metrics[k], v)
    # the README row by file name, and the differences in the pp_gt mode
    assert got["readme_row"] == port_tool.README_TABLE["indoor_scannet.ckpt"]
    assert got["readme_row"] == jax_tool.README_TABLE["indoor_scannet.ckpt"]
    assert set(got["delta"]) == {k for k, v in got["readme_row"].items() if v is not None}
    assert abs(got["delta"]["abs_rel"] - (metrics["abs_rel_pp_gt"] - 0.053)) < 1e-12


def test_readme_table_is_the_tools():
    assert port_tool.README_TABLE == jax_tool.README_TABLE
