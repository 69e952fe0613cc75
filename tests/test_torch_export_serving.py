"""The port's serving export (`dro_sfm_torch.export_serving`) on the CPU.

One network (``it2-h-out-seq2``: one outer iteration of 2 depth and 2 pose
steps, 32x48, N=2, fp32) takes the JAX package's weights (`fill_variables`,
carried by `convert.from_jax_variables`) and is exported once with a fixed
batch of 1 and once with a symbolic batch. The loaded programs must give the
live `make_infer_fn(device="cpu")`'s depth and poses within 1e-4, and the
JAX package's `build_serving_fn` on the same weights within its serving
bars (depth 1e-4 relative: depth is 1 / inverse depth; poses 1e-5). The
graph holds the kernel operators ``dro_sfm::warp_diff`` (one a refinement
step) and no gather warp; with ``sep_conv="pallas"`` also
``dro_sfm::gru_sep1d_pass`` (two a step). A fresh interpreter loads and runs
the artifact with `dro_sfm_torch.ops` and without `dro_sfm_torch.models`.
`torch.library.opcheck` holds both operators' schema, fake implementation
and registered autograd. The CLI exports for the CPU, and for the card
raises here.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dro_sfm_tpu.export_serving import build_serving_fn as jax_build_serving_fn
from dro_sfm_tpu.models.depth_pose_net import DepthPoseNet as JaxNet
from dro_sfm_torch import export_serving as es
from dro_sfm_torch.convert import from_jax_variables
from dro_sfm_torch.inference import make_infer_fn, save_model
from dro_sfm_torch.models.depth_pose_net import DepthPoseNet, VersionSpec
from dro_sfm_torch.scripts import export as export_cli
from tests.test_torch_modules import fill_variables

ROOT = Path(__file__).resolve().parents[1]
VERSION, VIEWS, SHAPE = "it2-h-out-seq2", 2, (32, 48)
STEPS = VersionSpec.parse(VERSION).total_iters * 2          # depth + pose steps


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The net on the JAX weights and its static artifact."""
    tmp = tmp_path_factory.mktemp("export")
    inputs = [x.numpy() for x in es.example_inputs(1, VIEWS, SHAPE, "cpu")]
    jnet = JaxNet(version=VERSION, warp_impl="gather", sep_conv="split")
    variables = fill_variables(lambda k: jnet.init(k, *map(jnp.asarray, inputs),
                                                   train=False))
    net = DepthPoseNet(version=VERSION, device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    static = es.export_serving_artifact(net, str(tmp / "static"), 1, VIEWS, SHAPE,
                                        platforms=("cpu",))
    return {"jnet": jnet, "variables": variables, "net": net, "tmp": tmp,
            "static": static["cpu"]}


@pytest.fixture(scope="module")
def dynamic_dir(exported):
    out = exported["tmp"] / "dynamic"
    es.export_serving_artifact(exported["net"], str(out), 1, VIEWS, SHAPE,
                               platforms=("cpu",), dynamic_batch=True)
    return str(out)


def test_artifact_matches_live_and_jax(exported):
    net = exported["net"]
    err = es.serving_roundtrip_check(net, str(Path(exported["static"]).parent), 1, VIEWS,
                                     SHAPE, atol=1e-4, device="cpu")
    assert err <= 1e-4
    inputs = es.example_inputs(1, VIEWS, SHAPE, "cpu")
    depth, mats = es.load_serving_artifact(exported["static"], "cpu").call(*inputs)
    assert depth.shape == (1, *SHAPE) and mats.shape == (1, VIEWS, 4, 4)
    depth_ref, mats_ref = jax.jit(jax_build_serving_fn(exported["jnet"], exported["variables"]))(
        *(jnp.asarray(x.numpy()) for x in inputs))
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_ref), rtol=1e-4, atol=0)
    np.testing.assert_allclose(mats.numpy(), np.asarray(mats_ref), atol=1e-5, rtol=0)
    meta = json.loads((Path(exported["static"]).parent / es.META).read_text())
    assert meta["signature"]["target"] == [1, *SHAPE, 3] and meta["platforms"] == ["cpu"]
    assert meta["bytes"] == Path(exported["static"]).stat().st_size
    assert meta["dynamic_batch"] is False


def test_graph_holds_the_kernel_operators(exported):
    """One warp_diff node a refinement step and no gather warp: the gather
    warp's export holds four index_select nodes a step more."""
    program = torch.export.load(exported["static"])
    assert es.kernel_nodes(program) == {"K1": STEPS, "K5": 0}
    net = exported["net"]
    gather = DepthPoseNet(version=VERSION, warp_impl="gather", device="cpu")
    gather.load_state_dict(net.state_dict())
    plain = es.export_program(gather, 1, VIEWS, SHAPE, "cpu")
    assert es.kernel_nodes(plain) == {"K1": 0, "K5": 0}

    def index_selects(p):
        return sum(str(n.target) == "aten.index_select.default" for n in p.graph.nodes)

    assert index_selects(plain) - index_selects(program) == 4 * STEPS


def test_fused_gru_graph(exported):
    net = exported["net"]
    fused = DepthPoseNet(version=VERSION, sep_conv="pallas", device="cpu")
    fused.load_state_dict(net.state_dict())
    program = es.export_program(fused, 1, VIEWS, SHAPE, "cpu")
    assert es.kernel_nodes(program) == {"K1": STEPS, "K5": 2 * STEPS}
    inputs = es.example_inputs(1, VIEWS, SHAPE, "cpu")
    with torch.inference_mode():
        frozen = program.module()(*inputs)
    live = make_infer_fn(fused, device="cpu")(*inputs)
    for a, b in zip(frozen, live):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.parametrize("batch", [1, 3])
def test_dynamic_batch(exported, dynamic_dir, batch):
    directory = dynamic_dir
    assert json.loads((Path(directory) / es.META).read_text())["signature"]["target"][0] == "b"
    assert es.serving_roundtrip_check(exported["net"], directory, batch, VIEWS, SHAPE,
                                      device="cpu") <= 1e-4


def test_loads_without_the_model_code(exported):
    """A fresh interpreter loads and runs the program with the operators'
    registrations only: no `dro_sfm_torch.models`, config or data."""
    inputs = es.example_inputs(1, VIEWS, SHAPE, "cpu")
    want = es.load_serving_artifact(exported["static"], "cpu").call(*inputs)
    np.save(exported["tmp"] / "want.npy", want[0].numpy())
    code = (
        "import sys, numpy as np\n"
        "from dro_sfm_torch.export_serving import example_inputs, load_serving_artifact\n"
        f"art = load_serving_artifact({exported['static']!r}, 'cpu')\n"
        f"depth, mats = art.call(*example_inputs(1, {VIEWS}, {SHAPE}, 'cpu'))\n"
        f"want = np.load({str(exported['tmp'] / 'want.npy')!r})\n"
        "assert np.abs(depth.numpy() - want).max() <= 1e-5\n"
        "bad = [m for m in sys.modules if m.startswith(('dro_sfm_torch.models',\n"
        "       'dro_sfm_torch.utils.config', 'dro_sfm_torch.data', 'dro_sfm_torch.training',\n"
        "       'dro_sfm_torch.inference', 'jax', 'dro_sfm_tpu'))]\n"
        "assert not bad, bad\n"
        "assert 'dro_sfm_torch.ops.tent_warp' in sys.modules\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_opcheck_warp_diff():
    g = torch.Generator().manual_seed(0)
    b, n, h, w, c = 2, 2, 4, 5, 8
    f1 = torch.randn(b, h * w, c, generator=g, requires_grad=True)
    features = torch.randn(b * n, h, w, c, generator=g, requires_grad=True)
    coords = (torch.rand(b * n, h * w, 2, generator=g) * torch.tensor([w + 1.0, h + 1.0])
              - 1.0).requires_grad_(True)
    torch.library.opcheck(torch.ops.dro_sfm.warp_diff.default, (f1, features, coords, n))


@pytest.mark.parametrize("axis", [1, 2])
def test_opcheck_gru_sep1d_pass(axis):
    g = torch.Generator().manual_seed(axis)
    d, cx = 4, 3

    def leaf(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).requires_grad_(True)

    args = (leaf(2, 3, 4, d), leaf(2, 3, 4, cx), leaf(5, d + cx, 2 * d, scale=0.1),
            leaf(2 * d), leaf(5, d + cx, d, scale=0.1), leaf(d), axis)
    torch.library.opcheck(torch.ops.dro_sfm.gru_sep1d_pass.default, args)


def test_export_cli(exported, tmp_path):
    ckpt = tmp_path / "net.pt"
    save_model(exported["net"], str(ckpt))
    out = tmp_path / "serve"
    paths = export_cli.main(["--checkpoint", str(ckpt), "--output", str(out),
                             "--image-shape", *map(str, SHAPE), "--platforms", "cpu"])
    assert list(paths) == ["cpu"] and Path(paths["cpu"]).is_file()
    meta = json.loads((out / es.META).read_text())
    assert meta["version"] == VERSION and meta["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="image-shape"):
        export_cli.main(["--checkpoint", str(ckpt), "--output", str(tmp_path / "x"),
                         "--platforms", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            export_cli.main(["--checkpoint", str(ckpt), "--output", str(tmp_path / "c"),
                             "--image-shape", *map(str, SHAPE), "--platforms", "cpu",
                             "cuda"])
        assert not (tmp_path / "c").exists()
