"""Import hygiene of the PyTorch port: it never reaches JAX, the JAX package
or the JAX package's tools.

Every ``.py`` under ``dro_sfm_torch/`` and ``chip_smoke.py`` is parsed and
its imports checked; importing the package in a fresh interpreter must leave
``jax`` out of ``sys.modules``. Of ``tools/`` only the port's own
``tools/torch_*.py`` may be imported. The card's machine has none of PyYAML,
OpenCV, Pillow, matplotlib, msgpack, h5py, imageio, yacs or torchvision, so
no module of the port imports them (it reads flax's msgpack, PNG, JPEG and
BMP files and the reference's yacs-pickled checkpoints itself), and
``wandb`` is imported only inside ``loggers.py:WandbLogger``.
The trainer, the CLIs (the launcher and the depth-map metrics among them),
the process group and collectives (`parallel/`), the dataset readers, the
inference applications, bundle adjustment (`ba/`) and its benchmark
``tools/torch_bench_ba.py`` import none of them, nor do the depth images,
the drawing, the image and video files, the demo video, the renderer and the
``vis`` and ``ingest_capture`` scripts, the torch-weight converters
(``torch_weights.py``, the ``convert_torch_weights`` and
``eval_reference_ckpt`` scripts) and the offline dataset tools
(``generate_splits``, ``export_gt_pointcloud``, ``pose_stats``,
``preview_dataset``, ``debug_depth``). Among the port's tools, only the
generators of committed data (``tools/torch_make_colormap.py``,
``tools/torch_make_font.py`` and ``tools/torch_make_jpeg_fixtures.py``)
import OpenCV, matplotlib or Pillow, and none of them imports JAX.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dro_sfm_tpu", "tools")
ABSENT_ON_THE_CARD = ("yaml", "cv2", "PIL", "matplotlib", "msgpack", "h5py", "imageio",
                      "yacs", "torchvision")
FILES = sorted((ROOT / "dro_sfm_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                         ROOT / "tools" / "torch_bench_ba.py"]


def forbidden(name: str) -> bool:
    """A module of JAX or of the JAX package, or a JAX tool: any module of
    ``tools`` but the port's own ``tools.torch_*``."""
    parts = name.split(".")
    if parts[0] == "tools":
        return len(parts) > 1 and not parts[1].startswith("torch_")
    return parts[0] in FORBIDDEN


def imported_modules(path: Path):
    """Every module ``path`` imports; ``from a import b`` gives ``a`` and
    ``a.b``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
            yield from (f"{node.module}.{a.name}" for a in node.names)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in imported_modules(path) if forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_names_the_jax_tools():
    assert forbidden("tools.convert_torch_weights") and forbidden("flax.serialization")
    assert not forbidden("tools.torch_bench_ba") and not forbidden("torch")


def test_package_import_leaves_jax_out():
    code = ("import sys, pkgutil, importlib, dro_sfm_torch\n"
            "for m in pkgutil.walk_packages(dro_sfm_torch.__path__, 'dro_sfm_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
            "assert not bad, bad\n" % (FORBIDDEN,))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_imports_absent_on_the_card(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in ABSENT_ON_THE_CARD]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_wandb_only_inside_wandb_logger():
    users = [p for p in FILES if any(m.split(".")[0] == "wandb" for m in imported_modules(p))]
    assert users == [ROOT / "dro_sfm_torch" / "loggers.py"]
    tree = ast.parse(users[0].read_text())
    (cls,) = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "WandbLogger"]
    inside = {id(n) for n in ast.walk(cls)}
    imports = [n for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
               and any(a.name.split(".")[0] == "wandb" for a in n.names)
               or isinstance(n, ast.ImportFrom) and (n.module or "").startswith("wandb")]
    assert imports and all(id(n) in inside for n in imports)


def test_parallel_and_new_scripts_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"dro_sfm_torch/parallel/__init__.py", "dro_sfm_torch/parallel/mesh.py",
            "dro_sfm_torch/parallel/collectives.py",
            "dro_sfm_torch/scripts/launch_multihost.py",
            "dro_sfm_torch/scripts/evaluate_depth_maps.py"} <= names


def test_ba_modules_and_their_benchmark_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"dro_sfm_torch/ba/__init__.py", "dro_sfm_torch/ba/lie.py",
            "dro_sfm_torch/ba/pose_graph.py", "dro_sfm_torch/ba/dense_ba.py",
            "dro_sfm_torch/ba/precision.py", "dro_sfm_torch/geometry/rotations.py",
            "dro_sfm_torch/geometry/pose.py", "dro_sfm_torch/geometry/camera.py",
            "tools/torch_bench_ba.py"} <= names


def test_demo_modules_and_scripts_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"dro_sfm_torch/utils/colormap.py", "dro_sfm_torch/utils/video_io.py",
            "dro_sfm_torch/utils/save.py", "dro_sfm_torch/loggers.py",
            "dro_sfm_torch/visualization/draw.py", "dro_sfm_torch/visualization/image_grid.py",
            "dro_sfm_torch/visualization/gif.py", "dro_sfm_torch/visualization/demo_video.py",
            "dro_sfm_torch/visualization/trajectory.py", "dro_sfm_torch/visualization/splat.py",
            "dro_sfm_torch/visualization/pointcloud.py", "dro_sfm_torch/data/depth_filter.py",
            "dro_sfm_torch/scripts/vis.py", "dro_sfm_torch/scripts/ingest_capture.py"} <= names


def test_weight_converters_and_dataset_tools_are_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"dro_sfm_torch/torch_weights.py",
            "dro_sfm_torch/scripts/convert_torch_weights.py",
            "dro_sfm_torch/scripts/eval_reference_ckpt.py",
            "dro_sfm_torch/scripts/generate_splits.py",
            "dro_sfm_torch/scripts/export_gt_pointcloud.py",
            "dro_sfm_torch/scripts/pose_stats.py",
            "dro_sfm_torch/scripts/preview_dataset.py",
            "dro_sfm_torch/scripts/debug_depth.py"} <= names


def test_only_the_generators_import_opencv_matplotlib_pillow():
    tools = sorted((ROOT / "tools").glob("torch_*.py"))
    users = {p.name for p in tools
             if any(m.split(".")[0] in ("cv2", "matplotlib", "PIL") for m in imported_modules(p))}
    assert users == {"torch_make_colormap.py", "torch_make_font.py",
                     "torch_make_jpeg_fixtures.py"}
    for p in tools:
        assert not [m for m in imported_modules(p) if forbidden(m)], p.name


def test_trainer_import_leaves_out_jax_yaml_cv2():
    code = ("import sys, dro_sfm_torch.training.trainer, dro_sfm_torch.scripts.train, "
            "dro_sfm_torch.scripts.eval, dro_sfm_torch.scripts.infer, "
            "dro_sfm_torch.scripts.infer_pose, dro_sfm_torch.scripts.infer_video, "
            "dro_sfm_torch.scripts.frames, dro_sfm_torch.inference, "
            "dro_sfm_torch.training.init_weights, dro_sfm_torch.utils.image_io, "
            "dro_sfm_torch.data.kitti, dro_sfm_torch.data.dgp, "
            "dro_sfm_torch.visualization.demo_video, dro_sfm_torch.parallel.mesh, "
            "dro_sfm_torch.parallel.collectives, dro_sfm_torch.scripts.launch_multihost, "
            "dro_sfm_torch.scripts.evaluate_depth_maps, dro_sfm_torch.ba, "
            "dro_sfm_torch.ba.dense_ba, dro_sfm_torch.geometry.rotations, "
            "dro_sfm_torch.utils.colormap, dro_sfm_torch.utils.video_io, "
            "dro_sfm_torch.visualization.draw, dro_sfm_torch.visualization.image_grid, "
            "dro_sfm_torch.visualization.gif, dro_sfm_torch.visualization.splat, "
            "dro_sfm_torch.scripts.vis, dro_sfm_torch.scripts.ingest_capture, "
            "dro_sfm_torch.data.depth_filter, tools.torch_bench_ba, "
            "dro_sfm_torch.torch_weights, dro_sfm_torch.scripts.convert_torch_weights, "
            "dro_sfm_torch.scripts.eval_reference_ckpt, dro_sfm_torch.scripts.generate_splits, "
            "dro_sfm_torch.scripts.export_gt_pointcloud, dro_sfm_torch.scripts.pose_stats, "
            "dro_sfm_torch.scripts.preview_dataset, dro_sfm_torch.scripts.debug_depth\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in %r\n"
            "       or m.startswith('tools.') and not m.startswith('tools.torch_')]\n"
            "assert not bad, bad\n" % (tuple(m for m in FORBIDDEN if m != "tools")
                                        + ABSENT_ON_THE_CARD + ("wandb",),))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
