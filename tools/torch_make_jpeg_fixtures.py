#!/usr/bin/env python3
"""Write the JPEG fixtures of the port's codec and dataset checks.

    python3 tools/torch_make_jpeg_fixtures.py      # needs OpenCV

Renders the four views of scene 0 of the port's synthetic renderer at
480x640 (``SyntheticConfig(height=480, width=640, num_planes=3,
num_context=3)``) and writes them with OpenCV under
``dro_sfm_torch/testdata/jpeg/``: ``view{i}.jpg`` at quality 95 and 4:2:0,
``view0_444.jpg`` at 4:4:4 and ``view1_gray.jpg`` in grayscale. Beside them
goes ``fixtures.json``: for each file the sha256 of ``cv2.imread(path,
IMREAD_COLOR)[..., ::-1]`` (RGB, C order), its shape and its view, and the
renderer's settings, so that a machine without OpenCV (``chip_smoke.py``
phase ``datasets``) can hold the port's decoder to OpenCV's bytes and
re-render each view's depth and pose.
"""
import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset  # noqa: E402

OUT = ROOT / "dro_sfm_torch" / "testdata" / "jpeg"
RENDER = {"height": 480, "width": 640, "num_planes": 3, "num_context": 3, "seed": 0}
SCENE = 0


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    data = SyntheticDataset(SyntheticConfig(**RENDER))
    planes, poses = data._scene(SCENE)
    views = [(data._render(planes, pose)[0] * 255).astype(np.uint8) for pose in poses]
    q95 = [cv2.IMWRITE_JPEG_QUALITY, 95]
    files = {f"view{i}.jpg": (i, views[i][..., ::-1],
                              q95 + [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420])
             for i in range(len(views))}
    files["view0_444.jpg"] = (0, views[0][..., ::-1], q95 + [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    files["view1_gray.jpg"] = (1, cv2.cvtColor(views[1], cv2.COLOR_RGB2GRAY), q95)
    table = {}
    for name, (view, img, params) in files.items():
        path = OUT / name
        if not cv2.imwrite(str(path), img, params):
            raise RuntimeError(f"cv2.imwrite failed for {path}")
        rgb = np.ascontiguousarray(cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])
        table[name] = {"view": view, "shape": list(rgb.shape),
                       "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    meta = {"render": RENDER, "scene": SCENE, "opencv": cv2.__version__, "files": table}
    (OUT / "fixtures.json").write_text(json.dumps(meta, indent=1) + "\n")
    size = sum((OUT / n).stat().st_size for n in table)
    print(f"wrote {len(table)} JPEG files ({size / 1024:.0f} KiB) and fixtures.json to {OUT}")


if __name__ == "__main__":
    main()
