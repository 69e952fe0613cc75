"""The port's image grid, GIF and video writers against the JAX package (CPU).

`ImageGrid` (panels resized as ``cv2.resize``, labels in OpenCV's font)
equals the JAX grid pixel for pixel; `write_gif` and `write_video` give
files Pillow and OpenCV read back (frame count, size; GIF frames of at
most 256 colours exactly; the video is mp4v at the caller's path, as the
JAX package's, and OpenCV decodes the frames the port's reader decodes); `frames_from_folder` equals the JAX reader on
PNG and JPEG files. `images_to_gif` against the JAX package's (Pillow):
unlabelled, unscaled frames of at most 256 colours decode exactly as the
JAX file's, from paths, arrays, float arrays, a folder and a glob; with
labels every pixel outside the two label boxes (the port's fitted box and
Pillow's ``[4, 4, 10 + 7 n, 22]``) is equal, and the port's box holds its
yellow text on black; with ``scale`` 0.5 the port's bilinear frames lie
within a PSNR of 26 dB of Pillow's bicubic ones (measured 30.6-30.9 dB).
"""
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from dro_sfm_tpu.visualization import gif as jgif
from dro_sfm_tpu.visualization import image_grid as jgrid
from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from dro_sfm_torch.utils.video_io import VideoReader
from dro_sfm_torch.visualization import gif as tgif
from dro_sfm_torch.visualization import image_grid as tgrid


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def frames():
    data = SyntheticDataset(SyntheticConfig(height=48, width=64, num_planes=3))
    planes, _ = data._scene(1)
    out = []
    for i in range(3):
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, 0, 0.04 * i]
        out.append((data._render(planes, T)[0] * 255).astype(np.uint8))
    return out


def few_colours(frames, n=16):
    """The frames with their values cut to ``n`` levels per channel group."""
    return [(f // (256 // 4) * (256 // 4)).astype(np.uint8) for f in frames[:n]]


def gif_frames(path):
    im = Image.open(path)
    out = []
    for k in range(im.n_frames):
        im.seek(k)
        out.append(np.asarray(im.convert("RGB")))
    return out


def test_image_grid_matches_jax(frames):
    jg, tg = jgrid.ImageGrid(2, 2, 40, 56, pad=3), tgrid.ImageGrid(2, 2, 40, 56, pad=3)
    cells = [(0, 0, frames[0], "rgb"), (0, 1, frames[1].astype(np.float32) / 255, None),
             (1, 0, frames[2][..., 0], "gray (e) 0.123"), (1, 1, frames[0][:40, :56], "")]
    for r, c, img, label in cells:
        jg.set_cell(r, c, img, label)
        tg.set_cell(r, c, img, label)
    assert np.array_equal(tg.canvas, jg.canvas)


def test_gif_video_and_folder(tmp_path, frames):
    small = few_colours(frames)
    tgrid.write_gif(str(tmp_path / "t.gif"), small, fps=8)
    jgrid.write_gif(str(tmp_path / "j.gif"), small, fps=8)
    got, want = gif_frames(tmp_path / "t.gif"), gif_frames(tmp_path / "j.gif")
    assert len(got) == len(want) == 3 and all(np.array_equal(a, b) for a, b in zip(got, small))
    assert Image.open(tmp_path / "t.gif").info["duration"] == \
        Image.open(tmp_path / "j.gif").info["duration"]
    tgrid.write_video(str(tmp_path / "t.mp4"), frames, fps=10)
    jgrid.write_video(str(tmp_path / "j.mp4"), frames, fps=10)
    caps = [cv2.VideoCapture(str(tmp_path / n)) for n in ("t.mp4", "j.mp4")]
    props = [(c.get(cv2.CAP_PROP_FRAME_COUNT), c.get(cv2.CAP_PROP_FRAME_WIDTH),
              c.get(cv2.CAP_PROP_FRAME_HEIGHT), c.get(cv2.CAP_PROP_FPS),
              int(c.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little")) for c in caps]
    assert props[0] == props[1] == (3, 64, 48, 10.0, b"FMP4")       # MPEG-4 Part 2
    decoded = [caps[0].read()[1][..., ::-1] for _ in range(3)]
    assert all(np.array_equal(a, b) for a, b in
               zip(decoded, VideoReader(str(tmp_path / "t.mp4"))))
    (tmp_path / "f").mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(tmp_path / "f" / f"{i}.png"), f[..., ::-1])
        cv2.imwrite(str(tmp_path / "f" / f"{i}b.jpg"), f[..., ::-1])
    got, want = tgrid.frames_from_folder(str(tmp_path / "f")), \
        jgrid.frames_from_folder(str(tmp_path / "f"))
    assert len(got) == len(want) == 6 and all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("source", ["paths", "arrays", "floats", "folder", "glob"])
def test_images_to_gif_unlabelled_exact(tmp_path, frames, source):
    small = few_colours(frames)
    (tmp_path / "in").mkdir()
    paths = []
    for i, f in enumerate(small):
        paths.append(str(tmp_path / "in" / f"{i:03d}.png"))
        cv2.imwrite(paths[-1], f[..., ::-1])
    src = {"paths": paths, "arrays": small, "floats": [f.astype(np.float32) / 255 for f in small],
           "folder": str(tmp_path / "in"), "glob": str(tmp_path / "in" / "*.png")}[source]
    n_t = tgif.images_to_gif(src, str(tmp_path / "o" / "t.gif"), fps=5)
    n_j = jgif.images_to_gif(src, str(tmp_path / "o" / "j.gif"), fps=5)
    assert n_t == n_j == 3
    got, want = gif_frames(tmp_path / "o" / "t.gif"), gif_frames(tmp_path / "o" / "j.gif")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(np.array_equal(a, b) for a, b in zip(got, small))


def test_images_to_gif_labels_and_scale(tmp_path, frames):
    small = few_colours(frames)
    labels = ["frame 0", "", "(c) depth"]
    tgif.images_to_gif(small, str(tmp_path / "t.gif"), labels=labels)
    jgif.images_to_gif(small, str(tmp_path / "j.gif"), labels=labels)
    got, want = gif_frames(tmp_path / "t.gif"), gif_frames(tmp_path / "j.gif")
    for a, b, label in zip(got, want, labels):
        (tw, _), _ = tgif.get_text_size(label, tgif.LABEL_SCALE)
        outside = np.ones(a.shape[:2], bool)
        if label:
            outside[4:23, 4:max(10 + tw, 11 + 7 * len(label))] = False
            box = a[4:23, 4:10 + tw]
            assert (box == 0).all(-1).any() and (box[..., 0] > 128).any()
        assert np.array_equal(a[outside], b[outside])
    tgif.images_to_gif(frames, str(tmp_path / "ts.gif"), scale=0.5)
    jgif.images_to_gif(frames, str(tmp_path / "js.gif"), scale=0.5)
    for a, b in zip(gif_frames(tmp_path / "ts.gif"), gif_frames(tmp_path / "js.gif")):
        assert a.shape == b.shape == (24, 32, 3)
        assert psnr(a, b) >= 26.0
    with pytest.raises(ValueError, match="no frames"):
        tgif.images_to_gif(str(tmp_path / "missing"), str(tmp_path / "x.gif"))
    assert not os.path.exists(tmp_path / "x.gif")
