"""The port's MJPEG AVI and GIF files, read by OpenCV and Pillow (CPU).

AVI: ``cv2.VideoCapture`` (its FFmpeg backend) opens the port's file with
the frame count, size and rate written; demuxed raw (``CAP_PROP_FORMAT``
-1) every packet is the port's JPEG stream byte for byte; each decoded
frame equals FFmpeg's decode of the same JPEG as a file, and lies within 3
levels (max abs) of ``cv2.imdecode`` of it where the frame has no chroma
detail (gray and smooth frames). On the rendered scenes FFmpeg's chroma
upsampling is not libjpeg's: there the bar is a PSNR of 30 dB against
``cv2.imdecode`` (measured 33.0 dB; ROADMAP C). `read_avi_mjpeg` gives back
the port's own decode of each stored JPEG. A frame that would take the
RIFF past its limit raises before it is written, and an exception inside
the writer leaves no file.

GIF: Pillow reads ``n_frames``, ``info["duration"]`` and ``info["loop"]`` as
Pillow's own ``save`` writes them; frames of at most 256 colours decode
exactly; rendered frames of more colours (median cut, no dither) within a
PSNR of 30 dB (measured 33.2-33.6 dB), uniform noise within 24 dB
(measured 25.9 dB).
"""
import cv2
import numpy as np
import pytest
from PIL import Image

from dro_sfm_torch.data.synthetic import SyntheticConfig, SyntheticDataset
from dro_sfm_torch.utils import video_io
from dro_sfm_torch.utils.image_io import decode_jpeg, encode_jpeg
from dro_sfm_torch.utils.video_io import AviWriter, median_cut, read_avi_mjpeg, write_gif


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def scenes():
    data = SyntheticDataset(SyntheticConfig(height=60, width=90, num_planes=3))
    planes, _ = data._scene(0)
    frames = []
    for i in range(5):
        T = np.eye(4)
        T[:3, 3] = [0.05 * i, 0, 0.05 * i]
        frames.append((data._render(planes, T)[0] * 255).astype(np.uint8))
    return frames


def smooth_frames():
    ramp = np.linspace(0, 255, 60 * 90 * 3).reshape(60, 90, 3).astype(np.uint8)
    gray = np.repeat(np.linspace(0, 255, 60 * 90).reshape(60, 90, 1).astype(np.uint8), 3, 2)
    return [ramp, gray, ramp[::-1].copy()]


def write_avi(path, frames, fps=10):
    with AviWriter(str(path), fps) as w:
        for f in frames:
            w.write(f)
    return w


@pytest.mark.parametrize("kind", ["scene", "smooth"])
def test_avi_reads_in_opencv(tmp_path, scenes, kind):
    frames = scenes if kind == "scene" else smooth_frames()
    path = tmp_path / "v.avi"
    w = write_avi(path, frames, fps=12.5)
    assert path.stat().st_size == w.bytes_written and not (tmp_path / "v.avi.tmp").exists()
    cap = cv2.VideoCapture(str(path))
    assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == len(frames)
    assert (cap.get(cv2.CAP_PROP_FRAME_WIDTH), cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == (90, 60)
    assert cap.get(cv2.CAP_PROP_FPS) == 12.5
    raw = cv2.VideoCapture(str(path))
    assert raw.set(cv2.CAP_PROP_FORMAT, -1)
    for i, frame in enumerate(frames):
        ok, got = cap.read()
        ok_raw, packet = raw.read()
        assert ok and ok_raw
        jpeg = encode_jpeg(frame)
        assert packet.tobytes() == jpeg
        (tmp_path / "f.jpg").write_bytes(jpeg)
        ok, as_file = cv2.VideoCapture(str(tmp_path / "f.jpg")).read()
        assert ok and np.array_equal(got, as_file)
        want = cv2.imdecode(np.frombuffer(jpeg, np.uint8), cv2.IMREAD_COLOR)
        if kind == "smooth":
            assert np.abs(got.astype(int) - want).max() <= 3
        else:
            assert psnr(got, want) >= 30.0
    assert not cap.read()[0]
    decoded, fps = read_avi_mjpeg(str(path))
    assert fps == 12.5 and len(decoded) == len(frames)
    for got, frame in zip(decoded, frames):
        assert np.array_equal(got, decode_jpeg(encode_jpeg(frame)))


def test_avi_limit_and_abort(tmp_path, scenes, monkeypatch):
    path = tmp_path / "v.avi"
    monkeypatch.setattr(video_io, "AVI_LIMIT", 12000)
    with pytest.raises(ValueError, match="1 GiB"):
        write_avi(path, scenes * 4)
    assert not path.exists() and not (tmp_path / "v.avi.tmp").exists()
    w = AviWriter(str(path), 10)
    w.write(scenes[0])
    with pytest.raises(ValueError, match="1 GiB"):
        for f in scenes * 4:
            w.write(f)
    w.close()                                   # the frames before the limit, a valid file
    assert cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT) == len(w.index)
    assert w.bytes_written <= 12000 + 8 and path.stat().st_size == w.bytes_written
    with pytest.raises(ValueError, match="size"):
        with AviWriter(str(tmp_path / "b.avi"), 10) as bad:
            bad.write(scenes[0])
            bad.write(scenes[0][:30])
    assert not (tmp_path / "b.avi").exists() and not (tmp_path / "b.avi.tmp").exists()


@pytest.mark.parametrize("duration, loop", [(100, 0), (66, 2), (40, 1)])
def test_gif_header_as_pillow_writes_it(tmp_path, duration, loop):
    rng = np.random.default_rng(duration)
    frames = [(rng.integers(0, 4, (30, 40, 3)) * 80).astype(np.uint8) for _ in range(3)]
    write_gif(str(tmp_path / "p.gif"), frames, duration, loop=loop)
    Image.fromarray(frames[0]).save(tmp_path / "pil.gif", save_all=True, loop=loop,
                                    append_images=[Image.fromarray(f) for f in frames[1:]],
                                    duration=duration)
    got, want = Image.open(tmp_path / "p.gif"), Image.open(tmp_path / "pil.gif")
    assert got.n_frames == want.n_frames == 3
    assert got.info["duration"] == want.info["duration"]
    assert got.info["loop"] == want.info["loop"]
    for k, f in enumerate(frames):
        got.seek(k)
        assert np.array_equal(np.asarray(got.convert("RGB")), f)


@pytest.mark.parametrize("colors", [2, 3, 17, 256])
def test_gif_exact_up_to_256_colours(tmp_path, colors):
    rng = np.random.default_rng(colors)
    palette = rng.integers(0, 256, (colors, 3), np.uint8)
    frame = palette[rng.integers(0, colors, (33, 47))]
    frame.reshape(-1, 3)[:colors] = palette           # every colour present
    write_gif(str(tmp_path / "g.gif"), [frame, frame[::-1].copy()])
    im = Image.open(tmp_path / "g.gif")
    for k, f in enumerate([frame, frame[::-1]]):
        im.seek(k)
        assert np.array_equal(np.asarray(im.convert("RGB")), f)


def test_gif_quantized_frames(tmp_path, scenes):
    write_gif(str(tmp_path / "s.gif"), scenes)
    im = Image.open(tmp_path / "s.gif")
    for k, f in enumerate(scenes):
        im.seek(k)
        assert psnr(np.asarray(im.convert("RGB")), f) >= 30.0
    noise = np.random.default_rng(0).integers(0, 256, (64, 96, 3), np.uint8)
    idx, palette = median_cut(noise)
    assert len(palette) == 256 and idx.shape == noise.shape[:2]
    write_gif(str(tmp_path / "n.gif"), [noise])
    assert psnr(np.asarray(Image.open(tmp_path / "n.gif").convert("RGB")), noise) >= 24.0
