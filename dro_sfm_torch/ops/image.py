"""Image resizes, gradients, flips and the SSIM pool on channel-last tensors.

PyTorch counterpart of `dro_sfm_tpu/ops/image.py`. Under a height split
(`parallel/spatial.py`) the operators that read rows beyond a band fetch
them: `gradient_y` the first row of the band below (the last band gives one
difference fewer, as the whole image gives H - 1), the SSIM pool one row
each side (`reflect_rows`: reflected at the image's edges), and the
decoder's nearest x2 (`upsample_nearest2`) the row above where a band at
the finer stride starts on an odd row.
"""
from __future__ import annotations

import torch

from dro_sfm_torch.ops.resample import bilinear_sample
from dro_sfm_torch.parallel import spatial


def resize_bilinear(image: torch.Tensor, shape,
                    align_corners: bool = True) -> torch.Tensor:
    """Resize [..., H, W, C] to [..., shape[0], shape[1], C] bilinearly.

    ``align_corners=True`` spans the corner pixels; ``align_corners=False``
    uses half-pixel centres clamped into the image, the rule of
    ``F.interpolate(..., align_corners=False)`` that the encoder uses.
    """
    ho, wo = int(shape[0]), int(shape[1])
    h, w = image.shape[-3], image.shape[-2]
    if (h, w) == (ho, wo):
        return image
    if not align_corners:
        return resize_bilinear_rows(image, 0, h, (ho, wo), (0, ho))
    kw = {"dtype": torch.float32, "device": image.device}
    xs = torch.linspace(0.0, w - 1.0, wo, **kw)
    ys = torch.linspace(0.0, h - 1.0, ho, **kw)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).expand(*image.shape[:-3], ho, wo, 2)
    return bilinear_sample(image, grid)


def resize_bilinear_rows(image: torch.Tensor, src_row0: int, src_rows: int, shape,
                         rows) -> torch.Tensor:
    """Rows ``[rows[0], rows[1])`` of ``resize_bilinear(full, shape,
    align_corners=False)``, where ``image`` [..., h, W, C] holds the rows
    ``[src_row0, src_row0 + h)`` of ``full``, a source of ``src_rows`` rows
    (rows of ``image`` outside the source are never weighted). The taps and
    weights are those of the whole resize: a band of a height split
    (`models/encoder.py`)."""
    ho, wo = int(shape[0]), int(shape[1])
    w = image.shape[-2]
    kw = {"dtype": torch.float32, "device": image.device}
    xs = ((torch.arange(wo, **kw) + 0.5) * (w / wo) - 0.5).clamp(0.0, w - 1.0)
    ys = ((torch.arange(rows[0], rows[1], **kw) + 0.5) * (src_rows / ho) - 0.5).clamp(
        0.0, src_rows - 1.0) - src_row0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).expand(*image.shape[:-3], len(ys), wo, 2)
    return bilinear_sample(image, grid)


def resize_nearest(image: torch.Tensor, shape) -> torch.Tensor:
    """Nearest-neighbour resize of [..., H, W, C] with the index rule of
    ``F.interpolate(mode="nearest")``: src = floor(dst * size_in / size_out)."""
    ho, wo = int(shape[0]), int(shape[1])
    h, w = image.shape[-3], image.shape[-2]
    if (h, w) == (ho, wo):
        return image
    kw = {"dtype": torch.float32, "device": image.device}
    ys = torch.floor(torch.arange(ho, **kw) * (h / ho)).long()
    xs = torch.floor(torch.arange(wo, **kw) * (w / wo)).long()
    return image.index_select(-3, ys).index_select(-2, xs)


def upsample_nearest2(image: torch.Tensor) -> torch.Tensor:
    """``resize_nearest(image, (2H, 2W))`` of [..., H, W, C]; under a
    height split the band's rows at half the stride of ``image``'s, which
    read the row above the band where that band starts on an odd row (the
    last band's rows end at the image's rows at that stride)."""
    band = spatial.current()
    h, w = image.shape[-3], image.shape[-2]
    if band is None:
        return resize_nearest(image, (2 * h, 2 * w))
    s = band.stride_of(h)
    first = {band.rows(s, j): band.rows(s // 2, j)[0] // 2 for j in range(band.shards)}
    ext = spatial.fetch_rows(image, -3, lambda r0, r1: (first[(r0, r1)], r1))
    o0, o1 = band.rows(s // 2)
    ys = torch.arange(o0, o1, device=image.device) // 2 - first[band.rows(s)]
    xs = torch.arange(2 * w, device=image.device) // 2
    return ext.index_select(-3, ys).index_select(-2, xs)


def gradient_x(image: torch.Tensor) -> torch.Tensor:
    """Horizontal forward difference [..., H, W-1, C]."""
    return image[..., :, :-1, :] - image[..., :, 1:, :]


def gradient_y(image: torch.Tensor) -> torch.Tensor:
    """Vertical forward difference [..., H-1, W, C]; under a height split
    the band's differences, with the first row of the band below (the last
    band's one fewer)."""
    band = spatial.current()
    if band is not None:
        n = band.global_rows(band.stride_of(image.shape[-3]))
        image = spatial.fetch_rows(image, -3, lambda r0, r1: (r0, min(r1 + 1, n)))
    return image[..., :-1, :, :] - image[..., 1:, :, :]


def _reflect_pad1(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Pad one element on each side of ``dim`` by reflection (the edge
    element is not repeated), as ``jnp.pad(mode="reflect")`` does."""
    n = x.shape[dim]
    return torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 2, 1)], dim=dim)


def reflect_rows(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] with one row each side reflected; under a height split
    the band with its neighbours' rows (`spatial.reflect_halo`)."""
    if spatial.current() is None:
        return _reflect_pad1(x, -3)
    return spatial.reflect_halo(x, -3)


def avg_pool_3x3_rows(xp: torch.Tensor) -> torch.Tensor:
    """The 3x3 mean filter of [..., H + 2, W, C] rows already widened by
    one each side (`reflect_rows`), reflection-padded across: [..., H, W, C].
    The nine taps are summed in row-major order, the order of the JAX
    package's window sum, so the two agree bit for bit in fp32."""
    h, w = xp.shape[-3] - 2, xp.shape[-2]
    xp = _reflect_pad1(xp, -2)
    total = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[..., dy:dy + h, dx:dx + w, :]
            total = tap if total is None else total + tap
    return total / 9.0


def avg_pool_3x3_reflect(x: torch.Tensor) -> torch.Tensor:
    """3x3 mean filter with reflection padding, stride 1, on [..., H, W, C]
    of any rank: the SSIM building block (`avg_pool_3x3_rows`)."""
    return avg_pool_3x3_rows(reflect_rows(x))


def flip_lr(image: torch.Tensor) -> torch.Tensor:
    """Horizontal flip of [..., H, W, C]."""
    return torch.flip(image, dims=(-2,))


def flip_intrinsics(K: torch.Tensor, width: int) -> torch.Tensor:
    """Intrinsics [..., 3, 3] of a horizontally flipped image of ``width``:
    fx -> -fx, cx -> width - cx."""
    K = K.clone()
    K[..., 0, 0] = -K[..., 0, 0]
    K[..., 0, 2] = width - K[..., 0, 2]
    return K
