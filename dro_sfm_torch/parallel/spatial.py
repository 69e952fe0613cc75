"""Row bands: the height split of ``arch.spatial_shards`` > 1.

The JAX package shards image heights over its mesh's ``spatial`` axis and
lets GSPMD turn every convolution into a halo-exchanged one and every norm or
loss reduction into a sum over the axis (`dro_sfm_tpu/parallel/mesh.py`). The
port makes those exchanges itself, one process a device: the S ranks of a
spatial group (`parallel/mesh.py:Layout`) each hold one band of rows of the
same samples. A `Band` says which rows: the image's ``height`` rows split in
S equal bands at full resolution, and at every stride s of the network the
band ``[ceil(r0 / s), ceil(r1 / s))``, which is the output band of a
stride-2 layer (7x7 pad 3, 3x3 pad 1, 1x1 pad 0, the 3x3 max-pool pad 1) fed
the band at s / 2. So the bands need not be equal below stride 8: 80 rows at
S = 2 give 5 + 5 rows at stride 8 and 3 + 2 at stride 16.

The nets carry no layout. The training and evaluation steps make the band
`active` around their forward and backward (a module-level setting, read by
the autograd threads too); each operator that reads rows beyond its own asks
`current()` and, with no band, runs as it does in one process, bit for bit.
An operator finds the stride of its input from the input's height
(`Band.stride_of`), at the strides 1 to ``deepest`` of the band's net (16:
`DepthPoseNet`'s encoder; 32: the ResNet-18 pyramid of the single-frame
nets). With H/8 divisible by S, every band holds a row and a distinct number
of rows at each of those strides exactly when H >= deepest * S (k = H / 8S
>= deepest / 8: 8k, 4k, 2k, k rows at strides 1 to 8, then about k/2 and
k/4), which `Band` enforces. An operator whose rows are not a band's at any
stride (H - 1 rows after a vertical difference) passes its stride or its row
count and never guesses. Each (band, stride, rows needed) has one fetch
plan, made on its first call and kept (`_fetch_plan`); a fetch copies its
rows as contiguous runs, with no index tensor and no host synchronisation.

The exchanges, differentiable, on the band's group:
- `fetch_rows`: the rows ``[a, b)`` an operator needs beyond its band, from
  the ranks that own them, with ``fill`` outside the image; its backward
  returns the fetched rows' gradient to their owners, which add it
  (`halo`, `conv_rows`, and `reflect_halo`, whose rows beyond the image are
  the reflection that the edge band holds itself);
- `gather_rows`: the whole height; its backward sums the gradient over the
  group and keeps the own band;
- `spatial_sum`: the sum over the group (`image_mean`: the pose heads' and
  the smoothness's means over the image); its gradient is the sum of the
  ranks' gradients, since every rank's value feeds every rank's band;
- `band_mean`: a loss's mean over pixels from the band's share (the band's
  sum over the image's pixel count), summed over the group; its gradient on
  each rank is the share's own, so that the ranks' gradients sum to the
  whole image's (`parallel/collectives.py:average_gradients` sums them over
  the spatial ranks); `whole_term` is the same rule for a term that every
  rank computes whole (the perceptual distance on gathered images): its
  value, with 1/S of its gradient on each rank.

Each is an ``all_reduce`` of sums, the one collective that gloo runs on CUDA
tensors as well as NCCL does: `fetch_rows` and `gather_rows` reduce a
zero-filled buffer that each rank fills with the rows it owns, so their
results are exact in any dtype. Halos are a few rows and the gathered maps
are at stride 8 (or 3-channel images). Each runs inside a
`torch.profiler.record_function` span ``collective:<function>``.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dro_sfm_torch.parallel.collectives import _span, all_reduce_sum
from dro_sfm_torch.parallel.mesh import Layout

STRIDES = (1, 2, 4, 8, 16, 32)
# The height dimension of each image-like batch key ([B,H,W,C] or
# [B,N,H,W,C]), as the JAX package's `mesh.py:_SPATIAL_H_DIM`; every other
# key (intrinsics, poses, ...) stays whole on every spatial rank.
SPATIAL_H_DIM = {"rgb": 1, "rgb_original": 1, "depth": 1,
                 "rgb_context": 2, "rgb_context_original": 2}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class Band:
    """Rank ``index``'s band of an image of ``height`` rows split over the
    ``shards`` ranks of ``group`` (None: the default group), for a net whose
    maps go down to stride ``deepest`` (16 or 32)."""

    def __init__(self, height: int, shards: int, index: int, group=None,
                 deepest: int = 16):
        height, shards, index, deepest = int(height), int(shards), int(index), int(deepest)
        if deepest not in (16, 32):
            raise ValueError(f"deepest stride {deepest}: 16 or 32")
        if height % 8 or (height // 8) % shards:
            raise ValueError(f"image height {height}: H/8 must divide by "
                             f"arch.spatial_shards={shards}")
        if height < deepest * shards:
            raise ValueError(
                f"image height {height} over arch.spatial_shards={shards}: a band needs at "
                f"least {deepest // 8} rows at stride 8 (H >= {deepest} S), or some band "
                f"would hold no row, or two strides' maps the same number of rows, down to "
                f"stride {deepest}")
        self.height, self.shards, self.index, self.group = height, shards, index, group
        self.strides = tuple(s for s in STRIDES if s <= deepest)

    def rows(self, stride: int, index: Optional[int] = None) -> Tuple[int, int]:
        """Band ``index``'s (default this rank's) global rows [r0, r1) at
        ``stride``."""
        i = self.index if index is None else index
        per = self.height // self.shards
        return _ceil_div(i * per, stride), _ceil_div((i + 1) * per, stride)

    def global_rows(self, stride: int) -> int:
        """The image's rows at ``stride``."""
        return _ceil_div(self.height, stride)

    def stride_of(self, local_rows: int) -> int:
        """The stride at which this rank's band holds ``local_rows`` rows."""
        for s in self.strides:
            r0, r1 = self.rows(s)
            if r1 - r0 == local_rows:
                return s
        raise ValueError(f"no stride of band {self.index} of {self.height} rows over "
                         f"{self.shards} holds {local_rows} rows")


def band_for(layout: Optional[Layout], local_height: int,
             deepest: int = 16) -> Optional[Band]:
    """The band of this rank for a batch whose images hold ``local_height``
    rows here, and a net down to stride ``deepest`` (None without a
    split)."""
    if layout is None:
        return None
    return Band(local_height * layout.spatial, layout.spatial, layout.spatial_index,
                layout.spatial_group, deepest)


def split_rows(batch: Dict, layout: Optional[Layout], keys=tuple(SPATIAL_H_DIM)) -> Dict:
    """This rank's rows of the image ``keys`` of ``batch`` (numpy arrays or
    tensors, heights at `SPATIAL_H_DIM`), every other key whole; the batch
    itself without a split."""
    if layout is None:
        return batch
    out = dict(batch)
    for k in keys:
        dim = SPATIAL_H_DIM[k]
        if k in batch and getattr(batch[k], "ndim", 0) > dim:
            band = Band(batch[k].shape[dim], layout.spatial, layout.spatial_index)
            r0, r1 = band.rows(1)
            index = [slice(None)] * batch[k].ndim
            index[dim] = slice(r0, r1)
            out[k] = batch[k][tuple(index)]
    return out


_ACTIVE: Dict[str, Optional[Band]] = {"band": None}


@contextlib.contextmanager
def active(band: Optional[Band]):
    """Run the body (a forward and its backward) on ``band``'s rows; None
    leaves the operators as they are in one process."""
    prev = _ACTIVE["band"]
    _ACTIVE["band"] = band
    try:
        yield band
    finally:
        _ACTIVE["band"] = prev


def current() -> Optional[Band]:
    """The active band, or None."""
    return _ACTIVE["band"]


def row_offset(local_rows: int) -> int:
    """The global index of the first of ``local_rows`` rows (0 without a
    band): the y of a band's pixel grid starts there."""
    band = current()
    return 0 if band is None else band.rows(band.stride_of(local_rows))[0]


def image_rows(local_rows: int) -> int:
    """The image's rows at the stride of ``local_rows`` rows
    (``local_rows`` itself without a band)."""
    band = current()
    return local_rows if band is None else band.global_rows(band.stride_of(local_rows))


def _narrow(x: torch.Tensor, dim: int, start: int, stop: int) -> torch.Tensor:
    return x.narrow(dim, start, max(0, stop - start))


class _FetchPlan:
    """Which rows every band of a group needs beyond its own at one stride,
    in one buffer: for band j, its rows [a_j, b_j) inside the image and
    outside [r0_j, r1_j), above then below, bands in order. Every rank makes
    the same buffer. ``runs`` are this rank's share of it: (slot, local
    row, rows) of each contiguous run of slots it owns."""

    def __init__(self, bands: Tuple[Tuple[int, int], ...], index: int, n: int,
                 needs: Tuple[Tuple[int, int], ...]):
        slot_rows = []
        for j, ((r0, r1), (a, b)) in enumerate(zip(bands, needs)):
            above = list(range(max(a, 0), min(r0, b, n)))
            below = list(range(max(r1, a, 0), min(b, n)))
            if j == index:
                self.start, self.n_above, self.n_below = len(slot_rows), len(above), len(below)
            slot_rows += above + below
        self.slots = len(slot_rows)
        (r0, r1), (a, b) = bands[index], needs[index]
        runs = []
        for pos, row in enumerate(slot_rows):
            if r0 <= row < r1:
                last = runs[-1] if runs else None
                if last and (last[0] + last[2], last[1] + last[2]) == (pos, row - r0):
                    last[2] += 1
                else:
                    runs.append([pos, row - r0, 1])
        self.runs = tuple(tuple(r) for r in runs)
        # This rank's output: rows above the image, its own rows kept
        # [lo, hi) local, rows below the image.
        self.fill_above = max(0, min(b, 0) - a)
        self.fill_below = max(0, b - max(a, n))
        self.lo, self.hi = max(a, r0) - r0, min(b, r1) - r0


@functools.lru_cache(maxsize=None)
def _fetch_plan(height: int, shards: int, index: int, stride: int,
                needs: Tuple[Tuple[int, int], ...]) -> _FetchPlan:
    band = Band(height, shards, index)
    return _FetchPlan(tuple(band.rows(stride, j) for j in range(shards)), index,
                      band.global_rows(stride), needs)


def _buffer_like(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """Zeros shaped as ``x`` with ``rows`` along ``dim``: channel-last
    where ``x`` is an NCHW view whose channels are innermost (a one-channel
    map too, and a band's rows sliced from a whole batch, whose batch stride
    is the whole image's), so that a convolution on the fetched rows picks
    the layout, and the algorithm, that it picks on the band; else
    contiguous (NCCL reduces either). On NCHW buffers cuDNN took a workspace
    larger than the rest of a rank's memory for the single-frame decoder's
    convolutions."""
    shape = list(x.shape)
    shape[dim] = rows
    if x.ndim == 4 and x.stride(1) == 1:
        return torch.empty(shape, dtype=x.dtype, device=x.device,
                           memory_format=torch.channels_last).zero_()
    return x.new_zeros(shape)


class _FetchRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, plan, group, fill):
        ctx.dim, ctx.plan, ctx.group, ctx.local_rows = dim, plan, group, x.shape[dim]
        halo = None
        if plan.slots:
            buf = _buffer_like(x, dim, plan.slots)
            for pos, src, k in plan.runs:
                buf.narrow(dim, pos, k).copy_(x.narrow(dim, src, k))
            with _span("fetch_rows"):
                dist.all_reduce(buf, group=group)
            halo = buf.narrow(dim, plan.start, plan.n_above + plan.n_below)
        parts = []
        if plan.fill_above:
            parts.append(_buffer_like(x, dim, plan.fill_above).fill_(fill))
        if halo is not None and plan.n_above:
            parts.append(halo.narrow(dim, 0, plan.n_above))
        parts.append(_narrow(x, dim, plan.lo, plan.hi))
        if halo is not None and plan.n_below:
            parts.append(halo.narrow(dim, plan.n_above, plan.n_below))
        if plan.fill_below:
            parts.append(_buffer_like(x, dim, plan.fill_below).fill_(fill))
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, plan = ctx.dim, ctx.plan
        lo, hi = plan.lo, plan.hi
        grad = _buffer_like(g, dim, ctx.local_rows)
        at = plan.fill_above
        above = _narrow(g, dim, at, at + plan.n_above)
        at += plan.n_above
        _narrow(grad, dim, lo, hi).copy_(_narrow(g, dim, at, at + hi - lo))
        at += max(0, hi - lo)
        below = _narrow(g, dim, at, at + plan.n_below)
        if plan.slots:
            buf = _buffer_like(g, dim, plan.slots)
            buf.narrow(dim, plan.start, plan.n_above + plan.n_below).copy_(
                torch.cat([above, below], dim=dim))
            with _span("fetch_rows_backward"):
                dist.all_reduce(buf, group=ctx.group)
            for pos, src, k in plan.runs:
                grad.narrow(dim, src, k).add_(buf.narrow(dim, pos, k))
        return grad, None, None, None, None


def fetch_rows(x: torch.Tensor, dim: int, need: Callable[[int, int], Tuple[int, int]],
               fill: float = 0.0) -> torch.Tensor:
    """Global rows [a, b) of ``x`` along ``dim`` (its band's rows at the
    stride its height gives), where ``need(r0, r1) -> (a, b)`` says which
    rows a band [r0, r1) needs (for every band of the group: each rank
    computes what every rank fetches). Rows outside the image are ``fill``;
    rows of the band beyond [a, b) are dropped. Requires an active band."""
    band = current()
    dim = dim % x.ndim
    stride = band.stride_of(x.shape[dim])
    needs = tuple(need(*band.rows(stride, j)) for j in range(band.shards))
    plan = _fetch_plan(band.height, band.shards, band.index, stride, needs)
    return _FetchRows.apply(x, dim, plan, band.group, float(fill))


def halo(x: torch.Tensor, dim: int, above: int, below: int,
         fill: float = 0.0) -> torch.Tensor:
    """``x``'s band widened by ``above`` and ``below`` rows along ``dim``."""
    return fetch_rows(x, dim, lambda r0, r1: (r0 - above, r1 + below), fill)


def reflect_halo(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``'s band widened by one row each side along ``dim``: the
    neighbours' rows, and beyond the image's top and bottom edges their
    reflection (rows 1 and n - 2, the edge element not repeated, as
    ``jnp.pad(mode="reflect")``), which the edge band holds itself (a band
    holds at least 16 rows at stride 1)."""
    band = current()
    dim = dim % x.ndim
    stride = band.stride_of(x.shape[dim])
    n = band.global_rows(stride)
    out = fetch_rows(x, dim, lambda r0, r1: (max(r0 - 1, 0), min(r1 + 1, n)))
    r0, r1 = band.rows(stride)
    if r0 == 0:
        out = torch.cat([x.narrow(dim, 1, 1), out], dim=dim)
    if r1 == n:
        out = torch.cat([out, x.narrow(dim, x.shape[dim] - 2, 1)], dim=dim)
    return out


def conv_rows(x: torch.Tensor, kernel: int, stride: int, pad: int,
              fill: float = 0.0) -> torch.Tensor:
    """The input rows (dim 2 of NCHW ``x``) that a window of ``kernel`` rows,
    ``stride`` and ``pad`` reads for its output band ``[ceil(r0 / stride),
    ceil(r1 / stride))``: run it on them without row padding."""
    def need(r0, r1):
        o0, o1 = _ceil_div(r0, stride), _ceil_div(r1, stride)
        return stride * o0 - pad, stride * (o1 - 1) - pad + kernel
    return fetch_rows(x, 2, need, fill)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, band, r0, n):
        ctx.dim, ctx.band, ctx.r0, ctx.rows = dim, band, r0, x.shape[dim]
        buf = _buffer_like(x, dim, n)
        buf.narrow(dim, r0, x.shape[dim]).copy_(x)
        with _span("gather_rows"):
            dist.all_reduce(buf, group=band.group)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        with _span("gather_rows_backward"):
            dist.all_reduce(g, group=ctx.band.group)
        return g.narrow(ctx.dim, ctx.r0, ctx.rows), None, None, None, None


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole height of ``x`` along ``dim`` on every rank of the group
    (``x`` itself without a band)."""
    band = current()
    if band is None:
        return x
    dim = dim % x.ndim
    stride = band.stride_of(x.shape[dim])
    return _GatherRows.apply(x, dim, band, band.rows(stride)[0], band.global_rows(stride))


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group, on every rank (``x`` without a band);
    differentiable, its gradient summed over the group."""
    band = current()
    return x if band is None else all_reduce_sum(x, group=band.group)


def _image_count(x: torch.Tensor, dims: Tuple[int, ...], rows_dim: int, band: Band,
                 rows: Optional[int]) -> int:
    """The whole image's element count over ``dims`` of ``x``, whose
    ``rows_dim`` holds a band's rows (``rows`` in the whole image, by default
    those of the stride its height gives)."""
    if rows_dim not in dims:
        raise ValueError(f"a mean over {dims} of a band must include the rows (dim {rows_dim})")
    if rows is None:
        rows = band.global_rows(band.stride_of(x.shape[rows_dim]))
    return math.prod(rows if d == rows_dim else x.shape[d] for d in dims)


class _ShareTotal(torch.autograd.Function):

    @staticmethod
    def forward(ctx, share, group):
        total = share.contiguous().clone()
        with _span("band_mean"):
            dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def backward(ctx, g):
        return g, None


def band_mean(x: torch.Tensor, dims: Sequence[int], rows: Optional[int] = None) -> torch.Tensor:
    """``x.mean(dims)`` of the whole image, on every rank of the group: the
    band's sum over the image's count (the rows are dim -3, channel-last;
    ``rows`` of them in the whole image, by default those of the stride the
    band's height gives), summed over the group; its gradient on each rank
    is the band's share's. Without a band, ``x.mean(dims)``."""
    band = current()
    dims = tuple(d % x.ndim for d in dims)
    if band is None:
        return x.mean(dim=dims)
    count = _image_count(x, dims, x.ndim - 3, band, rows)
    return _ShareTotal.apply(x.sum(dim=dims) / count, band.group)


class _WholeTerm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.shards, None


def whole_term(x: torch.Tensor) -> torch.Tensor:
    """A loss term that every rank of the group computes whole (from
    gathered rows): its value, with 1/S of its gradient on each rank, so that
    the ranks' gradients sum to the whole's, as `band_mean`'s shares do.
    ``x`` itself without a band."""
    band = current()
    return x if band is None else _WholeTerm.apply(x, band.shards)


def image_mean(x: torch.Tensor, dims: Sequence[int], rows_dim: int = -3,
               keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dims)`` of the whole image, on every rank of the group, for
    a value that feeds every rank's band: the band's sums summed over the
    group (`spatial_sum`, whose gradient is the sum of the ranks'), over the
    image's count; ``rows_dim`` holds the rows. Without a band,
    ``x.mean(dims)``."""
    band = current()
    dims = tuple(d % x.ndim for d in dims)
    if band is None:
        return x.mean(dim=dims, keepdim=keepdim)
    count = _image_count(x, dims, rows_dim % x.ndim, band, None)
    return spatial_sum(x.sum(dim=dims, keepdim=keepdim)) / count


def plane_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over (H, W) of NCHW ``x`` over the whole image, on every
    rank of the group (`image_mean`)."""
    return image_mean(x, (-2, -1), rows_dim=-2)
