"""matplotlib's colormaps without matplotlib: the table and its indexing.

The card's machine has no matplotlib. ``assets/plasma_lut.npy`` holds the
256 RGBA entries of ``plasma`` (written by
``tools/torch_make_colormap.py``), and `apply_colormap` indexes it as
matplotlib 3.10's ``Colormap._get_rgba_and_mask`` does for float input:
``x * N`` in the input's own dtype, ``x == N`` taken as N-1, values below 0
and at or above N given the end colours (matplotlib's default under and
over colours), NaN the bad colour (0, 0, 0, 0), the rest truncated to an
integer index.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

ASSETS = Path(__file__).resolve().parents[1] / "assets"
COLORMAPS = ("plasma",)


@functools.lru_cache(maxsize=None)
def colormap_table(name: str = "plasma") -> np.ndarray:
    """The [N+3,4] float64 table of ``name``: its N entries, then the under,
    over and bad colours."""
    if name not in COLORMAPS:
        raise ValueError(f"colormap {name!r}: the port has {COLORMAPS}")
    lut = np.load(ASSETS / f"{name}_lut.npy")
    table = np.concatenate([lut, lut[:1], lut[-1:], np.zeros((1, 4))])
    table.setflags(write=False)
    return table


def apply_colormap(x: np.ndarray, name: str = "plasma") -> np.ndarray:
    """RGBA float64 [..., 4] of the float array ``x``, as
    ``matplotlib.colormaps[name](x)`` gives it."""
    table = colormap_table(name)
    n = len(table) - 3
    xa = np.array(x, copy=True)
    if xa.dtype.kind != "f":
        raise TypeError(f"apply_colormap takes floats, not {xa.dtype}")
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under] = n
    idx[over] = n + 1
    idx[bad] = n + 2
    return table.take(idx, axis=0, mode="clip")
