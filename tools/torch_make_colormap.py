#!/usr/bin/env python3
"""Write matplotlib's ``plasma`` lookup table for the port's colormap.

    python3 tools/torch_make_colormap.py      # needs matplotlib

``dro_sfm_torch/assets/plasma_lut.npy`` holds the 256 RGBA entries
(float64 [256,4]) of ``matplotlib.colormaps["plasma"]``, bit for bit, so
that `dro_sfm_torch.utils.colormap` colours depth maps as matplotlib does
on a machine without matplotlib.
"""
from pathlib import Path

import numpy as np
from matplotlib import colormaps

OUT = Path(__file__).resolve().parents[1] / "dro_sfm_torch" / "assets" / "plasma_lut.npy"


def main() -> None:
    cmap = colormaps["plasma"]
    lut = cmap(np.arange(cmap.N))                   # integers index the table
    assert lut.shape == (256, 4) and lut.dtype == np.float64
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.save(OUT, lut)
    print(f"wrote {OUT} ({cmap.N} entries)")


if __name__ == "__main__":
    main()
