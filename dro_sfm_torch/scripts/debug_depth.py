"""Inspect depth files: shape, valid share, range, median and a histogram.

    python -m dro_sfm_torch.scripts.debug_depth depth.png [depth2.npz ...]

The port's copy of `tools/debug_depth.py`, reading through the port's
`utils/depth.py:load_depth` (a uint16 ``.png`` of ``depth * 256`` or an
``.npz`` with ``depth``).
"""
from __future__ import annotations

import sys

import numpy as np


def main(argv=None):
    from dro_sfm_torch.utils.depth import load_depth
    for path in sys.argv[1:] if argv is None else argv:
        depth = np.asarray(load_depth(path)).squeeze()
        valid = depth > 0
        print(f"== {path}")
        print(f"   shape {depth.shape}  dtype {depth.dtype}")
        print(f"   valid {valid.mean() * 100:.1f}%  "
              f"min {depth[valid].min() if valid.any() else 0:.3f}  "
              f"max {depth[valid].max() if valid.any() else 0:.3f}  "
              f"median {np.median(depth[valid]) if valid.any() else 0:.3f}")
        hist, edges = np.histogram(depth[valid], bins=8)
        for h, lo, hi in zip(hist, edges[:-1], edges[1:]):
            bar = "#" * int(40 * h / max(hist.max(), 1))
            print(f"   [{lo:7.2f},{hi:7.2f}) {h:8d} {bar}")


if __name__ == "__main__":
    main()
