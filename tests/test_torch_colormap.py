"""The port's colormap and ``viz_inv_depth`` against matplotlib and the JAX
package (CPU), bit for bit.

``assets/plasma_lut.npy`` must equal matplotlib's ``plasma`` table;
`apply_colormap` must index it as matplotlib does (``x * N`` in the input's
own dtype, 1.0 on the last entry, under and over to the ends, NaN to
(0, 0, 0, 0)); and the port's ``viz_inv_depth`` must equal the JAX
package's, as float RGB and as ``(viz * 255).astype(uint8)``, on random
maps, zeros, NaN, a constant map, ``filter_zeros``, a given normalizer and
both float widths. Tolerance: none (exact equality).
"""
import numpy as np
import pytest
from matplotlib import colormaps

from dro_sfm_tpu.utils.depth import viz_inv_depth as jax_viz
from dro_sfm_torch.utils.colormap import apply_colormap, colormap_table
from dro_sfm_torch.utils.depth import viz_inv_depth


def test_table_is_matplotlibs():
    cmap = colormaps["plasma"]
    assert np.array_equal(colormap_table("plasma")[:256], cmap(np.arange(256)))
    with pytest.raises(ValueError, match="plasma"):
        colormap_table("viridis")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_indexing_matches_matplotlib(dtype):
    x = np.random.default_rng(0).uniform(-0.3, 1.3, (37, 41)).astype(dtype)
    x[0, :6] = [np.nan, 1.0, 0.0, -0.0, np.inf, -np.inf]
    x[1, :4] = [np.nextafter(dtype(1), dtype(0)), 255 / 256, 1 / 256, np.nextafter(dtype(0), dtype(1))]
    got, want = apply_colormap(x), colormaps["plasma"](x)
    assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
    with pytest.raises(TypeError):
        apply_colormap(np.arange(4))


def maps():
    rng = np.random.default_rng(1)
    rand = rng.uniform(0.02, 2.0, (48, 64)).astype(np.float32)
    holes = rand.copy()
    holes[rng.random(holes.shape) < 0.3] = 0.0
    nan = rand.copy()
    nan[3:5, 7:9] = np.nan
    return {"random": rand, "random64": rand.astype(np.float64), "holes": holes,
            "zeros": np.zeros((16, 20), np.float32), "nan": nan,
            "constant": np.full((16, 20), 0.7, np.float32), "channel": rand[..., None]}


@pytest.mark.parametrize("name", sorted(maps()))
@pytest.mark.parametrize("kwargs", [{}, {"filter_zeros": True}, {"normalizer": 0.8},
                                    {"percentile": 50}])
def test_viz_inv_depth_matches_jax(name, kwargs):
    inv = maps()[name]
    got, want = viz_inv_depth(inv, **kwargs), jax_viz(inv, **kwargs)
    assert got.shape == want.shape == (*inv.shape[:2], 3)
    assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True)
    assert np.array_equal((got * 255).astype(np.uint8), (want * 255).astype(np.uint8))
