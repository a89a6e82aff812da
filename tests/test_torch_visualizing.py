"""The port's plots (``utils/visualizing.py``) against the JAX package's:
each figure's drawn data (images, scatter offsets, lines, limits, labels,
titles) equals JAX's for the same numpy input, and for the same values
passed as a torch tensor (one that requires grad included); ``save_path``
writes a PNG with the Agg backend."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from spiking_diffusion_tpu.utils import visualizing as jvis  # noqa: E402
from spiking_diffusion_tpu_torch.utils import visualizing as tvis  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)
    yield
    plt.close("all")


def _drawn(fig):
    """What a figure draws, axis by axis, as comparable values."""
    out = [fig._suptitle.get_text() if fig._suptitle else None]
    for ax in fig.axes:
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim(), "axis_on": ax.axison,
            "images": [np.asarray(im.get_array()) for im in ax.images],
            "cmaps": [im.get_cmap().name for im in ax.images],
            "offsets": [np.asarray(c.get_offsets()) for c in ax.collections],
            "lines": [(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()), ln.get_label())
                      for ln in ax.lines],
        })
    return out


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
    else:
        assert a == b


def _inputs(arr):
    """The numpy array, a CPU tensor and one that requires grad."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    yield arr
    yield t
    if t.is_floating_point():
        yield t.clone().requires_grad_(True)


RNG = np.random.RandomState(0)
V = RNG.rand(20, 6).astype(np.float32)
S = (RNG.rand(20, 6) > 0.7).astype(np.float32)
FM = RNG.rand(5, 4, 4).astype(np.float32)


@pytest.mark.parametrize("name, args, kw", [
    ("plot_2d_heatmap", (V,), {"title": "v"}),
    ("plot_1d_spikes", (S,), {}),
    ("plot_2d_feature_map", (FM,), {}),
    ("plot_2d_feature_map", (FM,), {"nrows": 1, "ncols": 5, "title": "maps"}),
    ("plot_one_neuron_v_s", (V[:, 0], S[:, 0]), {"v_threshold": 0.8, "v_reset": -0.1}),
])
def test_plots_draw_jax_data(name, args, kw):
    want = _drawn(getattr(jvis, name)(*args, **kw))
    for variant in zip(*(_inputs(a) for a in args)):
        _same(_drawn(getattr(tvis, name)(*variant, **kw)), want)


def test_save_path_writes_png(tmp_path):
    path = tmp_path / "raster.png"
    tvis.plot_1d_spikes(torch.from_numpy(S), save_path=str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_to_numpy():
    t = torch.arange(6.0, requires_grad=True).reshape(2, 3)
    got = tvis.to_numpy(t)
    assert isinstance(got, np.ndarray) and got.shape == (2, 3)
    np.testing.assert_array_equal(got, np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(tvis.to_numpy([1, 2]), np.array([1, 2]))
