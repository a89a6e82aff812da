"""Spike/membrane visualization of the port — spikingjelly ``visualizing/``
parity; counterpart of ``spiking_diffusion_tpu/utils/visualizing.py``.

2-D heatmaps over time, 1-D spike rasters, feature-map grids, and
single-neuron v/s traces (``spikingjelly/visualizing/__init__.py:6-365``),
drawn with matplotlib, imported on use (the card's machine has none, so
these run on the host where it is installed). Every function takes numpy
arrays or torch tensors (a CUDA tensor is copied to the host) and returns
the Figure; pass ``save_path`` to write a PNG without showing.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _fig(save_path: Optional[str]):
    import matplotlib

    if save_path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def to_numpy(array) -> np.ndarray:
    """A numpy array of ``array``: a torch tensor (on any device, with or
    without a gradient) is detached and copied to the host."""
    if hasattr(array, "detach"):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def _finish(fig, plt, save_path: Optional[str]):
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def plot_2d_heatmap(
    array,
    title: str = "membrane potentials",
    xlabel: str = "simulating step",
    ylabel: str = "neuron index",
    save_path: Optional[str] = None,
):
    """(T, N) array -> heatmap with T on x (parity: plot_2d_heatmap)."""
    plt = _fig(save_path)
    arr = to_numpy(array)
    fig, ax = plt.subplots()
    im = ax.imshow(arr.T, aspect="auto", origin="lower")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    fig.colorbar(im, ax=ax)
    return _finish(fig, plt, save_path)


def plot_1d_spikes(
    spikes,
    title: str = "spike raster",
    xlabel: str = "simulating step",
    ylabel: str = "neuron index",
    save_path: Optional[str] = None,
):
    """(T, N) binary spikes -> raster scatter (parity: plot_1d_spikes)."""
    plt = _fig(save_path)
    s = to_numpy(spikes)
    t_idx, n_idx = np.nonzero(s)
    fig, ax = plt.subplots()
    ax.scatter(t_idx, n_idx, s=4, marker="|")
    ax.set_xlim(-0.5, s.shape[0] - 0.5)
    ax.set_ylim(-0.5, s.shape[1] - 0.5)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    return _finish(fig, plt, save_path)


def plot_2d_feature_map(
    feature_map,
    nrows: Optional[int] = None,
    ncols: Optional[int] = None,
    title: str = "feature maps",
    save_path: Optional[str] = None,
):
    """(C, H, W) maps -> tiled grid (parity: plot_2d_bool_spikes /
    plot_2d_feature_map)."""
    plt = _fig(save_path)
    fm = to_numpy(feature_map)
    c = fm.shape[0]
    if ncols is None:
        ncols = int(np.ceil(np.sqrt(c)))
    if nrows is None:
        nrows = int(np.ceil(c / ncols))
    fig, axes = plt.subplots(nrows, ncols, squeeze=False)
    for i in range(nrows * ncols):
        ax = axes[i // ncols][i % ncols]
        ax.axis("off")
        if i < c:
            ax.imshow(fm[i], cmap="gray")
    fig.suptitle(title)
    return _finish(fig, plt, save_path)


def plot_one_neuron_v_s(
    v,
    s,
    v_threshold: float = 1.0,
    v_reset: float = 0.0,
    title: str = "membrane potential and spikes",
    save_path: Optional[str] = None,
):
    """(T,) membrane + (T,) spikes -> two-panel trace (parity:
    plot_one_neuron_v_s)."""
    plt = _fig(save_path)
    v = to_numpy(v).reshape(-1)
    s = to_numpy(s).reshape(-1)
    fig, (ax_v, ax_s) = plt.subplots(2, 1, sharex=True)
    ax_v.plot(v)
    ax_v.axhline(v_threshold, ls="--", lw=0.8, label="v_threshold")
    ax_v.axhline(v_reset, ls=":", lw=0.8, label="v_reset")
    ax_v.set_ylabel("v")
    ax_v.legend(fontsize=7)
    t_idx = np.nonzero(s)[0]
    ax_s.scatter(t_idx, np.zeros_like(t_idx), marker="|")
    ax_s.set_xlabel("simulating step")
    ax_s.set_ylabel("spike")
    fig.suptitle(title)
    return _finish(fig, plt, save_path)
