"""Utilities of the port: image grids written as PNG without PIL
(``grids.py``); spike and membrane plots (``visualizing.py``, matplotlib
imported on use)."""

from spiking_diffusion_tpu_torch.utils.grids import save_image_grid, save_recon_grid

__all__ = ["save_image_grid", "save_recon_grid"]
