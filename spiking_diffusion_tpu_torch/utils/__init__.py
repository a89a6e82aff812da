"""Utilities of the port: image grids written as PNG without PIL."""

from spiking_diffusion_tpu_torch.utils.grids import save_image_grid, save_recon_grid

__all__ = ["save_image_grid", "save_recon_grid"]
