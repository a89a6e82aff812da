"""Models of the port."""

from spiking_diffusion_tpu_torch.models import deploy, lava_export

__all__ = ["deploy", "lava_export"]
