"""PyTorch/CUDA port of spiking_diffusion_tpu for one NVIDIA H100.

This slice runs generation: the 49-step absorbing-diffusion sampler with
the layerwise spiking denoiser, then the spiking VQ-VAE decode
(``generate.generate``). Every LIF layer runs the hand-written CUDA
kernel ``csrc/lif_fwd.cu`` on the card (``ops/lif.py``).
"""
