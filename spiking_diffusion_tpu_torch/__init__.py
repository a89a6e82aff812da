"""PyTorch/CUDA port of spiking_diffusion_tpu for one NVIDIA H100.

Generation: the 49-step absorbing-diffusion sampler with the spiking
denoiser, then the spiking VQ-VAE decode (``generate.generate``), either
layerwise, with every LIF layer on the hand-written CUDA kernel K1
(``csrc/lif_fwd.cu``, ``ops/lif.py``), or fused, one launch of the
whole-denoiser kernel K2 per step (``csrc/fused_denoiser.cu``).

Stage-2 training of the diffusion prior (``train/stage2.py``): the
layerwise denoiser backpropagates through K1's backward kernel
(``csrc/lif_bwd.cu``); the 'bnlif' denoiser runs BN-apply + LIF as K3,
forward and backward (``csrc/bn_lif.cu``, ``ops/bn_lif.py``); the
'bnlifconv' denoiser also runs every 3x3 conv as K4, the training conv
that hands BN its batch moments, forward and backward
(``csrc/spike_conv.cu``, ``ops/spike_conv.py``), in training and in eval.
Every branch runs in fp32 or bf16.
"""
