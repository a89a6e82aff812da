"""Training of the port: train state, the stage-1 (VQ-VAE) and stage-2
(diffusion prior) steps and loops, checkpoints."""
