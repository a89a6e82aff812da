"""Training of the port: train state, the stage-2 step and loop, checkpoints."""
