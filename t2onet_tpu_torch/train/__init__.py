"""Training: the alternating supervised / episode steps and checkpoints."""
