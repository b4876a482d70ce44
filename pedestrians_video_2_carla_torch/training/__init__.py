"""Training: the trainer, checkpoints and the metrics logger."""
