"""Training utilities of the port: checkpoints and metrics."""
