"""Training: losses, AdamW, checkpoints and the train loop."""
