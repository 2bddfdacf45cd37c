"""Train state, steps, Trainer, metrics and checkpoints."""
