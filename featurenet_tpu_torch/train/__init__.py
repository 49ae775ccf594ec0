"""Training: train/eval steps, optimizers, train state and the Trainer."""
