"""Training: LM trainer, optimizers, schedules, metrics, checkpoints."""
