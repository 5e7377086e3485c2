"""Training: losses, schedules, optimizers, the train step and the Trainer."""
