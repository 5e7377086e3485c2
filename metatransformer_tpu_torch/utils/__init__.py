"""Host-side utilities: checkpoints and logging."""
