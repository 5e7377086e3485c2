"""Host-side utilities: checkpoints, logging, metrics, segmentation
evaluation and the profiling harness."""
