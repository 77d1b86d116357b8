"""Port of cartographer_tpu.evaluation."""
