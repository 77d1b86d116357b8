"""Port of cartographer_tpu.common."""
