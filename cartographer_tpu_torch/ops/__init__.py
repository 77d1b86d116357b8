"""Port of cartographer_tpu.ops."""
