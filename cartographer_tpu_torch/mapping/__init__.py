"""Port of cartographer_tpu.mapping."""
