"""Port of cartographer_tpu.transform."""
