"""Port of cartographer_tpu.ops.scan_matching."""
