"""Port of cartographer_tpu.testing."""
