"""Port of cartographer_tpu.sensor."""
