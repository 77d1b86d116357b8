"""Frozen roofline arithmetic: peaks, operations and bytes per kernel."""
