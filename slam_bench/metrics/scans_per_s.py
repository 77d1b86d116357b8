"""Revolutions whose local SLAM result returned inside the window, per
second of the window (closed loop: the stream replayed as fast as the
results come back, as cartographer_ros's offline node replays a bag)."""

from slam_bench import layers


def read(record):
    return layers.rate(record)
