"""The percentage of the window in which nothing ran on the device: 1 - the
union of the profiler's device intervals (kernels, copies, fills) / the
window."""

from slam_bench import layers


def read(record):
    share = layers.device_idle_share(record)
    return None if share is None else 100.0 * share
