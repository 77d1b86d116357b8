"""The local trajectory builder's time per revolution: spans around its
`add_range_data` (range collation, motion unwarp, voxel filters,
extrapolator, scan matching, insertion) over the window, per revolution
completed in it."""

from slam_bench import layers


def read(record):
    return layers.per_revolution_ms(record, layers.span_s(record, "local_slam"))
