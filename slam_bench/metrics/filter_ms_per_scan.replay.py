"""Local SLAM's filter stage per revolution: the program's
`local_slam.filter` spans (the gravity estimate, the transform into the
gravity frame, the z crop, both voxel filters, the pose prediction and
the adaptive voxel filter, once per accumulation) inside the window, per
revolution completed in it."""

from slam_bench import program_spans


def read(record):
    return program_spans.ms_per_scan(record, ("local_slam.filter",))
