"""Local SLAM's unwarp stage per revolution: the program's
`local_slam.unwarp` spans (the range data collator, the per-point pose
extrapolation and the unwarp, once per subdivision) inside the window,
per revolution completed in it."""

from slam_bench import program_spans


def read(record):
    return program_spans.ms_per_scan(record, ("local_slam.unwarp",))
