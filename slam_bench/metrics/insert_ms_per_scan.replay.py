"""The insertion stage per revolution: the program's `local_slam.insert`
spans (the extrapolator's pose update, the motion filter, the insertion
into the active submaps and the result's assembly) inside the window, per
revolution completed in it."""

from slam_bench import program_spans


def read(record):
    return program_spans.ms_per_scan(record, ("local_slam.insert",))
