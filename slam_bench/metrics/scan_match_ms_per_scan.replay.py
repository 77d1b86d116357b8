"""The host's side of the LM scan match per revolution: the program's
`local_slam.scan_match` spans (the uploads of the prediction and the
points, the lm_match_2d launch and the readback that waits for it)
inside the window, per revolution completed in it."""

from slam_bench import program_spans


def read(record):
    return program_spans.ms_per_scan(record, ("local_slam.scan_match",))
