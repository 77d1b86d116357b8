"""The feeding thread's wait for the pose graph's work lock per
revolution: the program's `pose_graph.work_lock_wait` spans on the thread
of the facade's `add_sensor_data` spans (add_node's acquire, and the
dispatch of a drain, which add_node already holds) inside the window, per
revolution completed in it. An SPA solve holds the lock on the pool's
thread while add_node waits."""

from slam_bench import program_spans


def read(record):
    return program_spans.ms_per_scan(record, ("pose_graph.work_lock_wait",), feeder_only=True)
