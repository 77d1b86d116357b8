"""The percentage of the window in which the pose graph's backend worked on
its thread pool: spans around the constraint builder's drains
(`run_pending`) and the optimizations (`run_optimization`, whose SPA
solve `solve_seconds` also counts). The drains contend with the frontend
for the interpreter lock and the stream."""

from slam_bench import layers


def read(record):
    if not any(n in ("drain", "solve") for n, _, _ in record["spans"]):
        return None
    return 100.0 * layers.busy_share(record, ("drain", "solve"))
