"""One run of one cell:

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: make the cell's stream from the seed on the card, build the
port's MapBuilder on `cuda`, warm up to local SLAM's steady state, measure
for `--seconds`, compare what the window produced with the plain
reference, and print one JSON line as the last line of standard output
(the numbers compared, each with its limit, also as the last lines of
standard error). With `--trace 1` the window is traced and the cell's
per-layer metrics are reported instead of its end-to-end ones. A run
without a card, or with fewer cards than the cell asks for, fails.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from slam_bench import registry  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "cartographer_tpu"}


def environment() -> None:
    """One host thread for the math libraries (numpy's BLAS, torch's
    OpenMP pool), whose spinning workers would otherwise contend with the
    feeding thread for the host's cores; every build and kernel cache
    inside the checkout, at fixed paths (the port's nvcc and host builds
    are `cartographer_tpu_torch/.build/` by its own code). Set before
    numpy or torch is imported."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    base = registry.ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def revolutions_needed(cell: dict, seconds: float) -> int:
    """Revolutions to generate: the warm-up's allowance and, for the
    window, the cell's `scan_factor` times its expected rate, with a few
    to flush the last results."""
    window = cell["scan_factor"] * cell["expected_revolutions_per_s"] * seconds
    return int(cell["warmup_revolutions_max"] + math.ceil(window) + 16)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def measure(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            root=registry.ROOT, plant=None, control: bool = False) -> dict:
    """The run itself, on `device`; returns the result and what was
    compared. For the benchmark's tests only: `plant(probe)` breaks the
    timed path after set-up, and `control` also holds the control (the
    reference one precision down) to the reference on the same captures,
    under `control`."""
    import numpy as np
    import torch

    from slam_bench import check, drive, layers
    from slam_bench.trace import DeviceTrace, breakdown

    spec = registry.workload(name, root)
    cell, config = spec["cell"], spec["config"]
    if spec["mix"]["loop"] != "closed":
        raise ValueError(f"{name}: the harness drives closed-loop mixes only")
    kind = registry.harness(config, root)
    stream = kind.generate(config, revolutions_needed(cell, seconds), seed, device)
    # The stream's objects live to the end: keep the collector from
    # walking them again and again inside the window.
    gc.collect()
    gc.freeze()

    probe = kind.Probe(np.random.default_rng([seed, 1]), cell["sample"], spans=trace)
    feeder = drive.Feeder(stream, None)
    build, warmed_up, drain = (getattr(kind, part, getattr(drive, part))
                               for part in ("build", "warmed_up", "drain"))
    mb, tid = build(config, device, feeder.on_result)
    feeder.builder = mb.get_trajectory_builder(tid)
    probe.attach(mb, tid)
    if torch.device(device).type == "cuda":
        from cartographer_tpu_torch.kernels import _build

        _build.build_all()
    warmup = drive.warm_up(feeder, probe.local, cell["warmup_revolutions_max"],
                           cell["warmup_until"], warmed_up)
    if plant is not None:
        plant(probe)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()

    dtrace = DeviceTrace(getattr(kind, "record_launches", None)) if trace else None
    if dtrace is not None:
        dtrace.start(device)
    probe.begin()
    t_window = time.perf_counter()
    window = drive.closed_loop(feeder, seconds)
    drive.flush(feeder, window["due"], lambda: drain(mb, tid))
    probe.recording = False
    drive.settle(mb)
    if dtrace is not None:
        dtrace.stop()
    probe.detach()

    due = window["due"]
    done_of_due = feeder.done[due] if due else np.zeros(0)
    missing = int(np.sum(np.isnan(done_of_due)))
    record = {
        "t0": window["t0"], "t1": window["t1"], "setup_s": t_window - T_START,
        "done": feeder.done, "due": due, "done_of_due": done_of_due,
        "spans": probe.spans, "device_events": dtrace.events if dtrace else [],
        "launches": dtrace.launches if dtrace else {},
    }
    revs = [k for k in due if k in feeder.poses]
    drift = kind.drift(feeder.poses, stream, revs) if kind.drift else None
    if drift is not None:
        print(f"local SLAM against the generator's truth over the window's revolutions: "
              f"widest drift {drift:.4f} m from the first (recorded, not compared)",
              file=sys.stderr)

    device_info = {"platform": "cpu" if device == "cpu" else "gpu", "count": 1}
    if torch.device(device).type == "cuda":
        device_info["kind"] = torch.cuda.get_device_name(0)
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if trace:
        device_info["busy_s"] = layers.device_busy_s(record)
        device_info["window_s"] = record["t1"] - record["t0"]

    metrics = {}
    for m in registry.metrics_for(name, trace, root):
        value = registry.reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The program's state goes before the reference runs; what the
    # captures hold stays.
    del mb, feeder.builder
    probe.local = None
    numbers = kind.compare(probe, config, stream, missing)
    correct, rows, recorded = check.judge(numbers, cell["limits"])
    controlled = kind.compare(probe, config, stream, missing, control=True) if control else None
    result = {"correct": bool(correct), "attempted": len(due), "failed": missing,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown(record)
    if controlled is not None:
        ok, crows, crecorded = check.judge(controlled, cell["limits"])
        result["control"] = {"correct": ok, **{n: v for n, v, _ in crows}, **crecorded}
    result["stream"] = {"revolutions": len(stream.rev_time), "warmup": warmup,
                        "points_per_revolution": stream.points_per_rev}
    result["sample"] = probe.counts()
    result["recorded"] = recorded
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    environment()

    import torch

    chips = registry.workload(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    card = power_limit()
    result = measure(args.workload, args.seed, args.seconds, bool(args.trace))
    found = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if found:
        print(f"no result: modules loaded in the benchmark's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    result = {"card": card, **result}
    print(f"card: {card}", file=sys.stderr)
    for n, v in result["recorded"].items():
        print(f"{n} {v!r} (recorded, not compared)", file=sys.stderr)
    for n, c in result["compared"].items():
        print(f"{n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
