"""lm_match_2d's share of its roofline: the least time its launches
needed (bytes at the HBM rate or operations at the f32 peak, the larger,
from roofline/arith.py: inputs read once, rows written once, the
iterations each lane ran) over the device time of its kernels, as a
percentage, over every launch while the trace ran."""

import sys

from slam_bench import layers
from slam_bench.roofline import arith


def read(record):
    launches = record.get("launches", {}).get("lm_match_2d", [])
    device_s = layers.kernel_device_s(record, ("lm_match_2d_kernel",))
    if not launches or device_s <= 0.0:
        return None
    need, bytes_s, ops_s = 0.0, 0.0, 0.0
    for launch, out, iterations in launches:
        nbytes, ops = arith.lm_work(launch, out, iterations)
        bytes_s += nbytes / arith.HBM_BYTES_PER_S
        ops_s += ops / arith.F32_OPS_PER_S
        need += arith.bound_s(nbytes, ops)[0]
    print(f"roofline.lm_match_2d: {len(launches)} launches, bound {need:.6e} s "
          f"(bytes {bytes_s:.6e} s, operations {ops_s:.6e} s) over {device_s:.6e} s",
          file=sys.stderr)
    return 100.0 * need / device_s
