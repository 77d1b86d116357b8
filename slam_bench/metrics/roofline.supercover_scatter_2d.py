"""The supercover scatter insertion's share of its roofline: the least
time its launches needed (bytes at the HBM rate or operations at the f32
peak, the larger, from roofline/arith.py: each grid read and written
once, the rays read once) over the device time of its two kernels
(`scatter_marks_kernel`, `apply_kernel`), as a percentage, over every
launch while the trace ran. The fill of its bit planes, a memset with no
kernel name, is not counted in the time."""

import sys

from slam_bench import layers
from slam_bench.roofline import arith


def read(record):
    launches = record.get("launches", {}).get("supercover_scatter_2d", [])
    device_s = layers.kernel_device_s(record, ("scatter_marks_kernel", "apply_kernel"))
    if not launches or device_s <= 0.0:
        return None
    need = 0.0
    kinds = set()
    for args in launches:
        log_odds, _, origin_cell, ends_cell, is_hit = args[:5]
        s, by = arith.bound_s(*arith.scatter_work(log_odds, ends_cell, is_hit, origin_cell, args[8]))
        need += s
        kinds.add(by)
    print(f"roofline.supercover_scatter_2d: {len(launches)} launches, bound {need:.6e} s "
          f"by {'/'.join(sorted(kinds))} over {device_s:.6e} s", file=sys.stderr)
    return 100.0 * need / device_s
