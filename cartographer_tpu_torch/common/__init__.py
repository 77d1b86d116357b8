"""Port of cartographer_tpu.common."""
from cartographer_tpu_torch.common.time import Time, Duration, from_seconds, to_seconds
from cartographer_tpu_torch.common.math import (
    clamp,
    normalize_angle_difference,
    round_to_int,
)
from cartographer_tpu_torch.common.fixed_ratio_sampler import FixedRatioSampler
from cartographer_tpu_torch.common.histogram import Histogram
from cartographer_tpu_torch.common.task import Task, ThreadPool
from cartographer_tpu_torch.common.blocking_queue import BlockingQueue
