"""On the card: the program's spans and the device trace share a clock. A
span around a kernel and its synchronisation, recorded while the traced
run's `DeviceTrace` (CUDA activity alone) is on, contains the kernel's
interval as `DeviceTrace` places it, within 1 ms.

    python -m pytest slam_bench/tests/test_program_spans_card.py -m cuda -q

Skips where no card is present.
"""

import pytest
import torch

from cartographer_tpu_torch import metrics
from slam_bench.trace import DeviceTrace

TOLERANCE_S = 1e-3


@pytest.mark.cuda
def test_a_span_contains_its_synchronised_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    a = torch.randn(4096, 4096, device="cuda")
    (a @ a).sum().item()  # cuBLAS and the context set up outside the trace
    metrics.reset_spans()
    dtrace = DeviceTrace()
    dtrace.start("cuda")
    try:
        torch.cuda._sleep(1_000_000)  # the trace's first events, before the span
        with metrics.span("bench.kernel"):
            b = a @ a
            torch.cuda.synchronize()
    finally:
        dtrace.stop()
    spans = [s for s in metrics.spans() if s is not None]
    metrics.reset_spans()
    (span,) = [s for s in spans if s[0] == "bench.kernel"]
    start, end = span[1] * 1e-9, span[2] * 1e-9
    kernels = [e for e in dtrace.events if e[1] == "kernel"]
    gemm = max(kernels, key=lambda e: e[3] - e[2])
    assert gemm[3] - gemm[2] > 1e-4, kernels  # the 4096³ product, not the sleep
    print(f"span {start:.6f}-{end:.6f} s, kernel {gemm[0][:60]} {gemm[2]:.6f}-{gemm[3]:.6f} s: "
          f"{(gemm[2] - start) * 1e3:.3f} ms after the span's start, "
          f"{(end - gemm[3]) * 1e3:.3f} ms before its end")
    assert start - TOLERANCE_S <= gemm[2] and gemm[3] <= end + TOLERANCE_S
    assert b.shape == a.shape
