// RTCSM window sums: the window-sum half of the real-time correlative scan
// matcher (real_time_correlative_scan_matcher_2d.cc:61-176).
//
// Replaces the TPU kernel cartographer_tpu/ops/pallas_kernels.py:82
// (correlative_score_windows, body _score_kernel) and computes exactly
// what cartographer_tpu/ops/scan_matching/correlative_2d.py:78
// (_window_sums_xla) computes:
//
//   out[a][dy][dx] = sum over n with mask[n] of
//       prob[iy[a][n] + dy - L][ix[a][n] + dx - L]   (in-grid cells)
//       MIN_PROBABILITY = 0.1                        (cells off the grid)
//
// for every angle a < A and window offset (dy, dx) in [0, D)^2, D = 2L+1,
// for any D >= 1 and any grid H x W >= 1 (the TPU kernel's D <= 8 and
// 16 x 256 minimum came from its tile shapes and do not apply here).
//
// Design: one block of 256 threads per (angle, offset), on a 1-D grid of
// A * D * D blocks. The threads stride over the N points in order, each
// summing its points in f32; a shared-memory tree then reduces the 256
// partial sums. The order of the sum is fixed, so the result is the same
// on every run, and no atomics are needed.
//
// Bound on an H100 SXM (3.35 TB/s): the compulsory traffic is the grid
// read once, ix and iy, the mask and the output. At the main path's
// shapes (H = W = 1024 f32 = 4.2 MB, A = 169, N = 512, D = 5) that is
// about 4.9 MB, about 1.5 us; the A * D * D * N = 2.2 M adds take far
// less at 67 TFLOP/s f32. The grid stays in the 50 MB L2 across blocks,
// and with one launch per scan the kernel is bound by launch latency in
// practice. This first version is simple and right; making it fast is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kMinProbability = 0.1f;

__global__ void __launch_bounds__(kThreads) window_sums_kernel(
    const float* __restrict__ prob, const int32_t* __restrict__ ix,
    const int32_t* __restrict__ iy, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int h, int w, int n, int num_linear) {
  const int d = 2 * num_linear + 1;
  const long long block = blockIdx.x;
  const long long a = block / (d * d);
  const int offset = static_cast<int>(block % (d * d));
  const int dy = offset / d - num_linear;
  const int dx = offset % d - num_linear;
  const int32_t* ix_a = ix + a * n;
  const int32_t* iy_a = iy + a * n;

  float sum = 0.0f;
  for (int p = threadIdx.x; p < n; p += kThreads) {
    if (!mask[p]) continue;
    const long long y = static_cast<long long>(iy_a[p]) + dy;
    const long long x = static_cast<long long>(ix_a[p]) + dx;
    const bool in_grid = y >= 0 && y < h && x >= 0 && x < w;
    sum += in_grid ? __ldg(prob + y * w + x) : kMinProbability;
  }

  __shared__ float partial[kThreads];
  partial[threadIdx.x] = sum;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      partial[threadIdx.x] += partial[threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[block] = partial[0];
}

}  // namespace

// prob f32 [h, w], ix/iy i32 [a, n], mask u8 [n], out f32 [a, d, d]; all
// contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int correlative_window_sums(const float* prob, const int32_t* ix,
                                       const int32_t* iy, const uint8_t* mask,
                                       float* out, int h, int w, int a, int n,
                                       int num_linear, void* stream) {
  const long long d = 2LL * num_linear + 1;
  const long long blocks = static_cast<long long>(a) * d * d;
  if (blocks <= 0 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  window_sums_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      prob, ix, iy, mask, out, h, w, n, num_linear);
  return static_cast<int>(cudaGetLastError());
}
