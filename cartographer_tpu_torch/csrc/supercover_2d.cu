// Range-data insertion into 2D probability grids: both supercover
// inserters of the port, bit-identical to their plain PyTorch versions
// (cartographer_tpu_torch/kernels/supercover_2d.py), which are
// bit-identical to the JAX functions.
//
// Replaces the device programs that XLA compiled from
// cartographer_tpu/ops/raycast_2d.py:
//   insert_scan_dense (:192, its helpers from :157; the chunked
//     frontend's, vmapped over its two submap slots): for every (grid, ray, row) the ray's supercover
//     within the row is one column interval, ORed into the row's miss
//     words; hit cells are set; one clipped log-odds update per touched
//     cell, a hit wins over a miss.
//   insert_scan (:32, the per-scan builder's): for every ray, axis
//     and integer boundary crossing up to num_steps, the two cells beside
//     the crossing; also the origin and end cells; the same update.
// Reference: mapping/2d/probability_grid_range_data_inserter_2d.cc:33-133.
//
// Bounds on an H100 SXM (3.35 TB/s HBM): each grid read once and written
// once, log odds f32 and known bool, 5 B a cell each way, plus the rays.
// Two 1024^2 grids (the chunked frontend) move about 21 MB: 6.3 us. One
// 1024^2 grid (the per-scan builder, once per active submap) about 10.5
// MB: 3.1 us. The arithmetic is a few divisions per (ray, row) or (ray,
// step), far below the f32 rate.
//
// Design (simple and exact first):
// - Marks go into per-launch scratch that the wrapper allocates and this
//   entry zeroes: a hit and a miss bit plane, 32-bit words per row
//   ([B, H, ceil(W / 32)] each). Marking sets bits with atomicOr, whose
//   result does not depend on the order, so every run gives the same
//   grids. Scratch is 2 x 256 KB at 2 x 1024^2; the plain version's
//   [B, rays, H, W / 32] lattice (4 Mi words a chunk) is never built.
// - Dense misses: one thread per (grid, ray, row), the rows of one ray
//   in a block. A thread whose row the ray does not cross exits after
//   two divisions; the others OR their interval into at most
//   ceil(W / 32) + 1 words.
// - Scatter misses: one thread per (ray, crossing step), both axes; the
//   step-0 thread of each ray also marks its hit and end cell, and one
//   thread past the rays the origin cell.
// - A last pass per cell reads both planes and writes log_odds' and
//   known': the only full-grid traffic, and what the bound counts.
//
// Where bit-identity could break, and what this source does about it:
// - nvcc contracts a + b * c into one fused multiply-add by default; the
//   plain version rounds the product and the sum as two tensor ops. Every
//   such expression here (ox + t0 * dx, first + step * k, o + ts * d) is
//   written with __fmul_rn / __fadd_rn, which are never contracted.
// - Divisions are IEEE (/ is correctly rounded without --use_fast_math;
//   __fdiv_rn says so explicitly), as torch's true division.
// - Float-to-int conversions follow the host's (x86 cvttss2si): NaN and
//   values outside int32 become INT_MIN, which every bounds test rejects,
//   as the plain version's do.
// - Signed zeros from fminf / fmaxf where torch.minimum / maximum may
//   pick the other zero only ever reach floorf after an add, where they
//   give the same integer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kStepThreads = 256;
constexpr int kCellThreads = 256;

// The host's float -> int32 truncation: INT_MIN for NaN or out of range.
__device__ __forceinline__ int to_int(float f) {
  if (!(f >= -2147483648.0f && f < 2147483648.0f)) return INT32_MIN;
  return static_cast<int>(f);
}

__device__ __forceinline__ void set_bit(uint32_t* plane, int words, int y,
                                        int x) {
  atomicOr(plane + static_cast<int64_t>(y) * words + (x >> 5),
           1u << (x & 31));
}

// Mark a cell if it lies on the grid (off-grid cells are dropped, the
// plain version's dummy cell).
__device__ __forceinline__ void mark(uint32_t* plane, int words, int h,
                                     int w, int x, int y) {
  if (x >= 0 && x < w && y >= 0 && y < h) set_bit(plane, words, y, x);
}

// Hit cells of the dense inserter: one thread per (grid, ray).
__global__ void dense_hits_kernel(const float* __restrict__ ends,
                                  int64_t ends_stride,
                                  const uint8_t* __restrict__ is_hit,
                                  const uint8_t* __restrict__ valid,
                                  uint32_t* __restrict__ hits, int b_count,
                                  int h, int w, int n, int words) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(b_count) * n) return;
  const int b = static_cast<int>(i / n);
  const int ray = static_cast<int>(i % n);
  if (!valid[ray] || !is_hit[ray]) return;
  const float* e = ends + b * ends_stride + 2 * static_cast<int64_t>(ray);
  mark(hits + static_cast<int64_t>(b) * h * words, words, h, w,
       to_int(floorf(e[0])), to_int(floorf(e[1])));
}

// Dense misses: one thread per (grid, ray, row); blockIdx.x = ray *
// row_blocks + row block, blockIdx.y = grid.
__global__ void __launch_bounds__(kRowThreads) dense_misses_kernel(
    const float* __restrict__ origin, int64_t origin_stride,
    const float* __restrict__ ends, int64_t ends_stride,
    const uint8_t* __restrict__ valid, uint32_t* __restrict__ misses, int h,
    int w, int n, int words, int row_blocks) {
  const int ray = blockIdx.x / row_blocks;
  const int y = (blockIdx.x % row_blocks) * kRowThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (y >= h || !valid[ray]) return;
  const float ox = origin[b * origin_stride];
  const float oy = origin[b * origin_stride + 1];
  const float* e = ends + b * ends_stride + 2 * static_cast<int64_t>(ray);
  const float dx = e[0] - ox;
  const float dy = e[1] - oy;
  // Segment ∩ row slab [y, y + 1] in the parameter t ∈ [0, 1].
  const bool near_zero = fabsf(dy) < 1e-9f;
  const float safe_dy = near_zero ? 1.0f : dy;
  const float yf = static_cast<float>(y);
  const float ta = __fdiv_rn(yf - oy, safe_dy);
  const float tb = __fdiv_rn((yf + 1.0f) - oy, safe_dy);
  float t0 = fminf(ta, tb);
  float t1 = fmaxf(ta, tb);
  if (near_zero) {  // a horizontal ray lives in row floor(oy) only
    const bool on_row = y == to_int(floorf(oy));
    t0 = on_row ? 0.0f : 2.0f;
    t1 = on_row ? 1.0f : -1.0f;
  }
  t0 = fmaxf(t0, 0.0f);
  t1 = fminf(t1, 1.0f);
  if (!(t1 >= t0)) return;
  const float xa = __fadd_rn(ox, __fmul_rn(t0, dx));
  const float xb = __fadd_rn(ox, __fmul_rn(t1, dx));
  int x0 = to_int(floorf(fminf(xa, xb)));
  int x1 = to_int(floorf(fmaxf(xa, xb)));
  if (x1 < 0 || x0 >= w) return;
  x0 = max(x0, 0);
  x1 = min(x1, w - 1);
  uint32_t* row = misses + (static_cast<int64_t>(b) * h + y) * words;
  const int w0 = x0 >> 5, w1 = x1 >> 5;
  for (int k = w0; k <= w1; ++k) {
    const int lo = k == w0 ? (x0 & 31) : 0;
    const int hi = k == w1 ? (x1 & 31) : 31;
    const uint32_t bits = (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
    atomicOr(row + k, bits);
  }
}

// Scatter inserter's marks: one thread per (ray, crossing step k).
__global__ void __launch_bounds__(kStepThreads) scatter_marks_kernel(
    const float* __restrict__ origin, const float* __restrict__ ends,
    const uint8_t* __restrict__ is_hit, const uint8_t* __restrict__ valid,
    uint32_t* __restrict__ hits, uint32_t* __restrict__ misses, int h, int w,
    int n, int num_steps, int step_slots, int free_space) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t total = static_cast<int64_t>(n) * step_slots;
  const int words = (w + 31) >> 5;
  const float o[2] = {origin[0], origin[1]};
  if (i >= total) {  // the one thread past the rays: the origin cell
    if (i == total && free_space) {
      mark(misses, words, h, w, to_int(floorf(o[0])), to_int(floorf(o[1])));
    }
    return;
  }
  const int ray = static_cast<int>(i / step_slots);
  const int k = static_cast<int>(i % step_slots);
  const float e[2] = {ends[2 * static_cast<int64_t>(ray)],
                      ends[2 * static_cast<int64_t>(ray) + 1]};
  const bool ok = valid[ray] != 0;
  if (k == 0 && ok) {
    const int ex = to_int(floorf(e[0])), ey = to_int(floorf(e[1]));
    if (is_hit[ray]) mark(hits, words, h, w, ex, ey);
    if (free_space) mark(misses, words, h, w, ex, ey);
  }
  if (!free_space || !ok || k >= num_steps) return;
  const float kf = static_cast<float>(k);
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    // Cells beside the k-th integer crossing along `axis`.
    const float oa = o[axis], ob = o[1 - axis];
    const float d = e[axis] - oa;
    const float d_other = e[1 - axis] - ob;
    const float step = d >= 0.0f ? 1.0f : -1.0f;
    const float first = d >= 0.0f ? floorf(oa) + 1.0f : ceilf(oa) - 1.0f;
    const float ks = __fadd_rn(first, __fmul_rn(step, kf));
    const float safe_d = fabsf(d) < 1e-9f ? 1e-9f : d;
    const float ts = __fdiv_rn(ks - oa, safe_d);
    if (!(ts > 0.0f && ts <= 1.0f && fabsf(d) > 1e-9f)) continue;
    const int fo = to_int(floorf(__fadd_rn(ob, __fmul_rn(ts, d_other))));
    const int ki = to_int(ks);
    if (axis == 0) {
      mark(misses, words, h, w, ki - 1, fo);
      mark(misses, words, h, w, ki, fo);
    } else {
      mark(misses, words, h, w, fo, ki - 1);
      mark(misses, words, h, w, fo, ki);
    }
  }
}

// One clipped update per touched cell, a hit over a miss; known' =
// known | touched. One thread per cell of the B grids.
__global__ void __launch_bounds__(kCellThreads) apply_kernel(
    const float* __restrict__ log_odds, const uint8_t* __restrict__ known,
    const uint32_t* __restrict__ hits, const uint32_t* __restrict__ misses,
    float* __restrict__ out_log_odds, uint8_t* __restrict__ out_known,
    int64_t cells, int w, int words, float hit_log_odds, float miss_log_odds,
    float min_log_odds, float max_log_odds) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  const int64_t row = i / w;  // (grid, row) flattened
  const int x = static_cast<int>(i % w);
  const int64_t word = row * words + (x >> 5);
  const uint32_t bit = 1u << (x & 31);
  const bool hit = (hits[word] & bit) != 0;
  const bool miss = !hit && (misses[word] & bit) != 0;
  const float lo = log_odds[i];
  if (hit || miss) {
    const float v = lo + (hit ? hit_log_odds : miss_log_odds);
    // torch.clamp's order; a NaN passes through as it does there.
    out_log_odds[i] = v < min_log_odds ? min_log_odds
                                       : (v > max_log_odds ? max_log_odds : v);
    out_known[i] = 1;
  } else {
    out_log_odds[i] = lo;
    out_known[i] = known[i];
  }
}

int blocks_for(int64_t threads, int per_block) {
  return static_cast<int>((threads + per_block - 1) / per_block);
}

}  // namespace

// Dense inserter (insert_scan_dense): B grids [B, H, W] at B origins,
// shared rays. origin [B, 2] (origin_stride 2) or [2] (stride 0); ends
// [B, N, 2] (ends_stride 2N) or [N, 2] (stride 0). scratch holds
// 2 * B * H * ceil(W / 32) words (hits, then misses); this entry zeroes
// it. Returns cudaGetLastError() after the last launch.
extern "C" int supercover_insert_dense(
    const float* log_odds, const uint8_t* known, const float* origin,
    int64_t origin_stride, const float* ends, int64_t ends_stride,
    const uint8_t* is_hit, const uint8_t* valid, int b_count, int h, int w,
    int n, float hit_log_odds, float miss_log_odds, float min_log_odds,
    float max_log_odds, int free_space, uint32_t* scratch,
    float* out_log_odds, uint8_t* out_known, void* stream) {
  if (b_count <= 0 || h <= 0 || w <= 0 || n < 0 || b_count > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (w + 31) / 32;
  const int64_t plane = static_cast<int64_t>(b_count) * h * words;
  uint32_t* hits = scratch;
  uint32_t* misses = scratch + plane;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * plane * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    const int64_t rays = static_cast<int64_t>(b_count) * n;
    dense_hits_kernel<<<blocks_for(rays, 256), 256, 0, s>>>(
        ends, ends_stride, is_hit, valid, hits, b_count, h, w, n, words);
    if (free_space) {
      const int row_blocks = (h + kRowThreads - 1) / kRowThreads;
      const dim3 grid(static_cast<unsigned>(n) * row_blocks, b_count);
      dense_misses_kernel<<<grid, kRowThreads, 0, s>>>(
          origin, origin_stride, ends, ends_stride, valid, misses, h, w, n,
          words, row_blocks);
    }
  }
  const int64_t cells = static_cast<int64_t>(b_count) * h * w;
  apply_kernel<<<blocks_for(cells, kCellThreads), kCellThreads, 0, s>>>(
      log_odds, known, hits, misses, out_log_odds, out_known, cells, w, words,
      hit_log_odds, miss_log_odds, min_log_odds, max_log_odds);
  return static_cast<int>(cudaGetLastError());
}

// Scatter inserter (insert_scan): one grid [H, W], origin [2], ends
// [N, 2]. scratch holds 2 * H * ceil(W / 32) words; this entry zeroes it.
extern "C" int supercover_insert_scatter(
    const float* log_odds, const uint8_t* known, const float* origin,
    const float* ends, const uint8_t* is_hit, const uint8_t* valid, int h,
    int w, int n, int num_steps, float hit_log_odds, float miss_log_odds,
    float min_log_odds, float max_log_odds, int free_space, uint32_t* scratch,
    float* out_log_odds, uint8_t* out_known, void* stream) {
  if (h <= 0 || w <= 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (w + 31) / 32;
  const int64_t plane = static_cast<int64_t>(h) * words;
  uint32_t* hits = scratch;
  uint32_t* misses = scratch + plane;
  cudaError_t err = cudaMemsetAsync(scratch, 0, 2 * plane * sizeof(uint32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Slot 0 of each ray also marks its hit and end cells; one thread past
  // the rays marks the origin cell (a miss whatever the rays).
  const int step_slots = num_steps > 1 ? num_steps : 1;
  const int64_t threads = static_cast<int64_t>(n) * step_slots + 1;
  scatter_marks_kernel<<<blocks_for(threads, kStepThreads), kStepThreads, 0,
                         s>>>(origin, ends, is_hit, valid, hits, misses, h, w,
                              n, num_steps, step_slots, free_space);
  const int64_t cells = static_cast<int64_t>(h) * w;
  apply_kernel<<<blocks_for(cells, kCellThreads), kCellThreads, 0, s>>>(
      log_odds, known, hits, misses, out_log_odds, out_known, cells, w, words,
      hit_log_odds, miss_log_odds, min_log_odds, max_log_odds);
  return static_cast<int>(cudaGetLastError());
}
