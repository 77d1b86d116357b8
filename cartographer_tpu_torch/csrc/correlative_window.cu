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
// Bounds on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32): each input read
// once and the output written once. With the whole grid counted (1024^2
// f32 at the main path's shape, A = 169, N = 512, D = 5) that is 4.9 MB,
// 1.46 us. With only the 32-byte grid sectors these inputs' windows touch
// counted, it is less: about the same for random points, which touch
// nearly every sector, and 1.0 MB, 0.29 us, for a real scan, whose
// windows cluster on walls. chip_smoke.py prints both. The adds are
// nothing at 67 TFLOP/s. In practice the grid stays in the 50 MB L2
// between calls and the kernel is bound by the SM's rate of scattered
// warp loads through L1 and by launch latency (chip_smoke.py times an
// empty kernel on the same grid).
//
// The first version of this kernel ran one 256-thread block per (angle,
// offset), 4,225 blocks at the main shape, each reading every point's
// indices again and gathering one isolated 4-byte cell per point, then
// reducing in a shared-memory tree: 15.8 us there on an H100 at 700 W.
//
// This design:
// - One block per angle (grid.x). A block of up to 16 warps takes the
//   angle's points in tiles of 32, one tile per warp at a time, and reads
//   each point's ix, iy and mask once, coalesced (the first version read
//   them D^2 times, once per offset block).
// - The lanes of a warp hold the window, in registers. Lane = (slot,
//   column): one warp load reads one window row of kSlots = 32 / D
//   points, D adjacent lanes per point on one cache line, and each lane
//   sums its column of the window over the rows. So a point costs D warp
//   loads instead of D^2 single-cell gathers (5 instead of 25 at the main
//   shape). Each group of kSlots points takes its indices from the tile
//   by shuffle.
// - Each load returns what its lane adds: the cell, or kFill[1] (0.1) for
//   a cell off the grid, or kFill[0] (0) for a masked point. So windows
//   over the edge need no second path, no branch stands between the
//   loads, and the loads of about 16 window rows are in flight together
//   per warp (all 30 of a tile at once run slower: they only queue in
//   L1). Tiles whose points are all masked are skipped.
// - Windows wider than 7 cells (the default 0.1 m window at 5 cm gives 5)
//   run one window row of up to 32 columns per block, with the rows and
//   column chunks on grid.y.
// - The sums are reduced without atomics in a fixed order: each lane over
//   its points in order, the slots of a warp by a shuffle tree, the warps
//   of a block in order through shared memory. Every run gives the same
//   sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;
__device__ const float kFill[2] = {0.0f, 0.1f};  // masked, off the grid

// One block per (angle, chunk of kRows rows and kCols columns of the
// window): kRows = kCols = D for D <= 7, else one row of up to 32 columns.
template <int kRows, int kCols>
__global__ void __launch_bounds__(kMaxWarps * kWarp) window_sums_kernel(
    const float* __restrict__ prob, const int32_t* __restrict__ ix,
    const int32_t* __restrict__ iy, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int h, int w, int n, int num_linear,
    int col_chunks) {
  constexpr int kSlots = kWarp / kCols;  // points per warp load
  constexpr int kGroups = (kWarp + kSlots - 1) / kSlots;  // per tile
  constexpr int kBatch =  // groups whose loads are in flight together
      16 / kRows < 1 ? 1 : (16 / kRows > kGroups ? kGroups : 16 / kRows);
  const int d = 2 * num_linear + 1;
  const int a = blockIdx.x;
  const int row0 = (blockIdx.y / col_chunks) * kRows;
  const int col0 = (blockIdx.y % col_chunks) * kCols;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  const int slot = lane / kCols;
  const int col = lane % kCols;
  const bool has_offset = slot < kSlots && col0 + col < d;
  // Unsigned so that ix + dx wraps far off the grid instead of overflowing.
  const unsigned dx = static_cast<unsigned>(col0 + col - num_linear);
  const unsigned dy = static_cast<unsigned>(row0 - num_linear);
  const int32_t* ix_a = ix + static_cast<long long>(a) * n;
  const int32_t* iy_a = iy + static_cast<long long>(a) * n;

  float acc[kRows] = {};
  for (int base = warp * kWarp; base < n; base += warps * kWarp) {
    const int p = base + lane;
    const bool in_tile = p < n;
    const int tile_x = in_tile ? __ldg(ix_a + p) : 0;
    const int tile_y = in_tile ? __ldg(iy_a + p) : 0;
    const unsigned take = __ballot_sync(kFull, in_tile && __ldg(mask + p));
    if (take == 0) continue;
#pragma unroll 1
    for (int g0 = 0; g0 < kGroups; g0 += kBatch) {
      float v[kBatch][kRows];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int src = (g0 + i) * kSlots + slot;  // tile lane of the point
        const bool taken =
            has_offset && src < kWarp && ((take >> (src % kWarp)) & 1u);
        const unsigned x =
            static_cast<unsigned>(__shfl_sync(kFull, tile_x, src % kWarp)) + dx;
        const unsigned y0 =
            static_cast<unsigned>(__shfl_sync(kFull, tile_y, src % kWarp)) + dy;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const unsigned y = y0 + r;
          const bool inside = row0 + r < d && x < static_cast<unsigned>(w) &&
                              y < static_cast<unsigned>(h);
          v[i][r] = __ldg(taken ? (inside ? prob + static_cast<long long>(y) * w + x
                                          : kFill + 1)
                                : kFill);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += v[i][r];
      }
    }
  }

#pragma unroll
  for (int k = 1; k < kSlots; k *= 2) {
    const bool add = slot % (2 * k) == 0 && slot + k < kSlots;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float other = __shfl_down_sync(kFull, acc[r], k * kCols);
      if (add) acc[r] += other;
    }
  }
  __shared__ float partial[kMaxWarps][kRows][kCols];
  if (slot == 0) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) partial[warp][r][col] = acc[r];
  }
  __syncthreads();
  const int rows = min(kRows, d - row0);
  const int cols = min(kCols, d - col0);
  for (int t = threadIdx.x; t < rows * cols; t += blockDim.x) {
    const int r = t / cols;
    const int c = t % cols;
    float total = 0.0f;
    for (int k = 0; k < warps; ++k) total += partial[k][r][c];
    out[(static_cast<long long>(a) * d + row0 + r) * d + col0 + c] = total;
  }
}

__global__ void empty_kernel() {}

struct Launch {
  dim3 grid, block;
  int d;
  int col_chunks;
};

// The launch for `a` angles of `n` points and window D = 2L+1; false for
// shapes the kernel does not take.
bool plan(int a, int n, int num_linear, Launch* l) {
  if (a <= 0 || n < 0 || num_linear < 0 || num_linear > 65535) return false;
  l->d = 2 * num_linear + 1;
  const bool small = l->d <= 7;  // one chunk of D x D
  const int rows = small ? l->d : 1;
  const int cols = small ? l->d : kWarp;
  l->col_chunks = (l->d + cols - 1) / cols;
  const long long chunks =
      static_cast<long long>((l->d + rows - 1) / rows) * l->col_chunks;
  if (chunks > 65535) return false;
  const int tiles = (n + kWarp - 1) / kWarp;
  const int warps = tiles < 1 ? 1 : (tiles > kMaxWarps ? kMaxWarps : tiles);
  l->grid = dim3(a, static_cast<unsigned>(chunks));
  l->block = dim3(warps * kWarp);
  return true;
}

}  // namespace

// prob f32 [h, w], ix/iy i32 [a, n], mask u8 [n], out f32 [a, d, d]; all
// contiguous on the current device. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int correlative_window_sums(const float* prob, const int32_t* ix,
                                       const int32_t* iy, const uint8_t* mask,
                                       float* out, int h, int w, int a, int n,
                                       int num_linear, void* stream) {
  Launch l;
  if (h <= 0 || w <= 0 || !plan(a, n, num_linear, &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(R, C)                                                     \
  window_sums_kernel<R, C><<<l.grid, l.block, 0, s>>>(                   \
      prob, ix, iy, mask, out, h, w, n, num_linear, l.col_chunks)
  switch (l.d) {
    case 1: LAUNCH(1, 1); break;
    case 3: LAUNCH(3, 3); break;
    case 5: LAUNCH(5, 5); break;
    case 7: LAUNCH(7, 7); break;
    default: LAUNCH(1, kWarp); break;
  }
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel on the launch shape of correlative_window_sums, for
// timing the floor that launching and retiring that grid sets.
extern "C" int correlative_window_empty(int a, int n, int num_linear,
                                        void* stream) {
  Launch l;
  if (!plan(a, n, num_linear, &l)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  empty_kernel<<<l.grid, l.block, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
