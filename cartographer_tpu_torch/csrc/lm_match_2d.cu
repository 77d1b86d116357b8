// Scan-match refinement: K independent Levenberg-Marquardt solves of the
// bicubic occupied-space cost, one block per lane.
//
// Replaces the device program that XLA compiled from
// cartographer_tpu/ops/scan_matching/gauss_newton_2d.py: `match` (:498,
// its lax.while_loop at :618) and, vmapped over loop-closure lanes,
// `match_log_odds_batch_packed` (:405). It computes what the port's plain
// version computes (cartographer_tpu_torch/kernels/lm_match_2d.py,
// match_lanes_plain). Reference: ceres_scan_matcher_2d.cc:53-107 with
// occupied_space_cost_function_2d.cc:30-117.
//
// Per lane: residuals r_i = osw * bicubic(cost grid, u_i, v_i) over the
// lane's masked points (osw = weight / sqrt(n_valid), n_valid clamped to
// 1; Catmull-Rom on the 4 x 4 patch at floor(u, v), cells off the grid
// read MAX_CORRESPONDENCE_COST), plus three prior rows (translation to
// the target, rotation to the initial yaw). Each iteration: J^T J (3 x 3)
// and J^T r at the accepted pose, damping lambda * diag, the unrolled
// Cholesky of solve_spd_small (pivots clamped at 1e-20), the candidate's
// cost, accept (plain: the cost fell; or Ceres's nonmonotonic step
// evaluator), lambda x 0.5 (floor 1e-12) or x 4, and convergence
// (relative change <= 1e-6 on an accepted step, or lambda > 1e3 on a
// rejected one). A lane stops at its convergence: the plain loop only
// freezes the carry from there on, so the result is the same.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32): per lane and
// iteration every point reads a 4 x 4 patch at the accepted pose and one
// at the candidate, but along one solve the poses move by millimetres on
// a grid of centimetres, so the same grid sectors come back again and
// again. The bytes that must move are the distinct 32-byte sectors the
// patches cover over the poses the run visits, plus the points and the
// outputs; chip_smoke.py's kernel_2d phase counts them from each run's
// data (lm_path_sectors). The operations (about 200 a point and
// iteration) weigh more than those bytes at these shapes, and neither is
// the limit: the serial chain of up to 20 iterations is, each with three
// block barriers, two dependent patch gathers from L2 and a serial 3 x 3
// solve on one thread.
// One lane fills one SM at most; the loop-closure batches' K lanes run
// on K SMs at once.
//
// Design (simple and right first):
// - One block per lane, up to 512 threads, the lane's points strided
//   over the threads. The carried 4 x 4 patch of the plain version is the
//   patch at floor(u, v) of the accepted pose, so each iteration reads it
//   again from the grid (it stays in L1 / L2) instead of keeping it: the
//   same values, no per-point state.
// - Two fixed-order block reductions an iteration: the 9 sums of J^T J
//   and J^T r at the accepted pose, then the candidate's cost. A warp
//   sums by a shuffle tree, then thread 0 sums the warps in order. No
//   atomics: two launches on the same inputs give the same bits.
// - Thread 0 solves, applies the LM control and the evaluator, and
//   broadcasts the pose (and its cos / sin) through shared memory.
//
// Where the result could part from the plain version's, and what this
// source does about it:
// - Sums run in another order than torch.bmm / torch.sum; results agree
//   to float rounding. A lane whose LM has not settled (it cycles between
//   poses a centimetre apart) can then stop elsewhere: chip_smoke.py's
//   lm_stop_explained rule says when that is the LM's own branching.
// - The pose to (u, v) map is rounded as the plain version's tensor ops
//   round it (__fmul_rn / __fadd_rn: no contraction into FMAs), with a
//   true division by the resolution (u = (wx - ox) / res - 0.5), while the
//   Jacobian multiplies by 1 / res, as there. sinf / cosf are the
//   accurate ones (no --use_fast_math, no __sinf).
// - Float-to-int conversions follow the host's: NaN and values outside
//   int32 become INT_MIN, a patch entirely off the grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMaxCorrespondenceCost = 0.9f;
constexpr int kMaxConsecutiveNonmonotonicSteps = 5;

struct Params {
  const float* grids;  // [S, H, W]
  int h, w;
  const int32_t* grid_index;  // [K] (stride gi_stride) or null: grid 0
  int64_t gi_stride;
  const int32_t* cloud_rows;  // [K] (stride cr_stride) or null: cloud k
  int64_t cr_stride;
  const float* points;  // cloud c, point i at c * pts_lane + i * pts_point
  int64_t pts_lane, pts_point;
  const uint8_t* masks;  // cloud c, point i at c * mask_lane + i
  int64_t mask_lane;
  const float* origins;  // lane k at k * o_stride (x, y)
  int64_t o_stride;
  const float* poses;  // lane k at k * p_stride (x, y, theta)
  int64_t p_stride;
  const float* targets;  // lane k at k * t_stride (x, y)
  int64_t t_stride;
  const float* resolutions;  // lane k at k * r_stride, or null: resolution
  int64_t r_stride;
  float resolution;
  int n;
  float occupied_space_weight, translation_weight, rotation_weight;
  int max_iterations, nonmonotonic;
  float* out;           // [K, 4]: x, y, theta, cost
  int32_t* iterations;  // [K] iterations run, or null
};

// The host's float -> int32 truncation: INT_MIN for NaN or out of range.
__device__ __forceinline__ int to_int(float f) {
  if (!(f >= -2147483648.0f && f < 2147483648.0f)) return INT32_MIN;
  return static_cast<int>(f);
}

__device__ __forceinline__ void cubic_weights(float t, float w[4]) {
  const float t2 = t * t, t3 = t2 * t;
  w[0] = -0.5f * t3 + t2 - 0.5f * t;
  w[1] = 1.5f * t3 - 2.5f * t2 + 1.0f;
  w[2] = -1.5f * t3 + 2.0f * t2 + 0.5f * t;
  w[3] = 0.5f * t3 - 0.5f * t2;
}

__device__ __forceinline__ void cubic_weights_d(float t, float w[4]) {
  const float t2 = t * t;
  w[0] = -1.5f * t2 + 2.0f * t - 0.5f;
  w[1] = 4.5f * t2 - 5.0f * t;
  w[2] = -4.5f * t2 + 4.0f * t + 0.5f;
  w[3] = 1.5f * t2 - t;
}

// The pose state that thread 0 broadcasts.
struct Pose {
  float x, y, theta, c, s;
};

// One point's grid coordinates (u, v) at a pose.
__device__ __forceinline__ void uv_of(const Pose& p, float px, float py,
                                      float ox, float oy, float res, float* u,
                                      float* v) {
  const float wx =
      __fadd_rn(__fsub_rn(__fmul_rn(p.c, px), __fmul_rn(p.s, py)), p.x);
  const float wy =
      __fadd_rn(__fadd_rn(__fmul_rn(p.s, px), __fmul_rn(p.c, py)), p.y);
  *u = __fsub_rn(__fdiv_rn(__fsub_rn(wx, ox), res), 0.5f);
  *v = __fsub_rn(__fdiv_rn(__fsub_rn(wy, oy), res), 0.5f);
}

// The 4 x 4 patch at rows iv - 1 .. iv + 2, columns iu - 1 .. iu + 2.
__device__ __forceinline__ void patch_at(const float* __restrict__ grid,
                                         int h, int w, int iu, int iv,
                                         float patch[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t row = static_cast<int64_t>(iv) + a - 1;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t col = static_cast<int64_t>(iu) + b - 1;
      const bool in = row >= 0 && row < h && col >= 0 && col < w;
      patch[a][b] = in ? __ldg(grid + row * w + col) : kMaxCorrespondenceCost;
    }
  }
}

// Sum v[0..M) over the block in a fixed order; thread 0 gets the totals.
template <int M>
__device__ __forceinline__ void block_sum(float (&v)[M], float* red,
                                          float* total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off /= 2) {
      v[m] += __shfl_xor_sync(kFull, v[m], off);
    }
    if (lane == 0) red[warp * M + m] = v[m];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int warps = blockDim.x / kWarp;
    for (int m = 0; m < M; ++m) {
      float s = 0.0f;
      for (int k = 0; k < warps; ++k) s += red[k * M + m];
      total[m] = s;
    }
  }
  __syncthreads();
}

// Ceres's TrustRegionStepEvaluator (nonmonotonic steps), as
// nonmonotonic_init / _quality / _accepted of the plain version.
struct Evaluator {
  float minimum, reference, candidate, acc_ref, acc_cand;
  int n;
};

__global__ void __launch_bounds__(kMaxThreads) lm_match_2d_kernel(Params p) {
  __shared__ float red[kMaxWarps * 9];
  __shared__ float total[9];
  __shared__ Pose pose_s, cand_s;
  __shared__ float osw_s;
  __shared__ int done_s;

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int grid = p.grid_index ? p.grid_index[k * p.gi_stride] : 0;
  const int cloud = p.cloud_rows ? p.cloud_rows[k * p.cr_stride] : k;
  const float* __restrict__ gridp =
      p.grids + static_cast<int64_t>(grid) * p.h * p.w;
  const float* __restrict__ pts = p.points + cloud * p.pts_lane;
  const uint8_t* __restrict__ msk = p.masks + cloud * p.mask_lane;
  const float ox = p.origins[k * p.o_stride];
  const float oy = p.origins[k * p.o_stride + 1];
  const float res = p.resolutions ? p.resolutions[k * p.r_stride] : p.resolution;
  const float inv_res = 1.0f / res;
  const float* init = p.poses + k * p.p_stride;
  const float tx = p.targets[k * p.t_stride];
  const float ty = p.targets[k * p.t_stride + 1];
  const float tw = p.translation_weight, rw = p.rotation_weight;

  // Valid points -> osw = weight * (1 / sqrt(max(n_valid, 1))), rounded as
  // torch's scalar / tensor (a reciprocal, then a product).
  {
    float count[1] = {0.0f};
    for (int i = tid; i < p.n; i += blockDim.x) count[0] += msk[i] ? 1.0f : 0.0f;
    block_sum<1>(count, red, total);
    if (tid == 0) {
      const float n_valid = fmaxf(total[0], 1.0f);
      osw_s = __fmul_rn(1.0f / sqrtf(n_valid), p.occupied_space_weight);
      pose_s = {init[0], init[1], init[2], cosf(init[2]), sinf(init[2])};
    }
    __syncthreads();
  }
  const float osw = osw_s;

  // Half the squared point residuals' sum at a pose (0 on other threads
  // than 0), before the prior rows.
  auto point_cost = [&](const Pose& at) {
    float acc[1] = {0.0f};
    for (int i = tid; i < p.n; i += blockDim.x) {
      if (!msk[i]) continue;
      const float px = pts[i * p.pts_point], py = pts[i * p.pts_point + 1];
      float u, v, patch[4][4], wu[4], wv[4];
      uv_of(at, px, py, ox, oy, res, &u, &v);
      const int iu = to_int(floorf(u)), iv = to_int(floorf(v));
      patch_at(gridp, p.h, p.w, iu, iv, patch);
      cubic_weights(u - static_cast<float>(iu), wu);
      cubic_weights(v - static_cast<float>(iv), wv);
      float occ = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float row = 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b) row += patch[a][b] * wu[b];
        occ += wv[a] * row;
      }
      const float r = occ * osw;
      acc[0] += r * r;
    }
    block_sum<1>(acc, red, total);
    return total[0];  // meaningful on thread 0
  };
  auto prior_cost = [&](const Pose& at) {
    const float e0 = tw * (at.x - tx), e1 = tw * (at.y - ty);
    const float e2 = rw * (at.theta - init[2]);
    return e0 * e0 + e1 * e1 + e2 * e2;
  };

  float cost = 0.0f, lambda = 1e-4f;
  Evaluator ev;
  {
    const float sq = point_cost(pose_s);
    if (tid == 0) {
      cost = 0.5f * (sq + prior_cost(pose_s));
      ev = {cost, cost, cost, 0.0f, 0.0f, 0};
      done_s = 0;
    }
  }
  int iterations = 0;
  for (int it = 0; it < p.max_iterations; ++it) {
    // J^T J (00, 01, 02, 11, 12, 22) and J^T r at the accepted pose.
    const Pose at = pose_s;
    float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = tid; i < p.n; i += blockDim.x) {
      if (!msk[i]) continue;
      const float px = pts[i * p.pts_point], py = pts[i * p.pts_point + 1];
      float u, v, patch[4][4], wu[4], wv[4], dwu[4], dwv[4];
      uv_of(at, px, py, ox, oy, res, &u, &v);
      const int iu = to_int(floorf(u)), iv = to_int(floorf(v));
      patch_at(gridp, p.h, p.w, iu, iv, patch);
      const float tu = u - static_cast<float>(iu);
      const float tv = v - static_cast<float>(iv);
      cubic_weights(tu, wu);
      cubic_weights(tv, wv);
      cubic_weights_d(tu, dwu);
      cubic_weights_d(tv, dwv);
      float occ = 0.0f, d_du = 0.0f, d_dv = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float row = 0.0f, row_du = 0.0f;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          row += patch[a][b] * wu[b];
          row_du += patch[a][b] * dwu[b];
        }
        occ += wv[a] * row;
        d_du += wv[a] * row_du;
        d_dv += dwv[a] * row;
      }
      const float r = occ * osw;
      d_du *= osw;
      d_dv *= osw;
      const float du_dth = (-at.s * px - at.c * py) * inv_res;
      const float dv_dth = (at.c * px - at.s * py) * inv_res;
      const float j0 = d_du * inv_res, j1 = d_dv * inv_res;
      const float j2 = d_du * du_dth + d_dv * dv_dth;
      acc[0] += j0 * j0;
      acc[1] += j0 * j1;
      acc[2] += j0 * j2;
      acc[3] += j1 * j1;
      acc[4] += j1 * j2;
      acc[5] += j2 * j2;
      acc[6] += j0 * r;
      acc[7] += j1 * r;
      acc[8] += j2 * r;
    }
    block_sum<9>(acc, red, total);
    float delta[3] = {0.0f, 0.0f, 0.0f};
    float jtj[3][3], jtr[3];
    if (tid == 0) {
      // The prior rows: diag(tw, tw, rw) against (tw (x - tx), tw (y -
      // ty), rw (theta - theta0)).
      jtj[0][0] = total[0] + tw * tw;
      jtj[0][1] = jtj[1][0] = total[1];
      jtj[0][2] = jtj[2][0] = total[2];
      jtj[1][1] = total[3] + tw * tw;
      jtj[1][2] = jtj[2][1] = total[4];
      jtj[2][2] = total[5] + rw * rw;
      jtr[0] = total[6] + tw * (tw * (at.x - tx));
      jtr[1] = total[7] + tw * (tw * (at.y - ty));
      jtr[2] = total[8] + rw * (rw * (at.theta - init[2]));
      float a[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          a[i][j] = jtj[i][j] + (i == j ? lambda * jtj[i][i] : 0.0f);
        }
      }
      // solve_spd_small's unrolled Cholesky, n = 3.
      const float l00 = sqrtf(fmaxf(a[0][0], 1e-20f));
      const float l10 = a[1][0] / l00;
      const float l11 = sqrtf(fmaxf(a[1][1] - l10 * l10, 1e-20f));
      const float l20 = a[2][0] / l00;
      const float l21 = (a[2][1] - l20 * l10) / l11;
      const float l22 = sqrtf(fmaxf(a[2][2] - l20 * l20 - l21 * l21, 1e-20f));
      const float y0 = jtr[0] / l00;
      const float y1 = (jtr[1] - l10 * y0) / l11;
      const float y2 = (jtr[2] - l20 * y0 - l21 * y1) / l22;
      const float x2 = y2 / l22;
      const float x1 = (y1 - l21 * x2) / l11;
      const float x0 = (y0 - l10 * x1 - l20 * x2) / l00;
      delta[0] = -x0;
      delta[1] = -x1;
      delta[2] = -x2;
      const float th = at.theta + delta[2];
      cand_s = {at.x + delta[0], at.y + delta[1], th, cosf(th), sinf(th)};
    }
    __syncthreads();
    const Pose cand = cand_s;
    const float sq = point_cost(cand);
    if (tid == 0) {
      const float new_cost = 0.5f * (sq + prior_cost(cand));
      bool accept;
      Evaluator next = ev;
      if (p.nonmonotonic) {
        float jtj_delta[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          jtj_delta[i] = jtj[i][0] * delta[0] + jtj[i][1] * delta[1] +
                         jtj[i][2] * delta[2];
        }
        const float model_cost_change =
            -((jtr[0] * delta[0] + jtr[1] * delta[1] + jtr[2] * delta[2]) +
              0.5f * (delta[0] * jtj_delta[0] + delta[1] * jtj_delta[1] +
                      delta[2] * jtj_delta[2]));
        const float mcc = fmaxf(model_cost_change, 1e-30f);
        const float relative = (cost - new_cost) / mcc;
        const float historical = (ev.reference - new_cost) / (ev.acc_ref + mcc);
        accept = model_cost_change > 0.0f && fmaxf(relative, historical) > 1e-3f;
        if (accept) {
          const bool improved = new_cost < ev.minimum;
          const int n_new = improved ? 0 : ev.n + 1;
          const bool reset_cand = improved || new_cost > ev.candidate;
          const float cand_new = reset_cand ? new_cost : ev.candidate;
          const float acc_cand_new = reset_cand ? 0.0f : ev.acc_cand;
          const bool promote = n_new == kMaxConsecutiveNonmonotonicSteps;
          next.minimum = improved ? new_cost : ev.minimum;
          next.reference = promote ? cand_new : ev.reference;
          next.candidate = cand_new;
          next.acc_ref = (promote ? acc_cand_new : ev.acc_ref) + mcc;
          next.acc_cand = acc_cand_new + mcc;
          next.n = n_new;
        }
      } else {
        accept = new_cost < cost;
      }
      // Ceres-style convergence: relative cost change below the function
      // tolerance, or the trust region collapsed (lambda huge).
      const bool converged =
          (accept && fabsf(cost - new_cost) <= 1e-6f * cost) ||
          (!accept && lambda > 1e3f);
      if (accept) {
        pose_s = cand;
        cost = new_cost;
        lambda = fmaxf(lambda * 0.5f, 1e-12f);
      } else {
        lambda = lambda * 4.0f;
      }
      ev = next;
      done_s = converged;
    }
    __syncthreads();
    iterations = it + 1;
    if (done_s) break;
  }
  if (tid == 0) {
    float* o = p.out + 4 * static_cast<int64_t>(k);
    o[0] = pose_s.x;
    o[1] = pose_s.y;
    o[2] = pose_s.theta;
    o[3] = cost;
    if (p.iterations) p.iterations[k] = iterations;
  }
}

}  // namespace

// K lanes of match_lanes; see Params for the layouts. grid_index,
// cloud_rows and resolutions may be null (grid 0, cloud k, the scalar
// resolution). Returns cudaGetLastError() after the launch.
extern "C" int lm_match_2d(
    const float* grids, int h, int w, const int32_t* grid_index,
    int64_t gi_stride, const int32_t* cloud_rows, int64_t cr_stride,
    const float* points, int64_t pts_lane, int64_t pts_point,
    const uint8_t* masks, int64_t mask_lane, const float* origins,
    int64_t o_stride, const float* poses, int64_t p_stride,
    const float* targets, int64_t t_stride, const float* resolutions,
    int64_t r_stride, float resolution, int k, int n,
    float occupied_space_weight, float translation_weight,
    float rotation_weight, int max_iterations, int nonmonotonic, float* out,
    int32_t* iterations, void* stream) {
  if (h <= 0 || w <= 0 || k < 0 || n < 0 || max_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k == 0) return static_cast<int>(cudaSuccess);
  Params p{grids, h, w, grid_index, gi_stride, cloud_rows, cr_stride,
           points, pts_lane, pts_point, masks, mask_lane, origins, o_stride,
           poses, p_stride, targets, t_stride, resolutions, r_stride,
           resolution, n, occupied_space_weight, translation_weight,
           rotation_weight, max_iterations, nonmonotonic, out, iterations};
  int threads = ((n + kWarp - 1) / kWarp) * kWarp;
  threads = threads < kWarp ? kWarp : (threads > kMaxThreads ? kMaxThreads : threads);
  lm_match_2d_kernel<<<k, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
