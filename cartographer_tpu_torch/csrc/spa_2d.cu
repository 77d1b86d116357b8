// Sparse pose adjustment (SPA) in 2D: one launch runs one whole
// Levenberg-Marquardt iteration of the solve, on one thread block.
//
// Replaces no TPU kernel. The JAX package's solve
// (cartographer_tpu/ops/spa_solver.py `solve` :160, its CG at :330 and
// its LM while_loop at :415) is one XLA program; the port's plain version
// (cartographer_tpu_torch/ops/spa_solver.py, solve_plain) runs it as
// eager PyTorch: about 46 launches a CG step, 64 steps an LM iteration,
// so a solve on the card was bound by the host's launch rate. This kernel
// computes what solve_plain computes, in f32, per launch:
// - linearise every row family at the accepted poses: submap-node rows
//   (Ceres's HuberLoss as an IRLS factor on INTER rows, its derivative
//   folded into the blocks), node-node rows, landmark rows (the start
//   pose interpolated between two nodes) and fixed-frame rows; the Jacobi
//   diagonal diag(J^T J) of the submap-node and node-node rows before the
//   Huber factor, and the gradient J^T r;
// - Ceres's damping clamp(diag, 1e-6, 1e32) / radius, and the damped
//   normal equations by Jacobi-preconditioned CG from 0 with the plain
//   version's stopping rule (||r||^2 <= 1e-12 ||b||^2) and step cap. The
//   plain loop freezes its carry from the first step that fails the rule;
//   this kernel stops there, so the steps it takes are the same ones;
// - the candidate's cost, the model cost change from r0 + J dx, the step
//   quality (plain, or Ceres's nonmonotonic evaluator), accept or reject,
//   the radius and its decrease factor, the convergence test.
// The state (poses, cost, radius, evaluator) stays on the device between
// launches; the host reads five integers after each (converged, a bad
// index, iterations, CG steps, the evaluator's count).
//
// Layout. One block of 512 threads per solve. Rows are strided over the
// threads; each row's two weighted 3 x 3 Jacobian blocks, its residual
// and its indices are written once an iteration to global scratch as
// structure of arrays (22 floats and 3 ints a row) and read back by
// every CG step from L1 / L2. J^T J p is one pass over the rows (u = J_row
// p, then J_row^T u scattered by atomics). The pose vectors (the Jacobi
// diagonal, CG's x, r and p, the product A p, and the free mask) take
// 64 bytes a pose in global scratch at every size, and the scatter adds
// into them by global float atomics, which resolve in L2 (the vectors of
// a graph the benchmark cell's size take 73 KB). A copy of the vectors in
// shared memory, while it fit, was timed and dropped: shared float
// atomicAdd compiles to a compare-and-swap loop on sm_90a
// (ATOMS.CAST.SPIN), so on an H100 a CG step of the cell-sized test graph
// (1,137 poses, 3,999 rows) took 24.8-25.3 us there, even with the rows
// permuted to spread each warp's scatter, against 24.0-24.6 us here, and
// at 768 poses 18.3 against 14.3-14.7 us. Sizes are limited by device
// memory alone (the wrapper caps each table at 2^24 rows).
// The damping and the preconditioner are recomputed from the diagonal
// where they are used. Sums over the block reduce by a warp shuffle tree
// and then over the warps in a fixed order; the atomics' order is not
// fixed, so two runs agree to rounding, as index_add_ on CUDA does.
//
// Bounds on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32), per CG step of
// R rows and P poses: the row data (84 bytes a row) and the vectors (88
// bytes a pose) read or written once: 0.13 us for the cell-sized test
// graph (R 3,999, P 1,137); operations (144 a row, 60 a pose) far below
// that. Neither is the limit: one SM runs a chain of four block barriers
// and two block reductions a step, and the scatter's atomics, which
// serialise where a warp's rows share a submap (consecutive rows).
// chip_smoke.py's spa_2d phase gives the times beside this bound.
//
// Where the result parts from the plain version's: sums in another
// order, the landmark rows' two node blocks applied as A ((1 - f) v_a +
// f v_b) rather than as two blocks, FMA contraction. That is rounding,
// but CG run long amplifies it: on the CPU the plain version in f32 lies
// 4e-4 to 7e-3 from itself in f64 after one LM iteration of 64 CG steps
// on small loop graphs (3e-7 after 4 steps), and where a long solve stops
// is set by rounding too (its convergence test lies below f32's
// resolution of the cost). The card tests hold the kernel to the plain
// version's steps at 4 CG steps an iteration (1e-5) and its converged
// solves to the plain port's parity tolerance (1e-3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kMinDiagonal = 1e-6f;
constexpr float kMaxDiagonal = 1e32f;
constexpr float kMinTrustRegionRadius = 1e-10f;
constexpr float kCgTol2 = 1e-12f;
constexpr int kMaxConsecutiveNonmonotonicSteps = 5;

// The pointer table's order: SpaProblem's fields, SpaExtras' fields,
// then the buffers (kernels/spa_2d.py builds it in this order).
enum Ptr {
  kSubmapPoses, kNodePoses, kFreeSubmap, kFreeNode,
  kCSubmap, kCNode, kCZ, kCWeight, kCHuber, kCMask,
  kNA, kNB, kNZ, kNWeight, kNMask,
  kLPoses, kLFree, kONodeA, kONodeB, kOFactor, kOLandmark, kOZ, kOWeight,
  kOMask, kFPose, kFFree, kGNode, kGTraj, kGZ, kGWeight, kGMask,
  kX, kOut, kStateF, kStateI, kRows, kRowIdx, kVectors,
  kNumPtrs
};
enum Dim { kS, kN, kL, kT, kC, kK, kO, kG, kMaxIterations, kCgIterations,
           kNonmonotonic, kNumDims };
enum StateF { kCost, kRadius, kDecrease, kEvMinimum, kEvReference,
              kEvCandidate, kEvAccRef, kEvAccCand, kStateFloats };
enum StateI { kConverged, kBadIndex, kIterations, kCgSteps, kEvN, kStateInts };
// A row's floats in the row scratch (structure of arrays over R rows).
constexpr int kRowA = 0, kRowB = 9, kRowR = 18, kRowF = 21, kRowFloats = 22;

struct Params {
  const float *submap_poses, *node_poses, *l_poses, *f_pose;
  const uint8_t *free_submap, *free_node, *l_free, *f_free;
  const int32_t *c_submap, *c_node;
  const float *c_z, *c_weight;
  const uint8_t *c_huber, *c_mask;
  const int32_t *n_a, *n_b;
  const float *n_z, *n_weight;
  const uint8_t* n_mask;
  const int32_t *o_node_a, *o_node_b, *o_landmark;
  const float *o_factor, *o_z, *o_weight;
  const uint8_t* o_mask;
  const int32_t *g_node, *g_traj;
  const float *g_z, *g_weight;
  const uint8_t* g_mask;
  float* x;         // [P, 3] the accepted poses
  float* out;       // [P, 3] the accepted poses, angles normalized
  float* state;     // [kStateFloats]
  int32_t* istate;  // [kStateInts]
  float* rows;      // [kRowFloats, R]
  int32_t* row_idx; // [3, R]: start (-1: masked), second node (-1), end
  float* vectors;   // [16 P]: the pose vectors
  int s, n, l, t, c, k, o, g, poses, num_rows;
  int max_iterations, cg_iterations, nonmonotonic, iteration;
  float huber_scale;
};

struct Pose {
  float x, y, t;
};

struct Row {
  int sa, sb, e;  // start (a landmark row's first node), second node or -1, end
  float f;        // a landmark row's interpolation factor
  float z[3], w[3];
  bool huber, diag;
};

// The plain version's _normalize_angle: a - 2 pi ceil((a - pi) / (2 pi)).
__device__ __forceinline__ float normalize_angle(float a) {
  return __fsub_rn(a, __fmul_rn(kTwoPi, ceilf(__fdiv_rn(__fsub_rn(a, kPi), kTwoPi))));
}

// Pose i of the table x, moved by the step dx * free when dx is given.
__device__ __forceinline__ Pose pose_at(const float* x, const float* dx,
                                        const float* fr, int i) {
  Pose q{x[3 * i], x[3 * i + 1], x[3 * i + 2]};
  if (dx != nullptr) {
    const float f = fr[i];
    q.x += dx[3 * i] * f;
    q.y += dx[3 * i + 1] * f;
    q.t += dx[3 * i + 2] * f;
  }
  return q;
}

__device__ __forceinline__ bool in(int i, int n) { return i >= 0 && i < n; }

// Row `row` of the families (submap-node, node-node, landmark, fixed
// frame, in that order) from the tables; false for a masked row. An index
// outside its table sets *bad and drops the row.
__device__ bool load_row(const Params& p, int row, Row& q, int* bad) {
  const float *z, *w;
  bool mask;
  q.sb = -1;
  q.f = 0.0f;
  q.huber = false;
  q.diag = false;
  int i = row;
  if (i < p.c) {
    const int a = p.c_submap[i], b = p.c_node[i];
    if (!in(a, p.s) || !in(b, p.n)) { *bad = 1; return false; }
    q.sa = a;
    q.e = p.s + b;
    q.huber = p.c_huber[i] != 0;
    q.diag = true;
    z = p.c_z + 3 * i;
    w = p.c_weight + 2 * i;
    mask = p.c_mask[i] != 0;
  } else if ((i -= p.c) < p.k) {
    const int a = p.n_a[i], b = p.n_b[i];
    if (!in(a, p.n) || !in(b, p.n)) { *bad = 1; return false; }
    q.sa = p.s + a;
    q.e = p.s + b;
    q.diag = true;
    z = p.n_z + 3 * i;
    w = p.n_weight + 2 * i;
    mask = p.n_mask[i] != 0;
  } else if ((i -= p.k) < p.o) {
    const int a = p.o_node_a[i], b = p.o_node_b[i], m = p.o_landmark[i];
    if (!in(a, p.n) || !in(b, p.n) || !in(m, p.l)) { *bad = 1; return false; }
    q.sa = p.s + a;
    q.sb = p.s + b;
    q.e = p.s + p.n + m;
    q.f = p.o_factor[i];
    z = p.o_z + 3 * i;
    w = p.o_weight + 2 * i;
    mask = p.o_mask[i] != 0;
  } else {
    i -= p.o;
    const int node = p.g_node[i], traj = p.g_traj[i];
    if (!in(node, p.n) || !in(traj, p.t)) { *bad = 1; return false; }
    q.sa = p.s + p.n + p.l + traj;
    q.e = p.s + node;
    z = p.g_z + 3 * i;
    w = p.g_weight + 2 * i;
    mask = p.g_mask[i] != 0;
  }
  if (!mask) return false;
  q.z[0] = z[0];
  q.z[1] = z[1];
  q.z[2] = z[2];
  q.w[0] = q.w[1] = w[0];
  q.w[2] = w[1];
  return true;
}

// The row's start pose: a landmark row's lerps the translation and takes
// the shortest-path angle between its two nodes.
__device__ __forceinline__ Pose start_pose(const Row& q, const float* x,
                                           const float* dx, const float* fr) {
  const Pose a = pose_at(x, dx, fr, q.sa);
  if (q.sb < 0) return a;
  const Pose b = pose_at(x, dx, fr, q.sb);
  const float dth = normalize_angle(b.t - a.t);
  return {a.x + q.f * (b.x - a.x), a.y + q.f * (b.y - a.y), a.t + q.f * dth};
}

// cost_helpers_impl.h ComputeUnscaledError times the row's weights,
// r = w e, and (when wa is given) the weighted blocks WA = diag(w) de/dstart,
// WB = diag(w) de/dend, row-major 3 x 3.
__device__ __forceinline__ void residual(const Row& q, const Pose& st,
                                         const Pose& en, float r[3], float* wa,
                                         float* wb) {
  float s, c;
  sincosf(st.t, &s, &c);
  const float dx = en.x - st.x, dy = en.y - st.y;
  const float h0 = c * dx + s * dy;
  const float h1 = -s * dx + c * dy;
  const float h2 = en.t - st.t;
  r[0] = (q.z[0] - h0) * q.w[0];
  r[1] = (q.z[1] - h1) * q.w[1];
  r[2] = normalize_angle(q.z[2] - h2) * q.w[2];
  if (wa == nullptr) return;
  const float w0 = q.w[0], w1 = q.w[1], w2 = q.w[2];
  wa[0] = c * w0;   wa[1] = s * w0;  wa[2] = -h1 * w0;
  wa[3] = -s * w1;  wa[4] = c * w1;  wa[5] = h0 * w1;
  wa[6] = 0.0f;     wa[7] = 0.0f;    wa[8] = w2;
  wb[0] = -c * w0;  wb[1] = -s * w0; wb[2] = 0.0f;
  wb[3] = s * w1;   wb[4] = -c * w1; wb[5] = 0.0f;
  wb[6] = 0.0f;     wb[7] = 0.0f;    wb[8] = -w2;
}

// Ceres's HuberLoss (a = scale) as the plain version's IRLS factor:
// where |r|^2 > a^2, r <- factor r and (when h is given) h = d(factor r)/dr
// = factor I + 2 factor' r r^T. Returns whether it applied (else the
// factor is 1 and h the identity).
__device__ __forceinline__ bool huber(float r[3], float scale, float* h) {
  const float s = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  const float d2 = scale * scale;
  if (!(s > d2)) return false;
  const float g = (2.0f * scale * sqrtf(s) - d2) / s;
  const float factor = sqrtf(g);
  if (h != nullptr) {
    const float dg = -scale * powf(s, -1.5f) + d2 / (s * s);
    const float df2 = 2.0f * (dg / (2.0f * factor));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        h[3 * i + j] = (i == j ? factor : 0.0f) + df2 * (r[i] * r[j]);
      }
    }
  }
  r[0] *= factor;
  r[1] *= factor;
  r[2] *= factor;
  return true;
}

// m <- h m for row-major 3 x 3 matrices.
__device__ __forceinline__ void left_multiply(const float h[9], float m[9]) {
  float out[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = h[3 * i] * m[j] + h[3 * i + 1] * m[3 + j] + h[3 * i + 2] * m[6 + j];
    }
  }
#pragma unroll
  for (int m_ = 0; m_ < 9; ++m_) m[m_] = out[m_];
}

// The row's residual and blocks from the row scratch.
__device__ __forceinline__ void load_blocks(const float* rows, int64_t nr, int row,
                                            float a[9], float b[9]) {
#pragma unroll
  for (int m = 0; m < 9; ++m) {
    a[m] = rows[(kRowA + m) * nr + row];
    b[m] = rows[(kRowB + m) * nr + row];
  }
}

// u = J_row (v * free): A ((1 - f) v[sa] + f v[sb]) + B v[e] on a landmark
// row, A v[sa] + B v[e] on the others.
__device__ __forceinline__ void jv(const float* v, const float* fr, int sa, int sb,
                                   int e, float f, const float a[9],
                                   const float b[9], float u[3]) {
  float va[3], ve[3];
  const float fa = fr[sa], fe = fr[e];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    va[j] = v[3 * sa + j] * fa;
    ve[j] = v[3 * e + j] * fe;
  }
  if (sb >= 0) {
    const float fb = fr[sb];
#pragma unroll
    for (int j = 0; j < 3; ++j) va[j] = (1.0f - f) * va[j] + f * (v[3 * sb + j] * fb);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u[i] = a[3 * i] * va[0] + a[3 * i + 1] * va[1] + a[3 * i + 2] * va[2] +
           b[3 * i] * ve[0] + b[3 * i + 1] * ve[1] + b[3 * i + 2] * ve[2];
  }
}

// out[sa] += A^T u (a landmark row: (1 - f) A^T u, and f A^T u to sb),
// out[e] += B^T u, by atomics.
__device__ __forceinline__ void jtu(float* out, int sa, int sb, int e, float f,
                                    const float a[9], const float b[9],
                                    const float u[3]) {
  float at[3], bt[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    at[j] = a[j] * u[0] + a[3 + j] * u[1] + a[6 + j] * u[2];
    bt[j] = b[j] * u[0] + b[3 + j] * u[1] + b[6 + j] * u[2];
  }
  if (sb >= 0) {
    const float fa = 1.0f - f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      atomicAdd(out + 3 * sa + j, fa * at[j]);
      atomicAdd(out + 3 * sb + j, f * at[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) atomicAdd(out + 3 * sa + j, at[j]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) atomicAdd(out + 3 * e + j, bt[j]);
}

// Sum v[0..M) over the block: a shuffle tree in each warp, then every
// thread sums the warps in order (the same totals on every thread). `red`
// alternates between two buffers from one call to the next, so one
// barrier a call suffices.
template <int M>
__device__ __forceinline__ void block_sum(float (&v)[M], float* red, float (&total)[M]) {
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
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * M + m];
    total[m] = s;
  }
}

__device__ __forceinline__ float table_pose(const Params& p, int v) {
  const int i = v / 3, j = v - 3 * (v / 3);
  if (i < p.s) return p.submap_poses[3 * i + j];
  if ((i - p.s) < p.n) return p.node_poses[3 * (i - p.s) + j];
  if ((i - p.s - p.n) < p.l) return p.l_poses[3 * (i - p.s - p.n) + j];
  return p.f_pose[3 * (i - p.s - p.n - p.l) + j];
}

__device__ __forceinline__ bool table_free(const Params& p, int i) {
  if (i < p.s) return p.free_submap[i] != 0;
  if ((i - p.s) < p.n) return p.free_node[i - p.s] != 0;
  if ((i - p.s - p.n) < p.l) return p.l_free[i - p.s - p.n] != 0;
  return p.f_free[i - p.s - p.n - p.l] != 0;
}

__device__ __forceinline__ float clamp_diagonal(float d) {
  return fminf(fmaxf(d, kMinDiagonal), kMaxDiagonal);
}

__global__ void __launch_bounds__(kThreads, 1) spa_2d_kernel(Params p) {
  __shared__ float red[2][kWarps * 3];
  __shared__ float st[kStateFloats];
  __shared__ int ist[kStateInts];
  __shared__ int bad_s, accept_s;

  const int tid = threadIdx.x;
  const int np = p.poses, nv = 3 * p.poses, nr = p.num_rows;
  float* vec = p.vectors;
  float* diag = vec;           // diag(J^T J) of the submap-node and node-node rows
  float* cx = vec + nv;        // CG's x
  float* cr = vec + 2 * nv;    // CG's r (first the gradient)
  float* cp = vec + 3 * nv;    // CG's p
  float* ap = vec + 4 * nv;    // the scatter's sums, then A p
  float* fr = vec + 5 * nv;    // [P] 1 for a free pose, else 0
  float* x = p.x;
  float* rows = p.rows;
  int32_t* idx = p.row_idx;
  int flip = 0;

  if (tid == 0) {
    bad_s = 0;
    if (p.iteration > 0) {
      for (int i = 0; i < kStateFloats; ++i) st[i] = p.state[i];
      for (int i = 0; i < kStateInts; ++i) ist[i] = p.istate[i];
    }
  }
  for (int i = tid; i < np; i += kThreads) fr[i] = table_free(p, i) ? 1.0f : 0.0f;

  if (p.iteration == 0) {
    // The solve's start: the tables' poses and their cost.
    for (int v = tid; v < nv; v += kThreads) x[v] = table_pose(p, v);
    __syncthreads();
    float sq[1] = {0.0f}, total[1];
    for (int row = tid; row < nr; row += kThreads) {
      Row q;
      if (!load_row(p, row, q, &bad_s)) continue;
      float r[3];
      residual(q, start_pose(q, x, nullptr, nullptr), pose_at(x, nullptr, nullptr, q.e),
               r, nullptr, nullptr);
      if (q.huber) huber(r, p.huber_scale, nullptr);
      sq[0] += r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    }
    block_sum<1>(sq, red[flip], total);
    flip ^= 1;
    if (tid == 0) {
      const float cost = 0.5f * total[0];
      st[kCost] = cost;
      st[kRadius] = 1e4f;
      st[kDecrease] = 2.0f;
      st[kEvMinimum] = st[kEvReference] = st[kEvCandidate] = cost;
      st[kEvAccRef] = st[kEvAccCand] = 0.0f;
      for (int i = 0; i < kStateInts; ++i) ist[i] = 0;
    }
  }
  __syncthreads();

  const bool iterate = p.iteration < p.max_iterations;
  if (iterate) {
    const float radius = st[kRadius];
    // Linearise: the rows' blocks and residuals, the diagonal, the gradient.
    for (int v = tid; v < nv; v += kThreads) {
      diag[v] = 0.0f;
      cr[v] = 0.0f;
    }
    __syncthreads();
    for (int slot = tid; slot < nr; slot += kThreads) {
      Row q;
      if (!load_row(p, slot, q, &bad_s)) {
        idx[slot] = -1;
        continue;
      }
      float r[3], a[9], b[9], h[9];
      residual(q, start_pose(q, x, nullptr, nullptr), pose_at(x, nullptr, nullptr, q.e),
               r, a, b);
      if (q.diag) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          atomicAdd(diag + 3 * q.sa + j, a[j] * a[j] + a[3 + j] * a[3 + j] + a[6 + j] * a[6 + j]);
          atomicAdd(diag + 3 * q.e + j, b[j] * b[j] + b[3 + j] * b[3 + j] + b[6 + j] * b[6 + j]);
        }
      }
      if (q.huber && huber(r, p.huber_scale, h)) {
        left_multiply(h, a);
        left_multiply(h, b);
      }
#pragma unroll
      for (int m = 0; m < 9; ++m) {
        rows[(kRowA + m) * static_cast<int64_t>(nr) + slot] = a[m];
        rows[(kRowB + m) * static_cast<int64_t>(nr) + slot] = b[m];
      }
#pragma unroll
      for (int m = 0; m < 3; ++m) rows[(kRowR + m) * static_cast<int64_t>(nr) + slot] = r[m];
      rows[kRowF * static_cast<int64_t>(nr) + slot] = q.f;
      idx[slot] = q.sa;
      idx[nr + slot] = q.sb;
      idx[2 * nr + slot] = q.e;
      jtu(cr, q.sa, q.sb, q.e, q.f, a, b, r);
    }
    __syncthreads();

    // CG on (J^T J + D^T D / radius) dx = -J^T r over the free poses (the
    // identity on the held ones), Jacobi-preconditioned, from dx = 0.
    float gamma, rsq, atol2;
    {
      float part[2] = {0.0f, 0.0f}, total[2];
      for (int v = tid; v < nv; v += kThreads) {
        const float f = fr[v / 3];
        const float bv = -(cr[v] * f);
        const float d = diag[v];
        const float pre = f > 0.0f ? d + clamp_diagonal(d) / radius : 1.0f;
        const float z = bv / pre;
        cx[v] = 0.0f;
        cr[v] = bv;
        cp[v] = z;
        ap[v] = 0.0f;
        part[0] += bv * bv;
        part[1] += bv * z;
      }
      block_sum<2>(part, red[flip], total);
      flip ^= 1;
      rsq = total[0];
      atol2 = kCgTol2 * total[0];
      gamma = total[1];
    }
    int steps = 0;
    for (int it = 0; it < p.cg_iterations && rsq > atol2; ++it) {
      ++steps;
      __syncthreads();  // p and the zeroed sums are in place
      for (int slot = tid; slot < nr; slot += kThreads) {
        const int sa = idx[slot];
        if (sa < 0) continue;
        const int sb = idx[nr + slot], e = idx[2 * nr + slot];
        const float f = sb >= 0 ? rows[kRowF * static_cast<int64_t>(nr) + slot] : 0.0f;
        float a[9], b[9], u[3];
        load_blocks(rows, nr, slot, a, b);
        jv(cp, fr, sa, sb, e, f, a, b, u);
        jtu(ap, sa, sb, e, f, a, b, u);
      }
      __syncthreads();
      float pap[1] = {0.0f}, total1[1];
      for (int v = tid; v < nv; v += kThreads) {
        const float f = fr[v / 3];
        const float pv = cp[v], pf = pv * f;
        const float damp = clamp_diagonal(diag[v]) / radius;
        const float av = ap[v] * f + damp * pf + (pv - pf);
        ap[v] = av;
        pap[0] += pv * av;
      }
      block_sum<1>(pap, red[flip], total1);
      flip ^= 1;
      const float alpha = gamma / total1[0];
      float part[2] = {0.0f, 0.0f}, total2[2];
      for (int v = tid; v < nv; v += kThreads) {
        const float f = fr[v / 3];
        const float d = diag[v];
        const float pre = f > 0.0f ? d + clamp_diagonal(d) / radius : 1.0f;
        cx[v] += alpha * cp[v];
        const float rn = cr[v] - alpha * ap[v];
        const float z = rn / pre;
        cr[v] = rn;
        part[0] += rn * z;
        part[1] += rn * rn;
      }
      block_sum<2>(part, red[flip], total2);
      flip ^= 1;
      const float beta = total2[0] / gamma;
      for (int v = tid; v < nv; v += kThreads) {
        const float f = fr[v / 3];
        const float d = diag[v];
        const float pre = f > 0.0f ? d + clamp_diagonal(d) / radius : 1.0f;
        cp[v] = cr[v] / pre + beta * cp[v];
        ap[v] = 0.0f;
      }
      gamma = total2[0];
      rsq = total2[1];
    }
    __syncthreads();  // CG's x is complete

    // The step dx = x_cg * free: the model cost change from r0 + J dx and
    // the cost at x + dx.
    float part[3] = {0.0f, 0.0f, 0.0f}, total[3];
    for (int slot = tid; slot < nr; slot += kThreads) {
      const int sa = idx[slot];
      if (sa < 0) continue;
      const int sb = idx[nr + slot], e = idx[2 * nr + slot];
      const float f = sb >= 0 ? rows[kRowF * static_cast<int64_t>(nr) + slot] : 0.0f;
      float a[9], b[9], u[3];
      load_blocks(rows, nr, slot, a, b);
      jv(cx, fr, sa, sb, e, f, a, b, u);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        part[0] += rows[(kRowR + m) * static_cast<int64_t>(nr) + slot] * u[m];
        part[1] += u[m] * u[m];
      }
      Row q;
      load_row(p, slot, q, &bad_s);
      float r[3];
      residual(q, start_pose(q, x, cx, fr), pose_at(x, cx, fr, q.e), r, nullptr, nullptr);
      if (q.huber) huber(r, p.huber_scale, nullptr);
      part[2] += r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
    }
    block_sum<3>(part, red[flip], total);
    flip ^= 1;

    if (tid == 0) {
      const float cost = st[kCost];
      const float new_cost = 0.5f * total[2];
      const float model_cost_change = -(total[0] + 0.5f * total[1]);
      const bool valid = model_cost_change > 0.0f;
      const float mcc = fmaxf(model_cost_change, 1e-30f);
      float rho;
      if (p.nonmonotonic) {
        const float relative = (cost - new_cost) / mcc;
        const float historical = (st[kEvReference] - new_cost) / (st[kEvAccRef] + mcc);
        rho = fmaxf(relative, historical);
      } else {
        rho = (cost - new_cost) / mcc;
      }
      const bool accept = valid && rho > 1e-3f;  // Ceres min_relative_decrease
      if (p.nonmonotonic && accept) {
        const bool improved = new_cost < st[kEvMinimum];
        const int n_new = improved ? 0 : ist[kEvN] + 1;
        const bool reset_cand = improved || new_cost > st[kEvCandidate];
        const float cand_new = reset_cand ? new_cost : st[kEvCandidate];
        const float acc_cand_new = reset_cand ? 0.0f : st[kEvAccCand];
        const bool promote = n_new == kMaxConsecutiveNonmonotonicSteps;
        if (improved) st[kEvMinimum] = new_cost;
        if (promote) {
          st[kEvReference] = cand_new;
          st[kEvAccRef] = acc_cand_new + mcc;
        } else {
          st[kEvAccRef] = st[kEvAccRef] + mcc;
        }
        st[kEvCandidate] = cand_new;
        st[kEvAccCand] = acc_cand_new + mcc;
        ist[kEvN] = n_new;
      }
      const float t = 2.0f * rho - 1.0f;
      const float shrink = fmaxf(1.0f - t * t * t, 1.0f / 3.0f);
      const float radius_acc = fminf(radius / shrink, 1e16f);
      const float new_radius = accept ? radius_acc : radius / st[kDecrease];
      st[kDecrease] = accept ? 2.0f : st[kDecrease] * 2.0f;
      st[kRadius] = new_radius;
      const bool converged =
          (accept && fabsf(cost - new_cost) <= 1e-7f * cost) ||
          new_radius < kMinTrustRegionRadius;
      if (accept) st[kCost] = new_cost;
      ist[kConverged] = converged;
      ist[kIterations] = p.iteration + 1;
      ist[kCgSteps] += steps;
      accept_s = accept;
    }
    __syncthreads();
  }

  const bool accept = iterate && accept_s;
  for (int v = tid; v < nv; v += kThreads) {
    float xv = x[v];
    if (accept) {
      xv += cx[v] * fr[v / 3];
      x[v] = xv;
    }
    p.out[v] = (v % 3 == 2) ? normalize_angle(xv) : xv;
  }
  if (tid == 0) {
    ist[kBadIndex] |= bad_s;
    for (int i = 0; i < kStateFloats; ++i) p.state[i] = st[i];
    for (int i = 0; i < kStateInts; ++i) p.istate[i] = ist[i];
  }
}

}  // namespace

// One LM iteration of a 2D SPA solve (iteration 0 also sets the solve's
// start from the tables). ptrs: kNumPtrs device pointers in Ptr's order
// (the extras' may be null when their sizes are 0); dims: kNumDims sizes
// and settings in Dim's order. Returns cudaGetLastError() after the launch.
extern "C" int spa_2d(const int64_t* ptrs, const int64_t* dims, float huber_scale,
                      int iteration, void* stream) {
  for (int i = 0; i < kNumDims; ++i) {
    if (dims[i] < 0 || dims[i] > (1 << 24)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (iteration < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return reinterpret_cast<const float*>(ptrs[i]); };
  auto b = [&](int i) { return reinterpret_cast<const uint8_t*>(ptrs[i]); };
  auto n = [&](int i) { return reinterpret_cast<const int32_t*>(ptrs[i]); };
  Params p;
  p.submap_poses = f(kSubmapPoses);
  p.node_poses = f(kNodePoses);
  p.l_poses = f(kLPoses);
  p.f_pose = f(kFPose);
  p.free_submap = b(kFreeSubmap);
  p.free_node = b(kFreeNode);
  p.l_free = b(kLFree);
  p.f_free = b(kFFree);
  p.c_submap = n(kCSubmap);
  p.c_node = n(kCNode);
  p.c_z = f(kCZ);
  p.c_weight = f(kCWeight);
  p.c_huber = b(kCHuber);
  p.c_mask = b(kCMask);
  p.n_a = n(kNA);
  p.n_b = n(kNB);
  p.n_z = f(kNZ);
  p.n_weight = f(kNWeight);
  p.n_mask = b(kNMask);
  p.o_node_a = n(kONodeA);
  p.o_node_b = n(kONodeB);
  p.o_landmark = n(kOLandmark);
  p.o_factor = f(kOFactor);
  p.o_z = f(kOZ);
  p.o_weight = f(kOWeight);
  p.o_mask = b(kOMask);
  p.g_node = n(kGNode);
  p.g_traj = n(kGTraj);
  p.g_z = f(kGZ);
  p.g_weight = f(kGWeight);
  p.g_mask = b(kGMask);
  p.x = reinterpret_cast<float*>(ptrs[kX]);
  p.out = reinterpret_cast<float*>(ptrs[kOut]);
  p.state = reinterpret_cast<float*>(ptrs[kStateF]);
  p.istate = reinterpret_cast<int32_t*>(ptrs[kStateI]);
  p.rows = reinterpret_cast<float*>(ptrs[kRows]);
  p.row_idx = reinterpret_cast<int32_t*>(ptrs[kRowIdx]);
  p.vectors = reinterpret_cast<float*>(ptrs[kVectors]);
  p.s = static_cast<int>(dims[kS]);
  p.n = static_cast<int>(dims[kN]);
  p.l = static_cast<int>(dims[kL]);
  p.t = static_cast<int>(dims[kT]);
  p.c = static_cast<int>(dims[kC]);
  p.k = static_cast<int>(dims[kK]);
  p.o = static_cast<int>(dims[kO]);
  p.g = static_cast<int>(dims[kG]);
  p.poses = p.s + p.n + p.l + p.t;
  p.num_rows = p.c + p.k + p.o + p.g;
  p.max_iterations = static_cast<int>(dims[kMaxIterations]);
  p.cg_iterations = static_cast<int>(dims[kCgIterations]);
  p.nonmonotonic = dims[kNonmonotonic] != 0;
  p.iteration = iteration;
  p.huber_scale = huber_scale;

  spa_2d_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
