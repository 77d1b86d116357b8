// Native loop-closure constraint search: the host-side counterpart of
// the device branch-and-bound, copied from cartographer_tpu/native/
// bnb_native.cc (only this header comment differs).
//
// The reference's fast correlative BnB (pyramid + DFS,
// internal/2d/scan_matching/fast_correlative_scan_matcher_2d.cc:41-378)
// is cache-resident pointer-chasing; here it runs threaded across the
// drained (node, submap) pairs, the fan-out the reference gives its
// ThreadPool (constraint_builder_2d.cc:102-136).
//
// Candidate scoring vectorizes with AVX-512 masked gathers: 16 points
// per instruction, with the bounds check folded into the gather mask
// (masked lanes never touch memory, so out-of-grid points contribute
// 0 == MIN_PROBABILITY exactly like the scalar loop). The pyramid levels
// stay in their compact unpadded layout, and sibling candidates score
// in groups of four sharing one pass over the per-angle discretized
// coordinates. Scores are bit-identical to the scalar path.
//
// Semantics are those of the device matcher: window-start max pooling
// with MIN_PROBABILITY beyond the grid, uint8 quantization, out-of-grid
// scan points score MIN_PROBABILITY.

#include <algorithm>
#include <atomic>
#ifdef __AVX512F__
#include <immintrin.h>
#endif
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

namespace {

constexpr float kMinProbability = 0.1f;
constexpr float kMaxProbability = 0.9f;
constexpr float kU8Scale = 255.0f / (kMaxProbability - kMinProbability);

struct Pyramid {
  int h = 0, w = 0, depth = 0;
  // Each level carries 4 bytes of slack: the AVX-512 path gathers
  // 32-bit words at byte granularity, so the last cell's load overreads
  // 3 bytes.
  std::vector<std::vector<uint8_t>> levels;

  // Lazily-built TOP-LEVEL PATCH TABLE for windowed searches: row
  // (y + nl, x + nl) holds the top-level pooled value at every
  // candidate-lattice offset (x + ox_j, y + oy_j), zero where that
  // lands off-grid. Top-level scoring then reads ONE contiguous
  // 32-byte row per (angle, point) and does ONE SIMD widen+add into 32
  // lane-parallel candidate accumulators — versus 25+ scattered
  // gathers — turning the hottest phase of a match
  // into a streaming pass. Built once per (submap, window) and shared
  // by every search against this submap; windows whose lattice exceeds
  // 32 offsets (full-submap searches, depth < 6 configs) use the
  // legacy gather scorer.
  std::mutex patch_mu;
  std::vector<uint8_t> patch;  // [(h+2nl)*(w+2nl), 32]
  int patch_nl = -1;
  int patch_noff = 0, patch_th = 0, patch_tw = 0;
};

constexpr int kPatchLanes = 32;
constexpr size_t kMaxPatchBytes = 64ull << 20;  // per-submap table cap

// Builds (or reuses) the top-level patch table for window radius nl
// (cells). Returns false when the lattice does not fit kPatchLanes or
// the table would exceed the memory cap.
bool EnsurePatchTable(Pyramid* p, int nl) {
  const int stride = 1 << (p->depth - 1);
  const int noff = (2 * nl) / stride + 1;
  if (noff * noff > kPatchLanes) return false;
  const int th = p->h + 2 * nl, tw = p->w + 2 * nl;
  if (size_t(th) * tw * kPatchLanes > kMaxPatchBytes) return false;
  std::lock_guard<std::mutex> lock(p->patch_mu);
  if (p->patch_nl == nl) return true;
  const auto& pool = p->levels[p->depth - 1];
  p->patch.assign(size_t(th) * tw * kPatchLanes, 0);
  // Candidate push order in Match is x-major then y; offset j maps to
  // (ox, oy) = (offs[j / noff], offs[j % noff]) with offs = -nl + k*stride.
  for (int ty = 0; ty < th; ++ty) {
    const int y = ty - nl;
    for (int j = 0; j < noff * noff; ++j) {
      const int oy = -nl + (j % noff) * stride;
      const int yy = y + oy;
      if (yy < 0 || yy >= p->h) continue;
      const int ox = -nl + (j / noff) * stride;
      const uint8_t* src = pool.data() + size_t(yy) * p->w;
      uint8_t* dst = p->patch.data() + size_t(ty) * tw * kPatchLanes + j;
      // Valid tx range: 0 <= x + ox < w  =>  tx in [nl - ox, nl - ox + w).
      const int tx0 = std::max(0, nl - ox);
      const int tx1 = std::min(tw, nl - ox + p->w);
      for (int tx = tx0; tx < tx1; ++tx)
        dst[size_t(tx) * kPatchLanes] = src[tx - nl + ox];
    }
  }
  p->patch_nl = nl;
  p->patch_noff = noff;
  p->patch_th = th;
  p->patch_tw = tw;
  return true;
}

struct Candidate {
  int angle, x, y;
  float score;
};

struct SearchSpec {
  const Pyramid* pyr;
  const float* points;  // [n, 2]
  int n;
  float ox, oy, resolution;
  float ix, iy, itheta;
  float linear_window, angular_window, min_score;
};

struct Matcher {
  const SearchSpec& s;
  // Flat per-angle discretized coordinates, stride n (one allocation
  // each instead of 3 x num_scans vectors). base = dy*w + dx.
  std::vector<int32_t> dx, dy, base;
  // Per-angle coordinate bounds [minx, maxx, miny, maxy]: a candidate
  // whose whole offset window stays in-grid skips the per-lane bounds
  // masks (the common case for overlapping loop closures).
  std::vector<int32_t> bbox;
  std::vector<float> angles;
  int num_linear = 0;

  explicit Matcher(const SearchSpec& spec) : s(spec) {}

  void DiscretizeScans() {
    float max_range_sq = 0;
    for (int i = 0; i < s.n; ++i) {
      float x = s.points[2 * i], y = s.points[2 * i + 1];
      max_range_sq = std::max(max_range_sq, x * x + y * y);
    }
    float max_range =
        std::max(std::sqrt(max_range_sq), 3.0f * s.resolution);
    float step = (1.0f - 1e-3f) *
                 std::acos(1.0f - s.resolution * s.resolution /
                                      (2.0f * max_range * max_range));
    int num_angular = (int)std::ceil(s.angular_window / step);
    int num_scans = 2 * num_angular + 1;
    angles.resize(num_scans);
    dx.resize(size_t(num_scans) * s.n);
    dy.resize(size_t(num_scans) * s.n);
    base.resize(size_t(num_scans) * s.n);
    bbox.resize(size_t(num_scans) * 4);
    const int w = s.pyr->w;
    const float inv_res = 1.0f / s.resolution;
#ifdef __AVX512F__
    // Deinterleave the [n, 2] point layout once; the per-angle loop is
    // then pure 16-lane rotate/discretize (mul/sub/add in the same
    // order as the scalar path; floor via round-down conversion).
    std::vector<float> px_v(size_t(s.n + 15) & ~size_t(15), 0.0f);
    std::vector<float> py_v(px_v.size(), 0.0f);
    for (int i = 0; i < s.n; ++i) {
      px_v[i] = s.points[2 * i];
      py_v[i] = s.points[2 * i + 1];
    }
#endif
    for (int a = 0; a < num_scans; ++a) {
      angles[a] = (a - num_angular) * step;
      float t = s.itheta + angles[a];
      float c = std::cos(t), sn = std::sin(t);
      int32_t* ax = dx.data() + size_t(a) * s.n;
      int32_t* ay = dy.data() + size_t(a) * s.n;
      int32_t* ab = base.data() + size_t(a) * s.n;
      int32_t mnx = INT32_MAX, mxx = INT32_MIN;
      int32_t mny = INT32_MAX, mxy = INT32_MIN;
      int i = 0;
#ifdef __AVX512F__
      const __m512 vc = _mm512_set1_ps(c);
      const __m512 vs = _mm512_set1_ps(sn);
      const __m512 vix = _mm512_set1_ps(s.ix);
      const __m512 viy = _mm512_set1_ps(s.iy);
      const __m512 vox = _mm512_set1_ps(s.ox);
      const __m512 voy = _mm512_set1_ps(s.oy);
      const __m512 vinv = _mm512_set1_ps(inv_res);
      const __m512i vw = _mm512_set1_epi32(w);
      __m512i vmnx = _mm512_set1_epi32(INT32_MAX);
      __m512i vmxx = _mm512_set1_epi32(INT32_MIN);
      __m512i vmny = _mm512_set1_epi32(INT32_MAX);
      __m512i vmxy = _mm512_set1_epi32(INT32_MIN);
      const int full = s.n & ~15;
      for (; i < full; i += 16) {
        const __m512 px = _mm512_loadu_ps(px_v.data() + i);
        const __m512 py = _mm512_loadu_ps(py_v.data() + i);
        // Same evaluation order as the scalar path below (and the
        // device matcher): rotate + translate, THEN shift by the grid
        // origin and scale — reassociating would flip floor() results
        // at cell boundaries.
        const __m512 wx = _mm512_add_ps(
            _mm512_sub_ps(_mm512_mul_ps(vc, px), _mm512_mul_ps(vs, py)),
            vix);
        const __m512 wy = _mm512_add_ps(
            _mm512_add_ps(_mm512_mul_ps(vs, px), _mm512_mul_ps(vc, py)),
            viy);
        const __m512i gx = _mm512_cvt_roundps_epi32(
            _mm512_mul_ps(_mm512_sub_ps(wx, vox), vinv),
            _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
        const __m512i gy = _mm512_cvt_roundps_epi32(
            _mm512_mul_ps(_mm512_sub_ps(wy, voy), vinv),
            _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
        _mm512_storeu_si512(ax + i, gx);
        _mm512_storeu_si512(ay + i, gy);
        _mm512_storeu_si512(
            ab + i, _mm512_add_epi32(_mm512_mullo_epi32(gy, vw), gx));
        vmnx = _mm512_min_epi32(vmnx, gx);
        vmxx = _mm512_max_epi32(vmxx, gx);
        vmny = _mm512_min_epi32(vmny, gy);
        vmxy = _mm512_max_epi32(vmxy, gy);
      }
      if (i > 0) {
        mnx = _mm512_reduce_min_epi32(vmnx);
        mxx = _mm512_reduce_max_epi32(vmxx);
        mny = _mm512_reduce_min_epi32(vmny);
        mxy = _mm512_reduce_max_epi32(vmxy);
      }
#endif
      for (; i < s.n; ++i) {
        float px = s.points[2 * i], py = s.points[2 * i + 1];
        float wx = c * px - sn * py + s.ix;
        float wy = sn * px + c * py + s.iy;
        ax[i] = (int32_t)std::floor((wx - s.ox) * inv_res);
        ay[i] = (int32_t)std::floor((wy - s.oy) * inv_res);
        ab[i] = ay[i] * w + ax[i];
        mnx = std::min(mnx, ax[i]);
        mxx = std::max(mxx, ax[i]);
        mny = std::min(mny, ay[i]);
        mxy = std::max(mxy, ay[i]);
      }
      bbox[size_t(a) * 4 + 0] = mnx;
      bbox[size_t(a) * 4 + 1] = mxx;
      bbox[size_t(a) * 4 + 2] = mny;
      bbox[size_t(a) * 4 + 3] = mxy;
    }
    num_linear = (int)std::ceil(s.linear_window / s.resolution);
    num_linear = std::min(num_linear, std::max(s.pyr->h, s.pyr->w) + 1);
  }

  float Normalize(int sum) const {
    return (float(sum) / s.n) / kU8Scale + kMinProbability;
  }

  int ScoreScalarTail(int level, const Candidate& c, int i0) const {
    const auto& pool = s.pyr->levels[level];
    const int32_t* sx = dx.data() + size_t(c.angle) * s.n;
    const int32_t* sy = dy.data() + size_t(c.angle) * s.n;
    const int h = s.pyr->h, w = s.pyr->w;
    int sum = 0;
    for (int i = i0; i < s.n; ++i) {
      int x = sx[i] + c.x, y = sy[i] + c.y;
      if (x >= 0 && x < w && y >= 0 && y < h) sum += pool[size_t(y) * w + x];
    }
    return sum;
  }

  // Score a run of 1-8 candidates sharing one angle in a single pass
  // over the discretized coordinates. AVX-512: the in-grid test becomes
  // the gather mask (unsigned compare catches negatives), so lanes off
  // the grid never load and contribute 0; when the angle's whole
  // coordinate bbox plus every candidate offset stays in-grid (the
  // common case for overlapping loop closures) the per-lane bounds
  // masks are skipped entirely. The last partial block runs with a lane
  // mask instead of a scalar tail.
  void ScoreRun(int level, Candidate* cs, int k) const {
    // Guard: cs[0].angle is read below even when every j-loop is empty,
    // so an empty run must not touch the (uninitialized) array.
    if (k <= 0) return;
#ifdef __AVX512F__
    const uint8_t* pool = s.pyr->levels[level].data();
    const size_t astride = size_t(cs[0].angle) * s.n;
    const int32_t* px = dx.data() + astride;
    const int32_t* py = dy.data() + astride;
    const int32_t* pb = base.data() + astride;
    const int n = s.n, w = s.pyr->w, h = s.pyr->h;
    const int32_t* bb = bbox.data() + size_t(cs[0].angle) * 4;
    bool allin = true;
    for (int j = 0; j < k; ++j)
      allin = allin && bb[0] + cs[j].x >= 0 && bb[1] + cs[j].x < w &&
              bb[2] + cs[j].y >= 0 && bb[3] + cs[j].y < h;
    const __m512i m255 = _mm512_set1_epi32(0xFF);
    const __m512i zero = _mm512_setzero_si512();
    __m512i ob[8], acc[8];
    for (int j = 0; j < k; ++j) {
      ob[j] = _mm512_set1_epi32(cs[j].y * w + cs[j].x);
      acc[j] = zero;
    }
    const int full = n & ~15;
    int i = 0;
    if (allin) {
      for (; i < full; i += 16) {
        const __m512i b = _mm512_loadu_si512(pb + i);
        for (int j = 0; j < k; ++j) {
          const __m512i g = _mm512_i32gather_epi32(
              _mm512_add_epi32(b, ob[j]), pool, 1);
          acc[j] = _mm512_add_epi32(acc[j], _mm512_and_si512(g, m255));
        }
      }
    } else {
      const __m512i vw = _mm512_set1_epi32(w);
      const __m512i vh = _mm512_set1_epi32(h);
      __m512i ox[8], oy[8];
      for (int j = 0; j < k; ++j) {
        ox[j] = _mm512_set1_epi32(cs[j].x);
        oy[j] = _mm512_set1_epi32(cs[j].y);
      }
      for (; i < full; i += 16) {
        const __m512i x = _mm512_loadu_si512(px + i);
        const __m512i y = _mm512_loadu_si512(py + i);
        const __m512i b = _mm512_loadu_si512(pb + i);
        for (int j = 0; j < k; ++j) {
          const __mmask16 m = _mm512_cmplt_epu32_mask(
              _mm512_add_epi32(x, ox[j]), vw)
              & _mm512_cmplt_epu32_mask(_mm512_add_epi32(y, oy[j]), vh);
          const __m512i g = _mm512_mask_i32gather_epi32(
              zero, m, _mm512_add_epi32(b, ob[j]), pool, 1);
          acc[j] = _mm512_add_epi32(acc[j], _mm512_and_si512(g, m255));
        }
      }
    }
    if (i < n) {
      // Lane-masked tail (maskz loads also keep the reads inside the
      // coordinate buffers at the last angle).
      const __mmask16 lane = (__mmask16)((1u << (n - i)) - 1u);
      const __m512i x = _mm512_maskz_loadu_epi32(lane, px + i);
      const __m512i y = _mm512_maskz_loadu_epi32(lane, py + i);
      const __m512i b = _mm512_maskz_loadu_epi32(lane, pb + i);
      const __m512i vw = _mm512_set1_epi32(w);
      const __m512i vh = _mm512_set1_epi32(h);
      for (int j = 0; j < k; ++j) {
        const __mmask16 m = lane
            & _mm512_cmplt_epu32_mask(
                _mm512_add_epi32(x, _mm512_set1_epi32(cs[j].x)), vw)
            & _mm512_cmplt_epu32_mask(
                _mm512_add_epi32(y, _mm512_set1_epi32(cs[j].y)), vh);
        const __m512i g = _mm512_mask_i32gather_epi32(
            zero, m, _mm512_add_epi32(b, ob[j]), pool, 1);
        acc[j] = _mm512_add_epi32(acc[j], _mm512_and_si512(g, m255));
      }
    }
    for (int j = 0; j < k; ++j)
      cs[j].score = Normalize(_mm512_reduce_add_epi32(acc[j]));
#else
    for (int j = 0; j < k; ++j)
      cs[j].score = Normalize(ScoreScalarTail(level, cs[j], 0));
#endif
  }

  // Top-level lattice scoring through the patch table: per (angle,
  // point) ONE contiguous 32-byte row load + ONE SIMD widen/add into 32
  // lane-parallel candidate accumulators. Candidates must be in Match's
  // push order (angle-major, then x-major, then y). Scores are
  // bit-identical to ScoreAll: the table encodes the same pooled values
  // with off-grid cells already zero.
  void ScoreTopPatch(std::vector<Candidate>* cands) const {
    const Pyramid* p = s.pyr;
    const int noff = p->patch_noff;
    const int c = noff * noff;
    const int th = p->patch_th, tw = p->patch_tw, nl = p->patch_nl;
    const uint8_t* table = p->patch.data();
    const int num_scans = (int)angles.size();
    int32_t acc[kPatchLanes];
    for (int a = 0; a < num_scans; ++a) {
      const int32_t* sx = dx.data() + size_t(a) * s.n;
      const int32_t* sy = dy.data() + size_t(a) * s.n;
#ifdef __AVX512F__
      __m512i a16 = _mm512_setzero_si512();
      __m512i a32lo = _mm512_setzero_si512();
      __m512i a32hi = _mm512_setzero_si512();
      int since = 0;
      auto flush = [&]() {
        a32lo = _mm512_add_epi32(
            a32lo, _mm512_cvtepu16_epi32(_mm512_castsi512_si256(a16)));
        a32hi = _mm512_add_epi32(
            a32hi,
            _mm512_cvtepu16_epi32(_mm512_extracti64x4_epi64(a16, 1)));
        a16 = _mm512_setzero_si512();
        since = 0;
      };
      for (int i = 0; i < s.n; ++i) {
        const uint32_t py = uint32_t(sy[i] + nl);
        const uint32_t px = uint32_t(sx[i] + nl);
        if (py >= uint32_t(th) || px >= uint32_t(tw)) continue;
        const uint8_t* row =
            table + (size_t(py) * tw + px) * kPatchLanes;
        a16 = _mm512_add_epi16(
            a16,
            _mm512_cvtepu8_epi16(
                _mm256_loadu_si256((const __m256i*)row)));
        if (++since == 250) flush();  // 250 * 255 < 65535
      }
      flush();
      _mm512_storeu_si512(acc, a32lo);
      _mm512_storeu_si512(acc + 16, a32hi);
#else
      std::memset(acc, 0, sizeof(acc));
      for (int i = 0; i < s.n; ++i) {
        const uint32_t py = uint32_t(sy[i] + nl);
        const uint32_t px = uint32_t(sx[i] + nl);
        if (py >= uint32_t(th) || px >= uint32_t(tw)) continue;
        const uint8_t* row =
            table + (size_t(py) * tw + px) * kPatchLanes;
        for (int j = 0; j < c; ++j) acc[j] += row[j];
      }
#endif
      Candidate* out = cands->data() + size_t(a) * c;
      for (int j = 0; j < c; ++j) out[j].score = Normalize(acc[j]);
    }
  }

  // Score candidates grouped into same-angle runs (angle-major input).
  void ScoreAll(int level, std::vector<Candidate>* cands) const {
    size_t i = 0;
    const size_t m = cands->size();
    while (i < m) {
      size_t j = i + 1;
      while (j < m && j - i < 8 && (*cands)[j].angle == (*cands)[i].angle)
        ++j;
      ScoreRun(level, cands->data() + i, int(j - i));
      i = j;
    }
  }

  float BranchAndBound(const Candidate* cands, int count, int level,
                       float best, Candidate* best_cand) const {
    for (int ci = 0; ci < count; ++ci) {
      const Candidate& c = cands[ci];
      if (c.score <= best) break;
      if (level == 0) {
        best = c.score;
        *best_cand = c;
        continue;
      }
      int half = 1 << (level - 1);
      Candidate children[4];
      int m = 0;
      for (int k = 0; k < 4; ++k) {
        int cx = c.x + (k & 1 ? half : 0);
        int cy = c.y + (k & 2 ? half : 0);
        if (cx > num_linear || cy > num_linear) continue;
        children[m++] = {c.angle, cx, cy, 0};
      }
      ScoreRun(level - 1, children, m);
      // Insertion sort, descending (m <= 4).
      for (int j = 1; j < m; ++j) {
        Candidate t = children[j];
        int k2 = j - 1;
        while (k2 >= 0 && children[k2].score < t.score) {
          children[k2 + 1] = children[k2];
          --k2;
        }
        children[k2 + 1] = t;
      }
      best = BranchAndBound(children, m, level - 1, best, best_cand);
    }
    return best;
  }

  // Returns score; out_pose = (x, y, theta) in world coords; angle < 0
  // means no candidate beat min_score.
  float Match(float* out_pose, int* found) {
    DiscretizeScans();
    const int depth = s.pyr->depth;
    int stride = 1 << (depth - 1);
    std::vector<Candidate> top;
    top.reserve(size_t(angles.size()) *
                ((2 * num_linear) / stride + 1) *
                ((2 * num_linear) / stride + 1));
    for (int a = 0; a < (int)angles.size(); ++a)
      for (int x = -num_linear; x <= num_linear; x += stride)
        for (int y = -num_linear; y <= num_linear; y += stride)
          top.push_back({a, x, y, 0});
    if (EnsurePatchTable(const_cast<Pyramid*>(s.pyr), num_linear))
      ScoreTopPatch(&top);
    else
      ScoreAll(depth - 1, &top);
    // Incumbent seeding: every candidate's (x, y) is itself a valid
    // leaf, so scoring the most promising top-level candidates at FULL
    // resolution yields true lower bounds before the DFS starts —
    // exactly the device matcher's leaf probe (fast_correlative_2d.py
    // probe_and_update). The DFS then prunes against a near-final
    // incumbent instead of growing one from min_score. Exactness is
    // untouched (the incumbent is a real leaf score).
    Candidate seeded{-1, 0, 0, 0};
    float seed_score = s.min_score;
    {
      constexpr int kProbe = 8;
      Candidate probe[kProbe];
      int np = 0;
      for (const Candidate& c : top) {
        if (np < kProbe) {
          probe[np++] = c;
          if (np == kProbe)
            std::sort(probe, probe + kProbe,
                      [](const Candidate& a, const Candidate& b) {
                        return a.score > b.score;
                      });
        } else if (c.score > probe[kProbe - 1].score) {
          int j = kProbe - 1;
          while (j > 0 && probe[j - 1].score < c.score) {
            probe[j] = probe[j - 1];
            --j;
          }
          probe[j] = c;
        }
      }
      for (int j = 0; j < np; ++j) {
        Candidate leaf = probe[j];
        ScoreRun(0, &leaf, 1);
        if (leaf.score > seed_score) {
          seed_score = leaf.score;
          seeded = leaf;
        }
      }
    }
    // Max-heap with lazy pops instead of a full sort: BnB consumes the
    // top candidates in descending-score order only until one scores
    // below the best leaf, which is typically a tiny prefix of the
    // thousands of top-level candidates (same consumption order as the
    // sorted loop; ties are unordered in both).
    const auto heap_less = [](const Candidate& a, const Candidate& b) {
      return a.score < b.score;
    };
    std::make_heap(top.begin(), top.end(), heap_less);
    Candidate best = seeded;
    float score = seed_score;
    while (!top.empty()) {
      std::pop_heap(top.begin(), top.end(), heap_less);
      const Candidate c = top.back();
      top.pop_back();
      if (c.score <= score) break;
      score = BranchAndBound(&c, 1, depth - 1, score, &best);
    }
    *found = best.angle >= 0 ? 1 : 0;
    if (best.angle >= 0) {
      out_pose[0] = s.ix + best.x * s.resolution;
      out_pose[1] = s.iy + best.y * s.resolution;
      out_pose[2] = s.itheta + angles[best.angle];
    } else {
      out_pose[0] = out_pose[1] = out_pose[2] = 0.0f;
    }
    return score;
  }
};

}  // namespace

extern "C" {

// Build a pyramid from a probability grid (unknown -> 0.1). Returns an
// opaque handle; destroy with bnb_pyramid_destroy.
void* bnb_pyramid_create(const float* prob, int h, int w, int depth) {
  auto* p = new Pyramid();
  p->h = h;
  p->w = w;
  p->depth = depth;
  p->levels.resize(depth);
  const size_t cells = size_t(h) * w;
  p->levels[0].assign(cells + 4, 0);  // +4: gather overread slack
  for (size_t i = 0; i < cells; ++i) {
    float q = std::round((prob[i] - kMinProbability) * kU8Scale);
    p->levels[0][i] = (uint8_t)std::min(255.0f, std::max(0.0f, q));
  }
  std::vector<uint8_t> row(cells);
  for (int l = 1; l < depth; ++l) {
    const int shift = 1 << (l - 1);
    const auto& prev = p->levels[l - 1];
    auto& cur = p->levels[l];
    cur.assign(cells + 4, 0);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        uint8_t a = prev[size_t(y) * w + x];
        uint8_t b = (x + shift < w) ? prev[size_t(y) * w + x + shift] : 0;
        row[size_t(y) * w + x] = std::max(a, b);
      }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        uint8_t a = row[size_t(y) * w + x];
        uint8_t b = (y + shift < h) ? row[size_t(y + shift) * w + x] : 0;
        cur[size_t(y) * w + x] = std::max(a, b);
      }
  }
  return p;
}

void bnb_pyramid_destroy(void* handle) { delete (Pyramid*)handle; }

// Batch of independent searches fanned across threads.
//   pyramids:   [n] handles (may repeat)
//   clouds:     concatenated [*, 2] f32 gravity-aligned points (UNIQUE
//               clouds — many searches may point into the same one)
//   offsets:    [n] start offsets into clouds (in points; may repeat)
//   counts:     [n] point counts per search
//   params:     [n, 9] f32: origin_x, origin_y, resolution, init_x,
//               init_y, init_theta, linear_window, angular_window,
//               min_score
//   out:        [n, 4] f32: score, x, y, theta
//   out_found:  [n] i32
void bnb_match_batch(void** pyramids, int n, const float* clouds,
                     const int64_t* offsets, const int32_t* counts,
                     const float* params, float* out, int32_t* out_found,
                     int num_threads) {
  // Submap-grouped processing order: drains arrive node-major (each
  // node against many submaps), which would alternate pyramids and
  // patch tables in cache every search; grouping by pyramid keeps one
  // submap's tables hot across consecutive searches.
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return pyramids[a] < pyramids[b];
  });
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int oi = next.fetch_add(1);
      if (oi >= n) return;
      const int i = order[oi];
      const float* pr = params + size_t(i) * 9;
      SearchSpec spec{
          (const Pyramid*)pyramids[i],
          clouds + 2 * offsets[i],
          counts[i],
          pr[0], pr[1], pr[2], pr[3], pr[4], pr[5], pr[6], pr[7], pr[8],
      };
      Matcher m(spec);
      int found = 0;
      float score = m.Match(out + size_t(i) * 4 + 1, &found);
      out[size_t(i) * 4] = score;
      out_found[i] = found;
    }
  };
  int t = std::max(1, num_threads);
  std::vector<std::thread> threads;
  threads.reserve(t - 1);
  for (int k = 1; k < t; ++k) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
