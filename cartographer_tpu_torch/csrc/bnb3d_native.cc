// Native 3D loop-closure constraint search: the host-side counterpart of
// the device branch-and-bound (ops/scan_matching/fast_correlative_3d.py),
// copied from cartographer_tpu/native/bnb3d_native.cc. Only this header
// comment and the guard at the top of ScoreRun differ.
//
// The reference's FastCorrelativeScanMatcher3D
// (internal/3d/scan_matching/fast_correlative_scan_matcher_3d.cc:112-444,
// precomputation_grid_3d.cc:54-85, low_resolution_matcher.cc) runs a
// yaw-pruned DFS branch-and-bound over (yaw, x, y, z) with a
// low-resolution leaf veto. The search is cache-resident pointer-chasing;
// here it runs threaded across the drained (node, submap) pairs while the
// refinement stays on the device.
//
// Semantics are those of the device matcher: octave max pyramids (level
// l = max over 2^l cubes, half resolution per level), admissible bound
// for an unaligned candidate window = max over the 2x2x2 octave
// neighborhood, uint8 quantization, cells = round((world - origin)/res),
// low-resolution veto at leaves (cells = floor(base + off*ratio + 0.5)),
// and the same asymmetric top-level lattice. Yaw candidates arrive
// PRE-PRUNED by the rotational histogram (host Python, like the device
// path's _prepare).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

namespace {

constexpr float kMinProbability = 0.1f;
constexpr float kMaxProbability = 0.9f;
constexpr float kU8Scale = 255.0f / (kMaxProbability - kMinProbability);

struct Vol {
  int d = 0, h = 0, w = 0;
  // 4 bytes of tail slack: the AVX-512 path gathers 32-bit words at
  // byte granularity, so the last valid byte index may read 3 bytes
  // past it (see AddGatherSlack).
  std::vector<uint8_t> v;
  uint8_t at(int z, int y, int x) const {
    if (uint32_t(z) >= uint32_t(d) || uint32_t(y) >= uint32_t(h) ||
        uint32_t(x) >= uint32_t(w))
      return 0;
    return v[(size_t(z) * h + y) * w + x];
  }
};

void AddGatherSlack(Vol* vol) {
  vol->v.resize(size_t(vol->d) * vol->h * vol->w + 4, 0);
}

struct Submap3 {
  int depth = 0;
  int full_depth = 0;  // levels [0, full_depth) use full_levels
  int pad = 0;         // low-side padding of full_levels (cells)
  int pad_max = 0;     // low-side padding of the coarse levels (cells)
  // Mirrors the reference's PrecomputationGridStack3D
  // (precomputation_grid_3d.cc): the first full_resolution_depth levels
  // are FULL-RESOLUTION window-start max pools (level l cell = max over
  // the 2^l cube starting there); deeper levels subsample the span-2^l
  // window pool by k = l - full_depth + 1 octaves, so ONE read at
  // ((cell + pad_max) >> k) bounds the whole candidate window (the
  // coarse cell is the max over every window start it contains). All
  // levels are built on a low-side-padded domain so windows whose start
  // lies just off-grid still see their in-grid cells — the bounds stay
  // admissible at grid edges, hence search RESULTS are identical to the
  // device matcher's octave-neighborhood formulation; only the work
  // (ONE read per point at every level) differs.
  std::vector<Vol> full_levels;    // [full_depth], pad-padded coords
  std::vector<Vol> coarse_levels;  // [depth], pad_max-padded, subsampled
  Vol low;                         // low-res probability volume
};

// Window-start doubling on the padded domain: out = max(in, in shifted
// by `shift` along each axis); reads beyond the domain are 0.
Vol PoolWindowDouble(const Vol& in, int shift) {
  Vol out = in;
  auto pass = [&](int dz, int dy, int dx) {
    Vol next = out;
    for (int z = 0; z < out.d; ++z)
      for (int y = 0; y < out.h; ++y) {
        uint8_t* dst = next.v.data() + (size_t(z) * out.h + y) * out.w;
        for (int x = 0; x < out.w; ++x) {
          const uint8_t b = out.at(z + dz, y + dy, x + dx);
          if (b > dst[x]) dst[x] = b;
        }
      }
    out = std::move(next);
  };
  pass(0, 0, shift);
  pass(0, shift, 0);
  pass(shift, 0, 0);
  return out;
}

// Embed `in` into a volume padded by `pad` cells on the LOW side of
// each axis.
Vol PadLow(const Vol& in, int pad) {
  Vol out;
  out.d = in.d + pad;
  out.h = in.h + pad;
  out.w = in.w + pad;
  out.v.assign(size_t(out.d) * out.h * out.w, 0);
  for (int z = 0; z < in.d; ++z)
    for (int y = 0; y < in.h; ++y)
      std::memcpy(
          out.v.data() +
              (size_t(z + pad) * out.h + (y + pad)) * out.w + pad,
          in.v.data() + (size_t(z) * in.h + y) * in.w, in.w);
  return out;
}

// Reduce the low-side padding of `in` from `from_pad` to `to_pad`.
Vol CropPad(const Vol& in, int from_pad, int to_pad) {
  const int cut = from_pad - to_pad;
  Vol out;
  out.d = in.d - cut;
  out.h = in.h - cut;
  out.w = in.w - cut;
  out.v.resize(size_t(out.d) * out.h * out.w);
  for (int z = 0; z < out.d; ++z)
    for (int y = 0; y < out.h; ++y)
      std::memcpy(
          out.v.data() + (size_t(z) * out.h + y) * out.w,
          in.v.data() +
              (size_t(z + cut) * in.h + (y + cut)) * in.w + cut,
          out.w);
  return out;
}

Vol Quantize(const float* prob, int d, int h, int w) {
  Vol out;
  out.d = d;
  out.h = h;
  out.w = w;
  out.v.resize(size_t(d) * h * w);
  for (size_t i = 0; i < out.v.size(); ++i) {
    float q = std::round((prob[i] - kMinProbability) * kU8Scale);
    out.v[i] = (uint8_t)std::min(255.0f, std::max(0.0f, q));
  }
  return out;
}

Vol PoolOctave(const Vol& in) {
  Vol out;
  out.d = (in.d + 1) / 2;
  out.h = (in.h + 1) / 2;
  out.w = (in.w + 1) / 2;
  out.v.assign(size_t(out.d) * out.h * out.w, 0);
  for (int z = 0; z < in.d; ++z)
    for (int y = 0; y < in.h; ++y) {
      const uint8_t* src = in.v.data() + (size_t(z) * in.h + y) * in.w;
      uint8_t* dst =
          out.v.data() + (size_t(z / 2) * out.h + y / 2) * out.w;
      for (int x = 0; x < in.w; ++x) {
        uint8_t& cell = dst[x / 2];
        cell = std::max(cell, src[x]);
      }
    }
  return out;
}

struct Candidate {
  int a, x, y, z;
  float score;
};

struct SearchSpec {
  const Submap3* sm;
  const float* high;  // [n, 3] node-frame high-res cloud
  int n;
  const float* low_pts;  // [nl, 3]
  int nl;
  const float* angles;  // [na] candidate yaws (pre-pruned)
  int na;
  float q0[4], t0[3];
  float origin[3], res;
  float lorigin[3], lres;
  int nl_xy, nl_z;
  float min_score, min_low;
  bool seed = true;
  bool simd = true;  // false pins the scalar scoring path (bench anchor)
};

struct Matcher3 {
  const SearchSpec& s;
  // Per-angle discretized high-res cells, stride n (x, y, z planes).
  std::vector<int32_t> cx, cy, cz;
  // Per-angle linear base index into the (shared-shape) full-res
  // levels at candidate (0,0,0): fb = ((az+pad)*Hf + ay+pad)*Wf +
  // ax+pad — a candidate offsets every lane by ONE constant, so the
  // AVX-512 path is one vector load + gather + add per 16 points.
  std::vector<int32_t> fb;
  // Per-angle coordinate bbox (min/max of ax, ay, az): when the whole
  // bbox plus a candidate offset stays in-grid the per-lane bounds
  // masks are skipped.
  std::vector<int32_t> bbox;  // [na, 6]: mnx, mxx, mny, mxy, mnz, mxz
  // Per-angle fractional low-res base cells (lazy; leaf evals only).
  std::vector<float> lbx, lby, lbz;
  std::vector<uint8_t> low_ready;
  float ratio;

  explicit Matcher3(const SearchSpec& spec) : s(spec) {
    ratio = s.res / s.lres;
  }

  // q = quat(yaw about z, half-angle) * q0 — same composition order and
  // float32 arithmetic as the device search (bnb_search_3d).
  void AngleQuat(int a, float* q) const {
    const float half = 0.5f * s.angles[a];
    const float cw = std::cos(half), sz = std::sin(half);
    const float w2 = s.q0[0], x2 = s.q0[1], y2 = s.q0[2], z2 = s.q0[3];
    q[0] = cw * w2 - sz * z2;
    q[1] = cw * x2 - sz * y2;
    q[2] = cw * y2 + sz * x2;
    q[3] = cw * z2 + sz * w2;
  }

  // v + qw * (2 qv x v) + qv x (2 qv x v)  (rigid3.quat_rotate).
  static void Rotate(const float* q, const float* v, float* out) {
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const float tx = 2.0f * (qy * v[2] - qz * v[1]);
    const float ty = 2.0f * (qz * v[0] - qx * v[2]);
    const float tz = 2.0f * (qx * v[1] - qy * v[0]);
    out[0] = v[0] + qw * tx + (qy * tz - qz * ty);
    out[1] = v[1] + qw * ty + (qz * tx - qx * tz);
    out[2] = v[2] + qw * tz + (qx * ty - qy * tx);
  }

  void Discretize() {
    cx.resize(size_t(s.na) * s.n);
    cy.resize(size_t(s.na) * s.n);
    cz.resize(size_t(s.na) * s.n);
    fb.resize(size_t(s.na) * s.n);
    bbox.resize(size_t(s.na) * 6);
    lbx.resize(size_t(s.na) * s.nl);
    lby.resize(size_t(s.na) * s.nl);
    lbz.resize(size_t(s.na) * s.nl);
    low_ready.assign(s.na, 0);
    const float inv = 1.0f / s.res;
    const int pad = s.sm->pad;
    const Vol& f0 = s.sm->full_levels[0];
    const int Hf = f0.h, Wf = f0.w;
    for (int a = 0; a < s.na; ++a) {
      float q[4];
      AngleQuat(a, q);
      int32_t* ax = cx.data() + size_t(a) * s.n;
      int32_t* ay = cy.data() + size_t(a) * s.n;
      int32_t* az = cz.data() + size_t(a) * s.n;
      int32_t* ab = fb.data() + size_t(a) * s.n;
      int32_t mn[3] = {INT32_MAX, INT32_MAX, INT32_MAX};
      int32_t mx[3] = {INT32_MIN, INT32_MIN, INT32_MIN};
      for (int i = 0; i < s.n; ++i) {
        float wpt[3];
        Rotate(q, s.high + 3 * i, wpt);
        ax[i] = (int32_t)std::floor(
            (wpt[0] + s.t0[0] - s.origin[0]) * inv + 0.5f);
        ay[i] = (int32_t)std::floor(
            (wpt[1] + s.t0[1] - s.origin[1]) * inv + 0.5f);
        az[i] = (int32_t)std::floor(
            (wpt[2] + s.t0[2] - s.origin[2]) * inv + 0.5f);
        ab[i] = ((az[i] + pad) * Hf + (ay[i] + pad)) * Wf + (ax[i] + pad);
        mn[0] = std::min(mn[0], ax[i]);
        mx[0] = std::max(mx[0], ax[i]);
        mn[1] = std::min(mn[1], ay[i]);
        mx[1] = std::max(mx[1], ay[i]);
        mn[2] = std::min(mn[2], az[i]);
        mx[2] = std::max(mx[2], az[i]);
      }
      int32_t* bb = bbox.data() + size_t(a) * 6;
      bb[0] = mn[0];
      bb[1] = mx[0];
      bb[2] = mn[1];
      bb[3] = mx[1];
      bb[4] = mn[2];
      bb[5] = mx[2];
    }
  }

  void EnsureLowBase(int a) {
    if (low_ready[a]) return;
    low_ready[a] = 1;
    float q[4];
    AngleQuat(a, q);
    const float inv = 1.0f / s.lres;
    float* bx = lbx.data() + size_t(a) * s.nl;
    float* by = lby.data() + size_t(a) * s.nl;
    float* bz = lbz.data() + size_t(a) * s.nl;
    for (int i = 0; i < s.nl; ++i) {
      float wpt[3];
      Rotate(q, s.low_pts + 3 * i, wpt);
      bx[i] = (wpt[0] + s.t0[0] - s.lorigin[0]) * inv;
      by[i] = (wpt[1] + s.t0[1] - s.lorigin[1]) * inv;
      bz[i] = (wpt[2] + s.t0[2] - s.lorigin[2]) * inv;
    }
  }

  float Normalize(int sum, int count) const {
    return (float(sum) / std::max(count, 1)) / kU8Scale + kMinProbability;
  }

  // High-resolution score of candidate c at pyramid `level` (0 = leaf).
  // For level > 0 the admissible bound is the max over the 2x2x2 octave
  // neighborhood of each (unaligned) shifted cell — identical to the
  // device matcher's _score_cands_3d.
  float Score(int level, const Candidate& c) const {
    const int32_t* ax = cx.data() + size_t(c.a) * s.n;
    const int32_t* ay = cy.data() + size_t(c.a) * s.n;
    const int32_t* az = cz.data() + size_t(c.a) * s.n;
    int sum = 0;
    if (level < s.sm->full_depth) {
      // Full-resolution window-start pool (padded coords): one read
      // per point.
      const Vol& vol = s.sm->full_levels[level];
      const int pad = s.sm->pad;
      for (int i = 0; i < s.n; ++i)
        sum += vol.at(az[i] + c.z + pad, ay[i] + c.y + pad,
                      ax[i] + c.x + pad);
      return Normalize(sum, s.n);
    }
    // Subsampled window pool: one read at the padded coarse cell.
    const int k = level - s.sm->full_depth + 1;
    const int pm = s.sm->pad_max;
    const Vol& vol = s.sm->coarse_levels[level];
    for (int i = 0; i < s.n; ++i)
      sum += vol.at((az[i] + c.z + pm) >> k, (ay[i] + c.y + pm) >> k,
                    (ax[i] + c.x + pm) >> k);
    return Normalize(sum, s.n);
  }

  // Score a run of 1-8 candidates sharing ONE angle in a single pass
  // over the discretized coordinates (same design as the 2D backend's
  // ScoreRun): the per-point coordinate/base loads amortize across the
  // sibling candidates, bounds checks become gather masks (unsigned
  // compares catch negatives), and when the angle's coordinate bbox
  // plus every candidate offset stays in-grid the per-lane masks are
  // skipped entirely. Integer sums — results identical to Score().
  void ScoreRun(int level, Candidate* cs, int k) const {
    if (k <= 0) return;
    // The vector path holds at most 8 candidates in fixed arrays and reads
    // the coordinate tables of cs[0].a only: any other run is scored one
    // candidate at a time (the same integer sums).
    bool one_run = k <= 8;
    for (int j = 1; one_run && j < k; ++j) one_run = cs[j].a == cs[0].a;
    if (!one_run) {
      for (int j = 0; j < k; ++j) cs[j].score = Score(level, cs[j]);
      return;
    }
#ifdef __AVX512F__
    if (!s.simd) {
      for (int j = 0; j < k; ++j) cs[j].score = Score(level, cs[j]);
      return;
    }
    const int a = cs[0].a;
    const int32_t* ax = cx.data() + size_t(a) * s.n;
    const int32_t* ay = cy.data() + size_t(a) * s.n;
    const int32_t* az = cz.data() + size_t(a) * s.n;
    const int32_t* bb = bbox.data() + size_t(a) * 6;
    const int n = s.n;
    const int full = n & ~15;
    const __m512i m255 = _mm512_set1_epi32(0xFF);
    const __m512i zero = _mm512_setzero_si512();
    __m512i acc[8];
    for (int j = 0; j < k; ++j) acc[j] = zero;
    int sums[8] = {0};
    if (level < s.sm->full_depth) {
      const Vol& vol = s.sm->full_levels[level];
      const uint8_t* pool = vol.v.data();
      const int pad = s.sm->pad;
      const int Df = vol.d, Hf = vol.h, Wf = vol.w;
      const int32_t* pb = fb.data() + size_t(a) * s.n;
      bool allin = true;
      for (int j = 0; j < k; ++j)
        allin = allin && bb[0] + cs[j].x + pad >= 0 &&
                bb[1] + cs[j].x + pad < Wf &&
                bb[2] + cs[j].y + pad >= 0 &&
                bb[3] + cs[j].y + pad < Hf &&
                bb[4] + cs[j].z + pad >= 0 &&
                bb[5] + cs[j].z + pad < Df;
      __m512i ob[8];
      for (int j = 0; j < k; ++j)
        ob[j] = _mm512_set1_epi32(
            (cs[j].z * Hf + cs[j].y) * Wf + cs[j].x);
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
        if (i < n) {
          const __mmask16 lanes = (__mmask16)((1u << (n - i)) - 1u);
          const __m512i b = _mm512_maskz_loadu_epi32(lanes, pb + i);
          for (int j = 0; j < k; ++j) {
            const __m512i g = _mm512_mask_i32gather_epi32(
                zero, lanes, _mm512_add_epi32(b, ob[j]), pool, 1);
            acc[j] = _mm512_add_epi32(acc[j], _mm512_and_si512(g, m255));
          }
        }
      } else {
        const __m512i vw = _mm512_set1_epi32(Wf);
        const __m512i vh = _mm512_set1_epi32(Hf);
        const __m512i vd = _mm512_set1_epi32(Df);
        __m512i ox[8], oy[8], oz[8];
        for (int j = 0; j < k; ++j) {
          ox[j] = _mm512_set1_epi32(cs[j].x + pad);
          oy[j] = _mm512_set1_epi32(cs[j].y + pad);
          oz[j] = _mm512_set1_epi32(cs[j].z + pad);
        }
        for (; i < n; i += 16) {
          const __mmask16 lanes =
              i + 16 <= n ? (__mmask16)0xFFFF
                          : (__mmask16)((1u << (n - i)) - 1u);
          const __m512i x = _mm512_maskz_loadu_epi32(lanes, ax + i);
          const __m512i y = _mm512_maskz_loadu_epi32(lanes, ay + i);
          const __m512i z = _mm512_maskz_loadu_epi32(lanes, az + i);
          const __m512i b = _mm512_maskz_loadu_epi32(lanes, pb + i);
          for (int j = 0; j < k; ++j) {
            const __mmask16 m =
                lanes &
                _mm512_cmplt_epu32_mask(_mm512_add_epi32(x, ox[j]), vw) &
                _mm512_cmplt_epu32_mask(_mm512_add_epi32(y, oy[j]), vh) &
                _mm512_cmplt_epu32_mask(_mm512_add_epi32(z, oz[j]), vd);
            const __m512i g = _mm512_mask_i32gather_epi32(
                zero, m, _mm512_add_epi32(b, ob[j]), pool, 1);
            acc[j] = _mm512_add_epi32(acc[j], _mm512_and_si512(g, m255));
          }
        }
      }
    } else {
      // Subsampled coarse level: per-axis pad_max shift + arithmetic
      // right shift by the octave count, then mul-add linearization.
      const int ks = level - s.sm->full_depth + 1;
      const int pm = s.sm->pad_max;
      const Vol& vol = s.sm->coarse_levels[level];
      const uint8_t* pool = vol.v.data();
      const __m512i vw = _mm512_set1_epi32(vol.w);
      const __m512i vh = _mm512_set1_epi32(vol.h);
      const __m512i vd = _mm512_set1_epi32(vol.d);
      __m512i ox[8], oy[8], oz[8];
      for (int j = 0; j < k; ++j) {
        ox[j] = _mm512_set1_epi32(cs[j].x + pm);
        oy[j] = _mm512_set1_epi32(cs[j].y + pm);
        oz[j] = _mm512_set1_epi32(cs[j].z + pm);
      }
      for (int i = 0; i < n; i += 16) {
        const __mmask16 lanes =
            i + 16 <= n ? (__mmask16)0xFFFF
                        : (__mmask16)((1u << (n - i)) - 1u);
        const __m512i x = _mm512_maskz_loadu_epi32(lanes, ax + i);
        const __m512i y = _mm512_maskz_loadu_epi32(lanes, ay + i);
        const __m512i z = _mm512_maskz_loadu_epi32(lanes, az + i);
        for (int j = 0; j < k; ++j) {
          const __m512i xx =
              _mm512_srai_epi32(_mm512_add_epi32(x, ox[j]), ks);
          const __m512i yy =
              _mm512_srai_epi32(_mm512_add_epi32(y, oy[j]), ks);
          const __m512i zz =
              _mm512_srai_epi32(_mm512_add_epi32(z, oz[j]), ks);
          const __mmask16 m = lanes &
                              _mm512_cmplt_epu32_mask(xx, vw) &
                              _mm512_cmplt_epu32_mask(yy, vh) &
                              _mm512_cmplt_epu32_mask(zz, vd);
          const __m512i idx = _mm512_add_epi32(
              _mm512_mullo_epi32(
                  _mm512_add_epi32(_mm512_mullo_epi32(zz, vh), yy), vw),
              xx);
          const __m512i g =
              _mm512_mask_i32gather_epi32(zero, m, idx, pool, 1);
          acc[j] = _mm512_add_epi32(acc[j], _mm512_and_si512(g, m255));
        }
      }
    }
    for (int j = 0; j < k; ++j) {
      sums[j] = _mm512_reduce_add_epi32(acc[j]);
      cs[j].score = Normalize(sums[j], s.n);
    }
#else
    for (int j = 0; j < k; ++j) cs[j].score = Score(level, cs[j]);
#endif
  }

  // Low-resolution veto score (low_resolution_matcher.cc; device
  // _low_res_scores_device): floor(base + off * ratio + 0.5).
  float LowScore(const Candidate& c) {
    const_cast<Matcher3*>(this)->EnsureLowBase(c.a);
    const float* bx = lbx.data() + size_t(c.a) * s.nl;
    const float* by = lby.data() + size_t(c.a) * s.nl;
    const float* bz = lbz.data() + size_t(c.a) * s.nl;
    const float ox = float(c.x) * ratio;
    const float oy = float(c.y) * ratio;
    const float oz = float(c.z) * ratio;
    int sum = 0;
    for (int i = 0; i < s.nl; ++i) {
      const int xx = (int)std::floor(bx[i] + ox + 0.5f);
      const int yy = (int)std::floor(by[i] + oy + 0.5f);
      const int zz = (int)std::floor(bz[i] + oz + 0.5f);
      sum += s.sm->low.at(zz, yy, xx);
    }
    return Normalize(sum, s.nl);
  }

  // Try to accept leaf c: high score already in c.score; veto on the
  // low-resolution grid. Updates best on success.
  void TryAccept(const Candidate& c, float* best_score, float* best_low,
                 Candidate* best) {
    const float low = LowScore(c);
    if (low < s.min_low) return;
    if (c.score > *best_score) {
      *best_score = c.score;
      *best_low = low;
      *best = c;
    }
  }

  float BranchAndBound(const Candidate* cands, int count, int level,
                       float best_score, float* best_low,
                       Candidate* best) {
    for (int ci = 0; ci < count; ++ci) {
      const Candidate& c = cands[ci];
      if (c.score <= best_score) break;
      if (level == 0) {
        // Leaf: must pass the low-resolution veto; a vetoed leaf does
        // NOT update the incumbent but siblings may still qualify.
        TryAccept(c, &best_score, best_low, best);
        continue;
      }
      const int half = 1 << (level - 1);
      Candidate children[8];
      int m = 0;
      for (int k = 0; k < 8; ++k) {
        const int x = c.x + (k & 1 ? half : 0);
        const int y = c.y + (k & 2 ? half : 0);
        const int z = c.z + (k & 4 ? half : 0);
        if (x > s.nl_xy || y > s.nl_xy || z > s.nl_z) continue;
        children[m] = {c.a, x, y, z, 0};
        ++m;
      }
      ScoreRun(level - 1, children, m);
      std::sort(children, children + m,
                [](const Candidate& a, const Candidate& b) {
                  return a.score > b.score;
                });
      best_score =
          BranchAndBound(children, m, level - 1, best_score, best_low, best);
    }
    return best_score;
  }

  // out: score, low_score, a, x, y, z; returns found.
  int Match(float* out) {
    Discretize();
    const int depth = s.sm->depth;
    const int top = 1 << (depth - 1);
    auto lattice = [&](int limit) {
      std::vector<int> offs;
      const int lo = -((limit / top) + 1) * top;
      for (int v = lo; v <= limit; v += top) offs.push_back(v);
      return offs;
    };
    const std::vector<int> oxy = lattice(s.nl_xy);
    const std::vector<int> oz = lattice(s.nl_z);
    std::vector<Candidate> topc;
    topc.reserve(size_t(s.na) * oxy.size() * oxy.size() * oz.size());
    for (int a = 0; a < s.na; ++a)
      for (int x : oxy)
        for (int y : oxy)
          for (int z : oz) topc.push_back({a, x, y, z, 0});
    // Angle-major order -> contiguous same-angle runs of up to 8 score
    // in one coordinate pass each.
    for (size_t c0 = 0; c0 < topc.size();) {
      size_t c1 = c0 + 1;
      while (c1 < topc.size() && c1 - c0 < 8 &&
             topc[c1].a == topc[c0].a)
        ++c1;
      ScoreRun(depth - 1, topc.data() + c0, int(c1 - c0));
      c0 = c1;
    }

    // Leaf-probe incumbent seeding (same rationale as the 2D backend).
    Candidate best{-1, 0, 0, 0, 0};
    float best_score = s.min_score;
    float best_low = 0.0f;
    if (s.seed) {
      constexpr int kProbe = 8;
      Candidate probe[kProbe];
      int np = 0;
      for (const Candidate& c : topc) {
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
        leaf.score = Score(0, leaf);
        TryAccept(leaf, &best_score, &best_low, &best);
      }
    }

    const auto heap_less = [](const Candidate& a, const Candidate& b) {
      return a.score < b.score;
    };
    std::make_heap(topc.begin(), topc.end(), heap_less);
    while (!topc.empty()) {
      std::pop_heap(topc.begin(), topc.end(), heap_less);
      const Candidate c = topc.back();
      topc.pop_back();
      if (c.score <= best_score) break;
      best_score = BranchAndBound(&c, 1, depth - 1, best_score,
                                  &best_low, &best);
    }
    out[0] = best_score;
    out[1] = best_low;
    out[2] = (float)best.a;
    out[3] = (float)best.x;
    out[4] = (float)best.y;
    out[5] = (float)best.z;
    return best.a >= 0 ? 1 : 0;
  }
};

}  // namespace

extern "C" {

// Build a per-submap search structure: octave pyramid of the high-res
// probability volume + quantized low-res volume.
void* bnb3_submap_create(const float* high_prob, int dh, int hh, int wh,
                         const float* low_prob, int dl, int hl, int wl,
                         int depth, int full_depth) {
  auto* sm = new Submap3();
  sm->depth = depth;
  sm->full_depth = std::max(1, std::min(full_depth, depth));
  sm->pad = (1 << (sm->full_depth - 1)) - 1;
  sm->pad_max = 1 << (depth - 1);
  sm->full_levels.reserve(sm->full_depth);
  sm->coarse_levels.resize(depth);
  // Rolling window-start pool on the pad_max-padded domain; each level
  // is emitted either full-resolution (l < full_depth, cropped to the
  // small pad) or subsampled by l - full_depth + 1 octaves.
  Vol rolling = PadLow(Quantize(high_prob, dh, hh, wh), sm->pad_max);
  for (int l = 0; l < depth; ++l) {
    if (l > 0) rolling = PoolWindowDouble(rolling, 1 << (l - 1));
    if (l < sm->full_depth) {
      sm->full_levels.push_back(CropPad(rolling, sm->pad_max, sm->pad));
      AddGatherSlack(&sm->full_levels.back());
    } else {
      Vol c = rolling;
      for (int k = 0; k < l - sm->full_depth + 1; ++k) c = PoolOctave(c);
      AddGatherSlack(&c);
      sm->coarse_levels[l] = std::move(c);
    }
  }
  sm->low = Quantize(low_prob, dl, hl, wl);
  return sm;
}

void bnb3_submap_destroy(void* handle) { delete (Submap3*)handle; }

// Batch of independent 3D searches fanned across threads.
//   submaps:          [n] handles (may repeat)
//   high/low clouds:  flat [*, 3] f32 node-frame points (UNIQUE clouds;
//                     searches reference them by offset/count)
//   angles:           flat f32 pre-pruned candidate yaws per search
//   params:           [n, 19] f32: q0 (wxyz), t0 (xyz), origin (xyz),
//                     resolution, low_origin (xyz), low_resolution,
//                     nl_xy, nl_z (cells), min_score, min_low_score
//   out:              [n, 6] f32: score, low_score, a, x, y, z
//   out_found:        [n] i32
void bnb3_match_batch(void** submaps, int n, const float* high,
                      const int64_t* off_h, const int32_t* cnt_h,
                      const float* low, const int64_t* off_l,
                      const int32_t* cnt_l, const float* angles,
                      const int64_t* off_a, const int32_t* cnt_a,
                      const float* params, float* out,
                      int32_t* out_found, int num_threads,
                      int enable_seed, int enable_simd) {
  // Submap-grouped order (see bnb_native.cc): keeps one submap's
  // pyramid hot in cache across consecutive searches.
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return submaps[a] < submaps[b];
  });
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      const int oi = next.fetch_add(1);
      if (oi >= n) return;
      const int i = order[oi];
      const float* pr = params + size_t(i) * 19;
      SearchSpec spec;
      spec.sm = (const Submap3*)submaps[i];
      spec.high = high + 3 * off_h[i];
      spec.n = cnt_h[i];
      spec.low_pts = low + 3 * off_l[i];
      spec.nl = cnt_l[i];
      spec.angles = angles + off_a[i];
      spec.na = cnt_a[i];
      std::memcpy(spec.q0, pr + 0, 4 * sizeof(float));
      std::memcpy(spec.t0, pr + 4, 3 * sizeof(float));
      std::memcpy(spec.origin, pr + 7, 3 * sizeof(float));
      spec.res = pr[10];
      std::memcpy(spec.lorigin, pr + 11, 3 * sizeof(float));
      spec.lres = pr[14];
      spec.nl_xy = (int)pr[15];
      spec.nl_z = (int)pr[16];
      spec.min_score = pr[17];
      spec.min_low = pr[18];
      spec.seed = enable_seed != 0;
      spec.simd = enable_simd != 0;
      Matcher3 m(spec);
      out_found[i] = m.Match(out + size_t(i) * 6);
    }
  };
  const int t = std::max(1, num_threads);
  std::vector<std::thread> threads;
  threads.reserve(t - 1);
  for (int k = 1; k < t; ++k) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

}  // extern "C"
