// Native host-side kernels: copied from cartographer_tpu/native/native.cc
// (only this header comment differs), built by kernels/_build.py and bound
// with ctypes in native/__init__.py.
//
// The hot host-side paths of the local builders (per-scan voxel filtering,
// the rotational scan-matcher histogram of every inserted 3D node) and two
// helpers (exact ray-to-pixel traversal, 2D cell accumulation), exposed
// through a C ABI. Device math stays in PyTorch and CUDA.
//
// Reference behaviors implemented:
//  * voxel_filter_indices: sensor/internal/voxel_filter.cc:77-161 — keep one
//    representative point per voxel, voxel key = round(p/resolution) packed
//    21 bits/axis.
//  * ray_to_pixel_mask: mapping/internal/2d/ray_to_pixel_mask.cc:30-120
//    semantics — every pixel crossed by the segment between two subpixel
//    coordinates — via Amanatides-Woo traversal in exact integer arithmetic.

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <algorithm>
#include <unordered_set>
#include <utility>
#include <vector>

extern "C" {

// points: [n * 3] float32, out_mask: [n] uint8 (1 = keep).
void voxel_filter_indices(const float* points, int64_t n, float resolution,
                          uint8_t* out_mask) {
  std::unordered_set<uint64_t> seen;
  seen.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const uint64_t x =
        static_cast<uint64_t>(std::llround(points[3 * i + 0] / resolution));
    const uint64_t y =
        static_cast<uint64_t>(std::llround(points[3 * i + 1] / resolution));
    const uint64_t z =
        static_cast<uint64_t>(std::llround(points[3 * i + 2] / resolution));
    const uint64_t key =
        ((x & 0x1FFFFF) << 42) | ((y & 0x1FFFFF) << 21) | (z & 0x1FFFFF);
    out_mask[i] = seen.insert(key).second ? 1 : 0;
  }
}

// Every pixel crossed by the segment from (begin_x, begin_y) to
// (end_x, end_y), all in subpixel coordinates; pixel = floor(subpixel /
// subpixel_scale). Integer Amanatides-Woo: crossing parameters compared via
// exact cross-multiplication, no floating point. Writes (x, y) int32 pairs;
// returns the count, or -1 if max_out would be exceeded.
int64_t ray_to_pixel_mask(int64_t begin_x, int64_t begin_y, int64_t end_x,
                          int64_t end_y, int64_t subpixel_scale, int32_t* out,
                          int64_t max_out) {
  const int64_t s = subpixel_scale;
  auto floor_div = [](int64_t a, int64_t b) {
    int64_t q = a / b;
    if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
    return q;
  };
  int64_t px = floor_div(begin_x, s);
  int64_t py = floor_div(begin_y, s);
  const int64_t px_end = floor_div(end_x, s);
  const int64_t py_end = floor_div(end_y, s);
  const int64_t dx = end_x - begin_x;
  const int64_t dy = end_y - begin_y;
  const int64_t step_x = dx > 0 ? 1 : -1;
  const int64_t step_y = dy > 0 ? 1 : -1;

  int64_t count = 0;
  auto emit = [&](int64_t x, int64_t y) -> bool {
    if (count >= max_out) return false;
    out[2 * count + 0] = static_cast<int32_t>(x);
    out[2 * count + 1] = static_cast<int32_t>(y);
    ++count;
    return true;
  };
  if (!emit(px, py)) return -1;

  // Subpixel distance to the next pixel border along each axis.
  auto border_dist_x = [&](int64_t cur) {
    return dx > 0 ? (cur + 1) * s - begin_x : begin_x - cur * s;
  };
  auto border_dist_y = [&](int64_t cur) {
    return dy > 0 ? (cur + 1) * s - begin_y : begin_y - cur * s;
  };

  const int64_t adx = std::llabs(dx);
  const int64_t ady = std::llabs(dy);
  while (px != px_end || py != py_end) {
    // Parameter of next x crossing: tx = border_dist_x / adx; compare
    // tx <= ty via border_dist_x * ady <= border_dist_y * adx.
    const int64_t bx = adx == 0 ? INT64_MAX : border_dist_x(px);
    const int64_t by = ady == 0 ? INT64_MAX : border_dist_y(py);
    bool advance_x;
    if (adx == 0) {
      advance_x = false;
    } else if (ady == 0) {
      advance_x = true;
    } else {
      const __int128 tx = static_cast<__int128>(bx) * ady;
      const __int128 ty = static_cast<__int128>(by) * adx;
      advance_x = tx <= ty;
    }
    // Guard against numeric dead ends (should not happen).
    if (advance_x) {
      if (px == px_end) advance_x = false;
    } else {
      if (py == py_end) advance_x = true;
    }
    if (advance_x) {
      px += step_x;
    } else {
      py += step_y;
    }
    if (!emit(px, py)) return -1;
  }
  return count;
}

// Batched point-in-grid accumulation used by host-side rendering: counts
// points per cell. points: [n * 2] float32 (already in cell units).
void accumulate_cells_2d(const float* points, int64_t n, int32_t height,
                         int32_t width, int32_t* grid) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t x = static_cast<int32_t>(std::floor(points[2 * i + 0]));
    const int32_t y = static_cast<int32_t>(std::floor(points[2 * i + 1]));
    if (x >= 0 && x < width && y >= 0 && y < height) {
      ++grid[static_cast<int64_t>(y) * width + x];
    }
  }
}

// Rotational scan-matcher histogram
// (internal/3d/scan_matching/rotational_scan_matcher.cc:31-193): angles
// between consecutive points within 0.2 m z-slices (sorted around the
// slice centroid), weighted by orthogonality to the centroid direction.
// points: [n * 3] float32 in the gravity-aligned frame; hist: [size] f32.
// Semantics mirror ops/scan_matching/rotational_histogram.py exactly
// (np.round / Python round() are round-half-to-even -> nearbyint).
void rotational_histogram(const float* points, int64_t n, int32_t size,
                          float* hist) {
  if (size <= 0) return;
  std::memset(hist, 0, sizeof(float) * static_cast<size_t>(size));
  if (n == 0) return;
  constexpr float kMinDistance = 0.2f;
  constexpr float kMaxDistance = 0.9f;
  constexpr float kSliceHeight = 0.2f;
  const double kPi = 3.14159265358979323846;
  std::vector<std::pair<int32_t, int64_t>> slot(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    slot[static_cast<size_t>(i)] = {
        static_cast<int32_t>(std::nearbyintf(points[3 * i + 2] / kSliceHeight)),
        i};
  }
  std::stable_sort(
      slot.begin(), slot.end(),
      [](const std::pair<int32_t, int64_t>& a,
         const std::pair<int32_t, int64_t>& b) { return a.first < b.first; });
  struct P {
    float x, y, angle;
  };
  std::vector<P> pts;
  int64_t start = 0;
  while (start < n) {
    int64_t end = start;
    while (end < n && slot[static_cast<size_t>(end)].first ==
                          slot[static_cast<size_t>(start)].first) {
      ++end;
    }
    double cx = 0.0, cy = 0.0;
    for (int64_t k = start; k < end; ++k) {
      const int64_t i = slot[static_cast<size_t>(k)].second;
      cx += points[3 * i];
      cy += points[3 * i + 1];
    }
    const float cxf = static_cast<float>(cx / static_cast<double>(end - start));
    const float cyf = static_cast<float>(cy / static_cast<double>(end - start));
    pts.clear();
    for (int64_t k = start; k < end; ++k) {
      const int64_t i = slot[static_cast<size_t>(k)].second;
      const float x = points[3 * i];
      const float y = points[3 * i + 1];
      const float dx = x - cxf;
      const float dy = y - cyf;
      if (std::sqrt(dx * dx + dy * dy) >= kMinDistance) {
        pts.push_back({x, y, std::atan2(dy, dx)});
      }
    }
    start = end;
    if (pts.size() < 2) continue;
    std::stable_sort(pts.begin(), pts.end(), [](const P& a, const P& b) {
      return a.angle < b.angle;
    });
    float lx = pts[0].x, ly = pts[0].y;
    for (const P& p : pts) {
      const float dx = p.x - lx;
      const float dy = p.y - ly;
      const float gx = p.x - cxf;
      const float gy = p.y - cyf;
      const float dist = std::sqrt(dx * dx + dy * dy);
      const float dirn = std::sqrt(gx * gx + gy * gy);
      if (dist < kMinDistance || dirn < kMinDistance) continue;
      if (dist > kMaxDistance) {
        lx = p.x;
        ly = p.y;
        continue;
      }
      const float dot =
          (dx / std::max(dist, 1e-12f)) * (gx / std::max(dirn, 1e-12f)) +
          (dy / std::max(dist, 1e-12f)) * (gy / std::max(dirn, 1e-12f));
      const float value = std::max(0.0f, 1.0f - std::abs(dot));
      double a = std::fmod(static_cast<double>(std::atan2(dy, dx)), kPi);
      if (a < 0.0) a += kPi;
      int32_t bucket = static_cast<int32_t>(
          std::nearbyint(static_cast<double>(size) * a / kPi - 0.5));
      bucket = std::min(std::max(bucket, 0), size - 1);
      hist[bucket] += value;
      lx = p.x;
      ly = p.y;
    }
  }
}

}  // extern "C"
