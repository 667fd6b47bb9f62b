// Data-loader kernels of the port: raw velodyne point clouds -> range images.
//
// The port's own copy of the JAX package's csrc/projection.cpp (the same code, built
// with the same flags, gives the same bits): the per-frame scan-unfolding projection +
// z-buffer scatter and the nearest-neighbour resize, on the host, behind a plain C ABI
// for ctypes.
//
// Built at first use by dusty_gan_v2_tpu_torch/datasets/native.py:
//   g++ -O3 -march=native -fPIC -shared -std=c++17 -o <lib> projection.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// points: (n, 4) float32 [x, y, z, intensity]
// out:    (H, W, 6) float32 [x, y, z, intensity, depth, mask], zero-initialized here
// Returns 0 on success.
int project_points_to_image(const float* points, int64_t n, int H, int W,
                            float min_depth, float max_depth, int scan_unfolding,
                            float* out) {
  if (n <= 0) {
    std::memset(out, 0, sizeof(float) * H * W * 6);
    return 0;
  }
  std::memset(out, 0, sizeof(float) * H * W * 6);

  std::vector<int32_t> grid_h(n), grid_w(n);
  std::vector<float> depth(n);

  for (int64_t i = 0; i < n; ++i) {
    const float x = points[i * 4 + 0];
    const float y = points[i * 4 + 1];
    const float z = points[i * 4 + 2];
    depth[i] = std::sqrt(x * x + y * y + z * z);
  }

  if (scan_unfolding) {
    // quadrant of each point (counterclockwise ordering assumed)
    // segment boundaries where the previous quadrant is 4th and current is 1st
    std::vector<int64_t> delim;
    auto quad = [&](int64_t i) -> int {
      const float x = points[i * 4 + 0];
      const float y = points[i * 4 + 1];
      if (x >= 0 && y >= 0) return 0;
      if (x < 0 && y >= 0) return 1;
      if (x < 0 && y < 0) return 2;
      return 3;
    };
    int prev = quad(n - 1);
    for (int64_t i = 0; i < n; ++i) {
      const int q = quad(i);
      if (prev - q == 3) delim.push_back(i);
      prev = q;
    }
    const int64_t S = static_cast<int64_t>(delim.size());
    // ring for segment s (0-based): H - S + s, clamped; points before the first
    // delimiter (and segments that would get ring < 0) stay at row 0
    std::fill(grid_h.begin(), grid_h.end(), 0);
    for (int64_t s = 0; s < S; ++s) {
      const int64_t ring = (int64_t)H - S + s;
      if (ring < 0) continue;
      const int64_t lo = delim[s];
      const int64_t hi = (s + 1 < S) ? delim[s + 1] : n;
      const int32_t r = static_cast<int32_t>(std::min<int64_t>(ring, H - 1));
      for (int64_t i = lo; i < hi; ++i) grid_h[i] = r;
    }
  } else {
    const float fup = 3.0f * (float)M_PI / 180.0f;
    const float fdown = -25.0f * (float)M_PI / 180.0f;
    for (int64_t i = 0; i < n; ++i) {
      const float z = points[i * 4 + 2];
      const float d = std::max(depth[i], 1e-12f);
      float ratio = z / d;
      ratio = std::max(-1.0f, std::min(1.0f, ratio));
      const float pitch = std::asin(ratio) + std::fabs(fdown);
      float gh = std::floor((1.0f - pitch / (fup - fdown)) * H);
      gh = std::max(0.0f, std::min((float)(H - 1), gh));
      grid_h[i] = (int32_t)gh;
    }
  }

  for (int64_t i = 0; i < n; ++i) {
    const float x = points[i * 4 + 0];
    const float y = points[i * 4 + 1];
    const float yaw = -std::atan2(y, x);
    float gw = (yaw / (float)M_PI + 1.0f) * 0.5f;
    gw = gw - std::floor(gw);  // mod 1
    gw = std::floor(gw * W);
    if (gw > W - 1) gw = (float)(W - 1);
    grid_w[i] = (int32_t)gw;
  }

  // z-buffer: keep the nearest point per cell
  std::vector<float> best(H * W, INFINITY);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t cell = (int64_t)grid_h[i] * W + grid_w[i];
    if (depth[i] < best[cell]) {
      best[cell] = depth[i];
      float* dst = out + cell * 6;
      dst[0] = points[i * 4 + 0];
      dst[1] = points[i * 4 + 1];
      dst[2] = points[i * 4 + 2];
      dst[3] = points[i * 4 + 3];
      dst[4] = depth[i];
      dst[5] = (depth[i] >= min_depth && depth[i] <= max_depth) ? 1.0f : 0.0f;
    }
  }
  return 0;
}

// nearest-neighbor resize (H,W,C) -> (OH,OW,C), src = floor(dst * in/out)
int nearest_resize(const float* img, int H, int W, int C, int OH, int OW,
                   float* out) {
  for (int i = 0; i < OH; ++i) {
    const int si = std::min((int)std::floor(i * (double)H / OH), H - 1);
    for (int j = 0; j < OW; ++j) {
      const int sj = std::min((int)std::floor(j * (double)W / OW), W - 1);
      std::memcpy(out + ((int64_t)i * OW + j) * C,
                  img + ((int64_t)si * W + sj) * C, sizeof(float) * C);
    }
  }
  return 0;
}

}  // extern "C"
