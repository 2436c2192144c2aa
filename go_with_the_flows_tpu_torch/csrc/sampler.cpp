// Native surface sampler: the host data loader's hot loop (the port's
// copy of the JAX package's csrc/sampler.cpp, the same code, so that both
// packages draw the same clouds from the same seed).
//
// The reference's per-item CPU cost is dominated by area-weighted triangle
// sampling of 2x2048 points per mesh (reference lib/datasets/
// cloud_sampling.py:4-32, called from DataLoader workers). This is its
// C++ equivalent: an area-weighted categorical over faces (binary search
// over the prefix sum) and uniform barycentric sampling with fold-over
// reflection, plus a multithreaded batch entry point, so that one host
// process samples a whole batch without Python worker processes.
//
// A plain C ABI, loaded with ctypes (data/native.py builds it with g++).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// SplitMix64 — tiny, seedable, statistically solid for sampling.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed + 0x9E3779B97F4A7C15ULL) {}
  inline uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  inline float uniform() {  // [0, 1)
    return (next() >> 40) * (1.0f / 16777216.0f);
  }
};

inline void sample_one(const float* vertices, int64_t n_vertices,
                       const uint32_t* faces, int64_t n_faces,
                       int64_t n_samples, uint64_t seed, float* out) {
  (void)n_vertices;
  // prefix sums of triangle areas
  std::vector<double> cum(n_faces);
  double total = 0.0;
  for (int64_t f = 0; f < n_faces; ++f) {
    const float* v0 = vertices + 3 * faces[3 * f + 0];
    const float* v1 = vertices + 3 * faces[3 * f + 1];
    const float* v2 = vertices + 3 * faces[3 * f + 2];
    // cross(v2 - v0, v2 - v1)
    float ax = v2[0] - v0[0], ay = v2[1] - v0[1], az = v2[2] - v0[2];
    float bx = v2[0] - v1[0], by = v2[1] - v1[1], bz = v2[2] - v1[2];
    float cx = ay * bz - az * by;
    float cy = az * bx - ax * bz;
    float cz = ax * by - ay * bx;
    total += 0.5 * std::sqrt(double(cx) * cx + double(cy) * cy +
                             double(cz) * cz);
    cum[f] = total;
  }
  Rng rng(seed);
  const bool degenerate = !(total > 0.0);
  for (int64_t i = 0; i < n_samples; ++i) {
    int64_t f;
    if (degenerate) {
      f = int64_t(rng.next() % uint64_t(n_faces));
    } else {
      double u = rng.uniform() * total;
      f = std::upper_bound(cum.begin(), cum.end(), u) - cum.begin();
      if (f >= n_faces) f = n_faces - 1;
    }
    float s1 = rng.uniform();
    float s2 = rng.uniform();
    if (s1 + s2 > 1.0f) {
      s1 = 1.0f - s1;
      s2 = 1.0f - s2;
    }
    const float* v0 = vertices + 3 * faces[3 * f + 0];
    const float* v1 = vertices + 3 * faces[3 * f + 1];
    const float* v2 = vertices + 3 * faces[3 * f + 2];
    // out layout: (3, n_samples) to match the Python pipeline
    for (int c = 0; c < 3; ++c) {
      out[c * n_samples + i] =
          v0[c] + s1 * (v1[c] - v0[c]) + s2 * (v2[c] - v0[c]);
    }
  }
}

}  // namespace

extern "C" {

// Sample one mesh: out must hold 3 * n_samples floats, laid out (3, N).
void gwtf_sample_cloud(const float* vertices, int64_t n_vertices,
                       const uint32_t* faces, int64_t n_faces,
                       int64_t n_samples, uint64_t seed, float* out) {
  sample_one(vertices, n_vertices, faces, n_faces, n_samples, seed, out);
}

// Sample a batch of ragged meshes in parallel.
//   vertices: concatenated (sum_nv, 3); v_bounds: (batch+1,) prefix sums
//   faces:    concatenated (sum_nf, 3); f_bounds: (batch+1,)
//   out:      (batch, 3, n_samples)
void gwtf_sample_batch(const float* vertices, const int64_t* v_bounds,
                       const uint32_t* faces, const int64_t* f_bounds,
                       int64_t batch, int64_t n_samples, uint64_t seed,
                       int n_threads, float* out) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= batch) return;
      sample_one(vertices + 3 * v_bounds[i],
                 v_bounds[i + 1] - v_bounds[i],
                 faces + 3 * f_bounds[i],
                 f_bounds[i + 1] - f_bounds[i],
                 n_samples, seed + uint64_t(i) * 0x9E3779B9ULL,
                 out + i * 3 * n_samples);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
