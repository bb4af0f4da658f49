// EIDOLA native host builders for the PyTorch + CUDA port (a copy of the
// JAX package's C++ builders, cut to what the port uses):
//   - Walker/Vose alias tables  (ref src/alias_table.hpp:21-63,
//     hdr_sampling.cpp:107-176 — 2M-texel env maps need native speed)
//   - binned-SAH BVH topology + preorder/escape-link flatten
//     (ref nvvk::RaytracingBuilderKHR FAST_TRACE build, accelstruct.cpp)
//   - 32-bit octahedral normal codec  (ref shaders/compress.glsl)
//
// Exposed as a plain C ABI consumed via ctypes
// (eidola_tpu_torch/native/__init__.py); the numpy builders of
// eidola_tpu_torch/ops/bvh_build.py and ops/alias_table.py are the
// fallbacks when no C++ compiler is present.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- alias ---
// Returns total weight. alias/q/pdf/alias_pdf are caller-allocated (n).
double eidola_build_alias(const double* w, int64_t n, int32_t* alias,
                          float* q, float* pdf, float* alias_pdf) {
  double total = 0.0;
  for (int64_t i = 0; i < n; ++i) total += w[i];
  if (n == 0 || total <= 0.0) {
    for (int64_t i = 0; i < n; ++i) {
      alias[i] = (int32_t)i; q[i] = 1.f; pdf[i] = 0.f; alias_pdf[i] = 0.f;
    }
    return 0.0;
  }
  std::vector<double> scaled(n);
  std::vector<double> p(n);
  for (int64_t i = 0; i < n; ++i) {
    p[i] = w[i] / total;
    scaled[i] = p[i] * (double)n;
    alias[i] = (int32_t)i;
  }
  std::vector<double> qd(n, 1.0);
  std::vector<int64_t> small, large;
  small.reserve(n); large.reserve(n);
  for (int64_t i = 0; i < n; ++i)
    (scaled[i] < 1.0 ? small : large).push_back(i);
  while (!small.empty() && !large.empty()) {
    int64_t s = small.back(); small.pop_back();
    int64_t l = large.back(); large.pop_back();
    qd[s] = scaled[s];
    alias[s] = (int32_t)l;
    scaled[l] = (scaled[l] + scaled[s]) - 1.0;
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  for (int64_t i : small) { qd[i] = 1.0; alias[i] = (int32_t)i; }
  for (int64_t i : large) { qd[i] = 1.0; alias[i] = (int32_t)i; }
  for (int64_t i = 0; i < n; ++i) {
    q[i] = (float)qd[i];
    pdf[i] = (float)p[i];
    alias_pdf[i] = (float)p[alias[i]];
  }
  return total;
}

// ---------------------------------------------------------------- BVH -----
namespace {

struct BuildNode {
  float bmin[3], bmax[3];
  int64_t left = -1, right = -1;     // topology children
  int64_t first = -1, count = 0;     // leaf triangle range in tri_order
};

constexpr int kBins = 16;

struct Builder {
  const float* tb_min;
  const float* tb_max;
  const float* centroid;
  int leaf_size;
  std::vector<int64_t> order;        // triangle permutation, partitioned
  std::vector<BuildNode> nodes;

  static float area(const float lo[3], const float hi[3]) {
    float d0 = std::max(hi[0] - lo[0], 0.f);
    float d1 = std::max(hi[1] - lo[1], 0.f);
    float d2 = std::max(hi[2] - lo[2], 0.f);
    return d0 * d1 + d1 * d2 + d2 * d0;
  }

  int64_t build(int64_t begin, int64_t end) {
    int64_t me = (int64_t)nodes.size();
    nodes.emplace_back();
    {
      BuildNode& n = nodes[me];
      for (int a = 0; a < 3; ++a) { n.bmin[a] = 1e30f; n.bmax[a] = -1e30f; }
      for (int64_t i = begin; i < end; ++i) {
        const float* lo = tb_min + order[i] * 3;
        const float* hi = tb_max + order[i] * 3;
        for (int a = 0; a < 3; ++a) {
          n.bmin[a] = std::min(n.bmin[a], lo[a]);
          n.bmax[a] = std::max(n.bmax[a], hi[a]);
        }
      }
    }
    int64_t count = end - begin;
    if (count <= leaf_size) {
      nodes[me].first = begin;
      nodes[me].count = count;
      return me;
    }

    // centroid extent -> split axis
    float c_lo[3] = {1e30f, 1e30f, 1e30f}, c_hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = begin; i < end; ++i) {
      const float* c = centroid + order[i] * 3;
      for (int a = 0; a < 3; ++a) {
        c_lo[a] = std::min(c_lo[a], c[a]);
        c_hi[a] = std::max(c_hi[a], c[a]);
      }
    }
    int axis = 0;
    float ext = c_hi[0] - c_lo[0];
    for (int a = 1; a < 3; ++a)
      if (c_hi[a] - c_lo[a] > ext) { ext = c_hi[a] - c_lo[a]; axis = a; }

    int64_t mid;
    if (ext < 1e-12f) {
      mid = begin + count / 2;  // degenerate: median split
    } else {
      // binned SAH (ref SURVEY §7: 16 centroid bins on the largest axis)
      float scale = kBins * (1.0f - 1e-6f) / ext;
      int64_t cnt[kBins] = {0};
      float blo[kBins][3], bhi[kBins][3];
      for (int b = 0; b < kBins; ++b)
        for (int a = 0; a < 3; ++a) { blo[b][a] = 1e30f; bhi[b][a] = -1e30f; }
      for (int64_t i = begin; i < end; ++i) {
        int64_t t = order[i];
        int b = (int)((centroid[t * 3 + axis] - c_lo[axis]) * scale);
        b = std::min(std::max(b, 0), kBins - 1);
        ++cnt[b];
        for (int a = 0; a < 3; ++a) {
          blo[b][a] = std::min(blo[b][a], tb_min[t * 3 + a]);
          bhi[b][a] = std::max(bhi[b][a], tb_max[t * 3 + a]);
        }
      }
      // prefix/suffix sweeps
      float lmin[kBins][3], lmax[kBins][3], rmin[kBins][3], rmax[kBins][3];
      int64_t lcnt[kBins], rcnt[kBins];
      for (int a = 0; a < 3; ++a) { lmin[0][a] = blo[0][a]; lmax[0][a] = bhi[0][a]; }
      lcnt[0] = cnt[0];
      for (int b = 1; b < kBins; ++b) {
        lcnt[b] = lcnt[b - 1] + cnt[b];
        for (int a = 0; a < 3; ++a) {
          lmin[b][a] = std::min(lmin[b - 1][a], blo[b][a]);
          lmax[b][a] = std::max(lmax[b - 1][a], bhi[b][a]);
        }
      }
      for (int a = 0; a < 3; ++a) {
        rmin[kBins - 1][a] = blo[kBins - 1][a];
        rmax[kBins - 1][a] = bhi[kBins - 1][a];
      }
      rcnt[kBins - 1] = cnt[kBins - 1];
      for (int b = kBins - 2; b >= 0; --b) {
        rcnt[b] = rcnt[b + 1] + cnt[b];
        for (int a = 0; a < 3; ++a) {
          rmin[b][a] = std::min(rmin[b + 1][a], blo[b][a]);
          rmax[b][a] = std::max(rmax[b + 1][a], bhi[b][a]);
        }
      }
      int best = -1;
      double best_cost = 1e300;
      for (int b = 0; b < kBins - 1; ++b) {  // split AFTER bin b
        if (lcnt[b] == 0 || rcnt[b + 1] == 0) continue;
        double cost = (double)area(lmin[b], lmax[b]) * lcnt[b] +
                      (double)area(rmin[b + 1], rmax[b + 1]) * rcnt[b + 1];
        if (cost < best_cost) { best_cost = cost; best = b; }
      }
      if (best < 0) {
        mid = begin + count / 2;
        std::nth_element(
            order.begin() + begin, order.begin() + mid, order.begin() + end,
            [&](int64_t x, int64_t y) {
              return centroid[x * 3 + axis] < centroid[y * 3 + axis];
            });
      } else {
        auto it = std::partition(
            order.begin() + begin, order.begin() + end, [&](int64_t t) {
              int b = (int)((centroid[t * 3 + axis] - c_lo[axis]) * scale);
              b = std::min(std::max(b, 0), kBins - 1);
              return b <= best;
            });
        mid = it - order.begin();
        if (mid == begin || mid == end) mid = begin + count / 2;
      }
    }
    int64_t l = build(begin, mid);
    int64_t r = build(mid, end);
    nodes[me].left = l;
    nodes[me].right = r;
    return me;
  }
};

int64_t subtree_size(const std::vector<BuildNode>& nodes, int64_t i,
                     std::vector<int64_t>& memo) {
  if (memo[i] >= 0) return memo[i];
  const BuildNode& n = nodes[i];
  int64_t s = 1;
  if (n.left >= 0) s += subtree_size(nodes, n.left, memo) +
                        subtree_size(nodes, n.right, memo);
  return memo[i] = s;
}

}  // namespace

// Builds the flattened preorder/escape-link BVH (same layout as
// ops/bvh_build.py flatten_preorder).  Caller allocates:
//   out_bmin/out_bmax: 2T*3 floats; escape/blk: 2T int32;
//   leaf_tris: T int32; leaf_start: T+1 int32 (offsets into leaf_tris).
// Returns n_nodes; *n_leaves_out gets the leaf count.  Negative on error.
int64_t eidola_build_bvh(const float* tb_min, const float* tb_max,
                         const float* centroid, int64_t T, int32_t leaf_size,
                         float* out_bmin, float* out_bmax, int32_t* escape,
                         int32_t* blk, int32_t* leaf_tris,
                         int32_t* leaf_start, int64_t* n_leaves_out) {
  if (T <= 0) return -1;
  Builder b;
  b.tb_min = tb_min;
  b.tb_max = tb_max;
  b.centroid = centroid;
  b.leaf_size = leaf_size;
  b.order.resize(T);
  for (int64_t i = 0; i < T; ++i) b.order[i] = i;
  b.nodes.reserve(2 * (T / std::max(leaf_size / 2, 1) + 1));
  b.build(0, T);

  const auto& nodes = b.nodes;
  int64_t n_nodes = (int64_t)nodes.size();
  std::vector<int64_t> memo(n_nodes, -1);

  // iterative preorder emission with escape links
  std::vector<std::pair<int64_t, int64_t>> stack;  // (topology id, escape)
  stack.emplace_back(0, -1);
  int64_t cursor = 0, n_leaves = 0, tri_cursor = 0;
  while (!stack.empty()) {
    auto [ni, esc] = stack.back();
    stack.pop_back();
    const BuildNode& n = nodes[ni];
    int64_t me = cursor++;
    for (int a = 0; a < 3; ++a) {
      out_bmin[me * 3 + a] = n.bmin[a];
      out_bmax[me * 3 + a] = n.bmax[a];
    }
    escape[me] = (int32_t)esc;
    if (n.left < 0) {
      blk[me] = (int32_t)n_leaves;
      leaf_start[n_leaves] = (int32_t)tri_cursor;
      for (int64_t i = 0; i < n.count; ++i)
        leaf_tris[tri_cursor++] = (int32_t)b.order[n.first + i];
      ++n_leaves;
    } else {
      blk[me] = -1;
      int64_t right_pos = me + 1 + subtree_size(nodes, n.left, memo);
      stack.emplace_back(n.right, esc);
      stack.emplace_back(n.left, right_pos);
    }
  }
  leaf_start[n_leaves] = (int32_t)tri_cursor;
  *n_leaves_out = n_leaves;
  return n_nodes;
}

// ------------------------------------------------------- oct compression --
// 32-bit octahedral pack/unpack (ref shaders/compress.glsl:111-180).
static inline float sgn(float v) { return v >= 0.f ? 1.f : -1.f; }

void eidola_oct_encode(const float* n, int64_t count, uint32_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    float x = n[i * 3], y = n[i * 3 + 1], z = n[i * 3 + 2];
    float l = std::abs(x) + std::abs(y) + std::abs(z);
    if (l < 1e-20f) { out[i] = 0; continue; }
    float px = x / l, py = y / l;
    if (z < 0.f) {
      float ox = (1.f - std::abs(py)) * sgn(px);
      float oy = (1.f - std::abs(px)) * sgn(py);
      px = ox; py = oy;
    }
    auto snorm16 = [](float v) -> uint32_t {
      int q = (int)std::lround(std::min(std::max(v, -1.f), 1.f) * 32767.f);
      return (uint32_t)(uint16_t)(int16_t)q;
    };
    out[i] = snorm16(px) | (snorm16(py) << 16);
  }
}

void eidola_oct_decode(const uint32_t* packed, int64_t count, float* out) {
  for (int64_t i = 0; i < count; ++i) {
    int16_t qx = (int16_t)(packed[i] & 0xFFFF);
    int16_t qy = (int16_t)(packed[i] >> 16);
    float x = (float)qx / 32767.f, y = (float)qy / 32767.f;
    float z = 1.f - std::abs(x) - std::abs(y);
    if (z < 0.f) {
      float ox = (1.f - std::abs(y)) * sgn(x);
      float oy = (1.f - std::abs(x)) * sgn(y);
      x = ox; y = oy;
    }
    float l = std::sqrt(std::max(x * x + y * y + z * z, 1e-20f));
    out[i * 3] = x / l; out[i * 3 + 1] = y / l; out[i * 3 + 2] = z / l;
  }
}

}  // extern "C"
