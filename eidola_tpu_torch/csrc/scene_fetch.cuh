// Device code shared by the kernels that read the scene's shading tables
// (csrc/alpha_lap.cu, csrc/shade_state.cu): torch's float clamp and int64
// remainder, the texture stack's wrap modes and bilinear fetch
// (scene/textures.py `_wrap_coord`, `_bilinear_level`) and the instance
// search (scene/data.py `shade_row`).  Each follows its plain version's
// order and rounding (built with -fmad=false), so the kernels that use
// them agree with the torch code bit for bit.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace eidola {

constexpr int64_t kWrapClamp = 1;    // scene/data.py WRAP_CLAMP
constexpr int64_t kWrapMirror = 2;   // WRAP_MIRROR

// the padded mip-atlas stack (scene/data.py TexStack)
struct TexStack {
    const float* data;       // (NT, TH, W2, 4) level 0 left, mips right
    const int64_t* size;     // (NT, 2) level-0 (h, w)
    const int64_t* wrap;     // (NT, 2) WRAP_* for x, y
    int64_t h, w2;           // TH, W2
    int untextured;          // the 1x1 stack: every texture reads 1
};

// the instance table of an instanced scene (scene/data.py Instancing)
struct InstSearch {
    const int64_t* tri_base;     // (I,) sorted; nullptr on a flat scene
    const int64_t* attr_base;    // (I,)
    int n;
};

// an int64 table entry through the read-only cache
__device__ __forceinline__ int64_t ldg64(const int64_t* p) {
    return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// torch.clamp on floats: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_minf(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

// torch.remainder on int64: the sign of the divisor
__device__ __forceinline__ int64_t floor_mod(int64_t a, int64_t b) {
    int64_t r = a % b;
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}

// scene/textures.py _wrap_coord
__device__ __forceinline__ int64_t wrap_coord(int64_t x, int64_t n,
                                              int64_t mode) {
    if (mode == kWrapMirror) {
        const int64_t m = floor_mod(x, n * 2 > 1 ? n * 2 : 1);
        return m >= n ? 2 * n - 1 - m : m;
    }
    if (mode == kWrapClamp) {
        const int64_t c = x > 0 ? x : 0;
        return c < n - 1 ? c : n - 1;
    }
    return floor_mod(x, n);
}

// scene/textures.py _bilinear_level: channels kFirst..3 of texture tid's
// bilinear fetch at mip `level` (the level's extent, its atlas column
// offset, the wrap modes, the texel combine order); the channels are
// independent, so a subset is the same bits.  kFirst = 0 reads each texel
// as one 16-byte load (`data` 16-byte aligned).
template <int kFirst>
__device__ __forceinline__ void bilinear_level(const TexStack& tx,
                                               int64_t tid, float uv0,
                                               float uv1, int64_t level,
                                               float out[4]) {
    const int64_t h0 = ldg64(tx.size + tid * 2);
    const int64_t w0 = ldg64(tx.size + tid * 2 + 1);
    const int64_t up = (int64_t{1} << level) - 1;
    const int64_t hl = (h0 + up) >> level, wl = (w0 + up) >> level;
    const int64_t h = hl > 1 ? hl : 1, w = wl > 1 ? wl : 1;
    const int64_t tw = tx.w2 / 2;
    const int64_t xoff =
        level == 0 ? 0 : 2 * tw - (tw >> (level - 1 > 0 ? level - 1 : 0));
    const float uu = uv0 * static_cast<float>(w) - 0.5f;
    const float vv = uv1 * static_cast<float>(h) - 0.5f;
    const float x0f = floorf(uu), y0f = floorf(vv);
    const float fx = uu - x0f, fy = vv - y0f;
    const int64_t x0i = static_cast<int64_t>(x0f);
    const int64_t y0i = static_cast<int64_t>(y0f);
    const int64_t wx = ldg64(tx.wrap + tid * 2);
    const int64_t wy = ldg64(tx.wrap + tid * 2 + 1);
    const int64_t x0 = xoff + wrap_coord(x0i, w, wx);
    const int64_t x1 = xoff + wrap_coord(x0i + 1, w, wx);
    const int64_t y0 = wrap_coord(y0i, h, wy), y1 = wrap_coord(y0i + 1, h, wy);
    const float* img = tx.data + tid * tx.h * tx.w2 * 4;
    float c[4][4];      // texels (y0, x0), (y0, x1), (y1, x0), (y1, x1)
    const int64_t at[4] = {(y0 * tx.w2 + x0) * 4, (y0 * tx.w2 + x1) * 4,
                           (y1 * tx.w2 + x0) * 4, (y1 * tx.w2 + x1) * 4};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        if (kFirst == 0) {
            const float4 q =
                __ldg(reinterpret_cast<const float4*>(img + at[k]));
            c[k][0] = q.x;
            c[k][1] = q.y;
            c[k][2] = q.z;
            c[k][3] = q.w;
        } else {
#pragma unroll
            for (int ch = kFirst; ch < 4; ++ch)
                c[k][ch] = __ldg(img + at[k] + ch);
        }
    }
    const float gx = 1.0f - fx, gy = 1.0f - fy;
#pragma unroll
    for (int ch = kFirst; ch < 4; ++ch)
        out[ch] = (c[0][ch] * gx + c[1][ch] * fx) * gy +
                  (c[2][ch] * gx + c[3][ch] * fx) * fy;
}

// scene/data.py shade_row: the attribute row of a global triangle id
// (an upper-bound search of the instances' tri_base), and its instance
// in *inst (0 on a flat scene)
__device__ __forceinline__ int64_t shade_row(const InstSearch& is,
                                             int64_t tid, int* inst) {
    *inst = 0;
    if (is.tri_base == nullptr) return tid;
    int lo = 0, hi = is.n;           // searchsorted(right=True)
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ldg64(is.tri_base + mid) <= tid) lo = mid + 1;
        else hi = mid;
    }
    const int i = lo - 1 > 0 ? lo - 1 : 0;
    *inst = i;
    return ldg64(is.attr_base + i) + (tid - ldg64(is.tri_base + i));
}

}  // namespace eidola
