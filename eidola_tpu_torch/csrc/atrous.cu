// One level of the edge-avoiding a-trous wavelet denoiser for Hopper
// (sm_90a): the 5x5 B3-spline taps at stride 2^level, each weighted by
// the luminance, normal and position edge stops and the material gate,
// and the normalised sum, in one launch.
//
// Replaces no TPU kernel: the JAX package's denoiser
// (eidola_tpu/render/denoise.py:atrous_level) is XLA's fused elementwise
// work.  On the card the port ran a level as ~875 torch launches (25 taps
// of ~30 elementwise ops each, and 10 gathers that edge-padded the five
// planes), none of them behind a sync, so the stage cost the host's
// dispatch of ~7,875 launches a frame (4 direct + 5 indirect levels)
// while the card waited.  render/denoise.py's `atrous_denoise` launches
// this kernel once a level on the card and keeps the torch level
// (`_edge_stopped`) for the CPU.
//
// One thread per output pixel, 32x8 pixels a block.  The centre's
// luminance, position, normal, hash and valid flag stay in registers;
// the 25 taps are read through the read-only cache.  From level 2 on the
// taps lie 4-16 pixels apart, so a shared tile of the footprint would be
// mostly halo.  Edge padding is a clamp of the tap's row and column:
// each input plane may carry `e` extra rows above and below its h rows
// (the rows a shard exchange brought, parallel/exchange.py), so rows
// clamp to [-e, h-1+e] and columns to [0, w-1]; with e = 0 that is the
// torch path's replicate padding.  Every plane is read through its own
// strides in elements, so the indirect stage's view `a[::2, ::2]` needs
// no copy.  The sigmas are read from device memory: no host sync.
//
// Arithmetic: f32 built with -fmad=false and no fast math, every
// operation in `_edge_stopped`'s order and rounding: luminance
// (c0 * 0.2126 + c1 * 0.7152) + c2 * 0.0722 with the constants rounded
// from double as torch rounds a Python scalar; the three-term sums of
// squares in the order torch's CUDA reduction adds an inner dimension of
// three, (x0 + x2) + x1 (two threads: elements 0 and 2, then 1); the
// weight ((k w_l) w_n) w_x times the gate as 1 or 0; acc + q w and
// wsum + w from zero, tap by tap in (iy, ix) order; acc / max(wsum,
// 1e-8) with IEEE division; pixels without a surface keep their value.
// So each pixel equals the torch level's bit for bit.
//
// What bounds it on this card: neither.  A level reads 45 bytes a pixel
// once (image 12, position 12, normal 12, hash 8, valid 1) and writes 12:
// 118 MB at 1920x1080, ~35 us at 3.35 TB/s; it does ~40 operations and 3
// expf a tap, ~1,100 a pixel, ~2.3 GFLOP, ~34 us at 67 TFLOP/s.  The 25
// taps re-read the planes from L1 and L2 (11 loads a tap), so the kernel
// is bound by its cached loads: on an H100 ~0.34 ms a level at 1920x1080,
// ~10x its bound and far below the host time of the ~875 launches it
// replaces.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// an (H, W, 3) f32 plane with its strides in elements
struct Plane3 {
    const float* p;
    int64_t sy, sx, sc;
};

// the view planes the edge stops read, each with `e` extra rows
struct View {
    Plane3 pos, nrm;
    const long long* hash;           // (H, W) int64
    int64_t hsy, hsx;
    const unsigned char* valid;      // (H, W) bool
    int64_t vsy, vsx;
    int e;
};

// torch.clamp(x, min=lo) on floats: NaN passes through
__device__ __forceinline__ float clamp_minf(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

// render/denoise.py _K5[i], the B3-spline weights (Python floats); the
// taps' loops unroll, so k5(iy) * k5(ix) folds to a constant
__device__ __forceinline__ double k5(int i) {
    return i == 2 ? 3.0 / 8.0 : (i == 1 || i == 3) ? 1.0 / 4.0 : 1.0 / 16.0;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// ops/math.py luminance: the constants are Python floats, rounded to f32
__device__ __forceinline__ float luminance(float c0, float c1, float c2) {
    return (c0 * static_cast<float>(0.2126) +
            c1 * static_cast<float>(0.7152)) +
           c2 * static_cast<float>(0.0722);
}

// torch.sum over a contiguous inner dimension of three on the card
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
    return (x0 + x2) + x1;
}

// 1 / torch.clamp(sigma, min=1e-4), as reciprocal() * 1.0
__device__ __forceinline__ float inv_sigma(float s) {
    return 1.0f / clamp_minf(s, static_cast<float>(1e-4));
}

__device__ __forceinline__ float ld3(const Plane3& a, int64_t y, int64_t x,
                                     int c) {
    return __ldg(a.p + y * a.sy + x * a.sx + c * a.sc);
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
atrous_level_kernel(Plane3 img, int e_img, View view, int h, int w,
                    int level, const float* __restrict__ s_lum,
                    const float* __restrict__ s_norm,
                    const float* __restrict__ s_depth,
                    float* __restrict__ out) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    if (x >= w || y >= h) return;
    const int stride = 1 << level;
    const float inv_sl = inv_sigma(__ldg(s_lum));
    const float inv_sn = inv_sigma(__ldg(s_norm));
    const float inv_sd = inv_sigma(__ldg(s_depth) *
                                   static_cast<float>(stride));

    const int64_t yi = y + e_img, yv = y + view.e;
    const float c0 = ld3(img, yi, x, 0), c1 = ld3(img, yi, x, 1),
                c2 = ld3(img, yi, x, 2);
    const float lum_c = luminance(c0, c1, c2);
    float cp[3], cn[3];
    for (int a = 0; a < 3; ++a) {
        cp[a] = ld3(view.pos, yv, x, a);
        cn[a] = ld3(view.nrm, yv, x, a);
    }
    const long long c_hash = __ldg(view.hash + yv * view.hsy + x * view.hsx);
    const bool c_valid = __ldg(view.valid + yv * view.vsy + x * view.vsx);

    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, wsum = 0.0f;
#pragma unroll
    for (int iy = 0; iy < 5; ++iy) {
        const int dy = (iy - 2) * stride;
        const int64_t qyi = clampi(y + dy, -e_img, h - 1 + e_img) + e_img;
        const int64_t qyv = clampi(y + dy, -view.e, h - 1 + view.e) + view.e;
#pragma unroll
        for (int ix = 0; ix < 5; ++ix) {
            const int64_t qx = clampi(x + (ix - 2) * stride, 0, w - 1);
            const float k = static_cast<float>(k5(iy) * k5(ix));
            const float q0 = ld3(img, qyi, qx, 0), q1 = ld3(img, qyi, qx, 1),
                        q2 = ld3(img, qyi, qx, 2);
            const float w_l =
                expf(-fabsf(luminance(q0, q1, q2) - lum_c) * inv_sl);
            float dn[3], dp[3];
            for (int a = 0; a < 3; ++a) {
                dn[a] = cn[a] - ld3(view.nrm, qyv, qx, a);
                dp[a] = cp[a] - ld3(view.pos, qyv, qx, a);
            }
            const float w_n = expf(
                -sum3(dn[0] * dn[0], dn[1] * dn[1], dn[2] * dn[2]) * inv_sn);
            const float w_x = expf(
                -sum3(dp[0] * dp[0], dp[1] * dp[1], dp[2] * dp[2]) * inv_sd);
            const bool gate =
                __ldg(view.hash + qyv * view.hsy + qx * view.hsx) == c_hash &&
                __ldg(view.valid + qyv * view.vsy + qx * view.vsx) &&
                c_valid;
            const float wt = k * w_l * w_n * w_x * (gate ? 1.0f : 0.0f);
            acc0 = acc0 + q0 * wt;
            acc1 = acc1 + q1 * wt;
            acc2 = acc2 + q2 * wt;
            wsum = wsum + wt;
        }
    }
    const float den = clamp_minf(wsum, static_cast<float>(1e-8));
    float* o = out + (static_cast<int64_t>(y) * w + x) * 3;
    o[0] = c_valid ? acc0 / den : c0;
    o[1] = c_valid ? acc1 / den : c1;
    o[2] = c_valid ? acc2 / den : c2;
}

}  // namespace

extern "C" {

// img: (h + 2 e_img, w, 3) f32; pos, nrm: (h + 2 e_view, w, 3) f32; hash:
// (h + 2 e_view, w) int64; valid: (h + 2 e_view, w) bool; every plane
// with its strides in elements; sigmas: f32 scalars on the device; out:
// (h, w, 3) f32, contiguous, apart from every input
int eidola_atrous_level(const float* img, int64_t i_sy, int64_t i_sx,
                        int64_t i_sc, int e_img, const float* pos,
                        int64_t p_sy, int64_t p_sx, int64_t p_sc,
                        const float* nrm, int64_t n_sy, int64_t n_sx,
                        int64_t n_sc, const long long* hash, int64_t h_sy,
                        int64_t h_sx, const unsigned char* valid,
                        int64_t v_sy, int64_t v_sx, int e_view, int h, int w,
                        int level, const float* s_lum, const float* s_norm,
                        const float* s_depth, float* out, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    const Plane3 im{img, i_sy, i_sx, i_sc};
    const View view{{pos, p_sy, p_sx, p_sc}, {nrm, n_sy, n_sx, n_sc},
                    hash, h_sy, h_sx, valid, v_sy, v_sx, e_view};
    const dim3 block(kBlockX, kBlockY);
    const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
    atrous_level_kernel<<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        im, e_img, view, h, w, level, s_lum, s_norm, s_depth, out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
