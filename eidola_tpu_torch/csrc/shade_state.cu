// The shading state of closest hits for Hopper (sm_90a): everything
// render/shade_state.py's `get_state` derives from a hit record in one
// launch.
//
// Replaces no TPU kernel: the JAX package's `get_state`
// (eidola_tpu/render/shade_state.py) is XLA's gathers and elementwise
// work.  On the card the port ran one call as ~830 torch launches
// without a cone and ~1,400 with one (about 1,060 of them the four
// texture fetches of scene/textures.py), six calls a default frame, all
// dispatched by the host while the card waited.  `get_state` launches
// this kernel once a call on the card and keeps its torch body
// (`get_state_ref`) for the CPU.
//
// One thread a lane, 256 threads a block.  A lane:
//   - reads its ray (o, d) and record (tri, t, u, v) through their own
//     strides (no copy of a strided or broadcast view);
//   - lanes with tri < 0 write the invalid state's constants and read
//     nothing else;
//   - the attribute row of the hit (scene_fetch.cuh `shade_row`: an
//     upper-bound search of the instances' tri_base, the triangle itself
//     on a flat scene), the ray-cone footprint (t * cone) * uv density
//     (* the instance's uv scale), the hit point, the octahedral vertex
//     and geometric normals mixed with w = (1 - u) - v, the instance's
//     normal rotation and mirror sign, the flips against the ray and the
//     geometric normal;
//   - the material's four textures (base, metal-rough, emissive, normal):
//     level 0 without a cone, else the trilinear lod of the footprint
//     with the mip clamp, the two bilinear levels of scene_fetch.cuh's
//     `bilinear_level` (wrap modes, atlas offsets) and their blend; a
//     texture id < 0 and the untextured 1x1 stack read white without a
//     load; the vertex colours, albedo, opacity, metallic, roughness and
//     emission;
//   - where the material has a normal map, the tangent frame (the
//     instance's rotation, Gram-Schmidt against the shading normal, the
//     bitangent's handedness) and the mapped normal.
// Work whose result torch.where discards (an invalid lane's, a white
// texture's, the normal map of a material without one) is skipped.
//
// Arithmetic: f32 built with -fmad=false and no fast math, every
// operation in the torch code's order and rounding on the card: IEEE
// division, sqrt and reciprocal; log2f, floorf, ceilf; int64 where torch
// computes in int64; torch.clamp / torch.minimum letting NaN through;
// a division by a Python float as torch's CUDA division by a CPU scalar
// does it, a product with the f32 reciprocal; the three-term
// torch.sum(dim=-1) as its CUDA reduction adds an inner dimension of
// three (two threads from zero: elements 0 and 2, then 1, so -0 sums to
// +0); torch.linalg.cross as its CUDA kernel rounds, a * b - c * d
// contracted to fma(a, b, -(c * d)).  So every field equals the torch
// get_state's on the same card bit for bit.
//
// What bounds it on this card: dependent gathers.  A lane reads ~170
// bytes of its own (ray, record, outputs) and, hit by hit, the
// instance search (~12 steps over 3,646 entries on the stand-in),
// ~130 bytes of attribute rows, ~80 of instance and material entries
// and up to 4 textures x 2 levels x 4 texels of 16 bytes: ~800 bytes
// at most, ~0.5 ms for 2.07M lanes at 3.35 TB/s.  Each load depends on
// the one before (tri -> row -> material -> texture -> texels), so the
// kernel is bound by the latency of its chains, not by bytes or
// operations.  The design keeps many lanes in flight: the small tables
// (instances, materials, texture sizes) are read through the read-only
// cache and stay in L1/L2, a texel is one 16-byte load, the lane's
// loads of one step go out together, results are stored as soon as
// they are final so that few values stay live, and no shared memory is
// used.  Its time is far below the host's dispatch of the launches it
// replaces.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "scene_fetch.cuh"

namespace {

using eidola::clamp_minf;
using eidola::clampf;
using eidola::ldg64;

constexpr int kThreads = 256;

// the per-lane inputs, each lane at `lane * stride` (elements): the
// leading dimensions of every input walked as one
struct Lanes {
    int64_t n;                // lanes
    const float* o;           // (..., 3)
    int64_t so, so3;          // the lane's stride, the component's
    const float* d;           // (..., 3)
    int64_t sd, sd3;
    const int64_t* tri;       // (...)
    int64_t stri;
    const float* t;
    int64_t st;
    const float* u;
    int64_t su;
    const float* v;
    int64_t sv;
    const float* cone;        // a 0-d f32 on the card, or nullptr
    float cone_value;         // the cone where `cone` is nullptr
    int has_cone;             // 0: no footprint, level 0
};

// what get_state reads of the scene (contiguous; int arrays are int64)
struct Tables {
    const int64_t* tri_gn;          // (T,) octahedral words
    const int64_t* tri_nrm;         // (T, 3)
    const float* tri_uv;            // (T, 3, 2)
    const int64_t* tri_tangent;     // (T, 3)
    const float* tri_hand;          // (T, 3)
    const int64_t* tri_color;       // (T, 3) unorm4x8 words
    const int64_t* tri_mat;         // (T,)
    const float* tri_uv_density;    // (T,)
    const float* base_color;        // (M, 4)
    const float* emissive;          // (M, 3)
    const float* metallic;          // (M,)
    const float* roughness;
    const float* ior;
    const float* transmission;
    const int64_t* base_tex;        // (M,) texture ids, -1 for none
    const int64_t* mr_tex;
    const int64_t* normal_tex;
    const int64_t* emissive_tex;
    eidola::TexStack tex;
    int64_t max_level;              // bit_length(W2 / 2) - 1, at least 0
    eidola::InstSearch inst;        // tri_base nullptr on a flat scene
    const float* rot;               // (I, 9) object -> world
    const float* nrm_rot;           // (I, 9) its inverse transpose
    const float* det_sign;          // (I,)
    const float* uvd_scale;         // (I,)
};

// render/shade_state.py State's fields, contiguous over the lanes
struct Out {
    float* pos;             // (..., 3)
    float* nrm;             // (..., 3)
    float* geo_nrm;         // (..., 3)
    float* uv;              // (..., 2)
    float* albedo;          // (..., 3)
    float* opacity;         // (...)
    float* metallic;
    float* roughness;
    float* ior;
    float* transmission;
    float* emission;        // (..., 3)
    int64_t* mat_id;
    bool* valid;
};

// x / c for a Python float c: torch's CUDA division by a CPU scalar
// multiplies by the f32 reciprocal
constexpr float kInv32767 = 1.0f / 32767.0f;
constexpr float kInv255 = 1.0f / 255.0f;

// torch.sum(dim=-1) over an inner dimension of three on the card
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
    return __fadd_rn(__fadd_rn(__fadd_rn(x0, x2), x1), 0.0f);
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
    return sum3(a[0] * b[0], a[1] * b[1], a[2] * b[2]);
}

// ops/math.py normalize, in place
__device__ __forceinline__ void normalize(float v[3]) {
    const float len = sqrtf(clamp_minf(dot3(v, v), 0.0f));
    const float r = 1.0f / clamp_minf(len, static_cast<float>(1e-20));
    v[0] = v[0] * r;
    v[1] = v[1] * r;
    v[2] = v[2] * r;
}

// torch.linalg.cross(a, b) as torch's CUDA kernel rounds it
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
    out[0] = __fmaf_rn(a[1], b[2], -(a[2] * b[1]));
    out[1] = __fmaf_rn(a[2], b[0], -(a[0] * b[2]));
    out[2] = __fmaf_rn(a[0], b[1], -(a[1] * b[0]));
}

// ops/octahedral.py decode_unit_u32 (oct_to_dir of the snorm16x2 word)
__device__ __forceinline__ void decode_unit(int64_t p, float out[3]) {
    int64_t lo = p & 0xFFFF, hi = (p >> 16) & 0xFFFF;
    lo = lo >= 32768 ? lo - 65536 : lo;
    hi = hi >= 32768 ? hi - 65536 : hi;
    const float x = static_cast<float>(lo) * kInv32767;
    const float y = static_cast<float>(hi) * kInv32767;
    const float z = (1.0f - fabsf(x)) - fabsf(y);
    const float wx = (1.0f - fabsf(y)) * (x >= 0.0f ? 1.0f : -1.0f);
    const float wy = (1.0f - fabsf(x)) * (y >= 0.0f ? 1.0f : -1.0f);
    const bool below = z < 0.0f;
    const float ox = below ? wx : x, oy = below ? wy : y;
    const float n = clamp_minf(sqrtf(sum3(ox * ox, oy * oy, z * z)),
                               static_cast<float>(1e-20));
    out[0] = ox / n;
    out[1] = oy / n;
    out[2] = z / n;
}

// render/shade_state.py _bary_mix of one component
__device__ __forceinline__ float bary(float a0, float a1, float a2, float w,
                                      float u, float v) {
    return (a0 * w + a1 * u) + a2 * v;
}

// scene/data.py rot_apply: a row-major 3x3 applied in place
__device__ __forceinline__ void rot_apply(const float* m, float x[3]) {
    float r[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
        r[k] = (__ldg(m + 3 * k) * x[0] + __ldg(m + 3 * k + 1) * x[1]) +
               __ldg(m + 3 * k + 2) * x[2];
    x[0] = r[0];
    x[1] = r[1];
    x[2] = r[2];
}

// the lane's three vertices of a (T, 3) octahedral-word table, mixed
__device__ __forceinline__ void mixed_dir(const int64_t* words, int64_t row,
                                          float w, float u, float v,
                                          float out[3]) {
    float a[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) decode_unit(ldg64(words + row * 3 + j), a[j]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
        out[k] = bary(a[0][k], a[1][k], a[2][k], w, u, v);
}

// scene/textures.py sample_texture: RGBA of texture `tex_id` at uv, the
// trilinear lod of footprint `fp` where `cone`, else level 0; white for
// tex_id < 0 and on the untextured stack
__device__ void sample(const Tables& tb, int64_t tex_id, float uv0,
                       float uv1, bool cone, float fp, float out[4]) {
    out[0] = out[1] = out[2] = out[3] = 1.0f;
    if (tb.tex.untextured || tex_id < 0) return;
    if (!cone) {
        eidola::bilinear_level<0>(tb.tex, tex_id, uv0, uv1, 0, out);
        return;
    }
    const int64_t h0 = ldg64(tb.tex.size + tex_id * 2);
    const int64_t w0 = ldg64(tb.tex.size + tex_id * 2 + 1);
    const float res = static_cast<float>(h0 > w0 ? h0 : w0);
    float lod = log2f(clamp_minf(fp * res, 1.0f));
    int64_t max_l = static_cast<int64_t>(ceilf(log2f(clamp_minf(res, 1.0f))));
    max_l = max_l < tb.max_level ? max_l : tb.max_level;
    const float max_lf = static_cast<float>(max_l);
    lod = clamp_minf(lod, 0.0f);
    lod = isnan(lod) ? lod : fminf(lod, max_lf);       // torch.minimum
    const int64_t l0 = static_cast<int64_t>(floorf(lod));
    const float fl = lod - static_cast<float>(l0);
    const int64_t l1 = l0 + 1 < max_l ? l0 + 1 : max_l;
    float c0[4], c1[4];
    eidola::bilinear_level<0>(tb.tex, tex_id, uv0, uv1, l0, c0);
    eidola::bilinear_level<0>(tb.tex, tex_id, uv0, uv1, l1, c1);
    const float gl = 1.0f - fl;
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = c0[c] * gl + c1[c] * fl;
}

__device__ __forceinline__ void store3(float* p, int64_t i, const float x[3]) {
    p[i * 3] = x[0];
    p[i * 3 + 1] = x[1];
    p[i * 3 + 2] = x[2];
}

__global__ void __launch_bounds__(kThreads)
shade_state_kernel(Lanes ln, Tables tb, Out out) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
    if (i >= ln.n) return;
    const int64_t tri = ldg64(ln.tri + i * ln.stri);
    if (tri < 0) {
        const float zero[3] = {0.0f, 0.0f, 0.0f};
        store3(out.pos, i, zero);
        store3(out.nrm, i, zero);
        store3(out.geo_nrm, i, zero);
        out.uv[i * 2] = 0.0f;
        out.uv[i * 2 + 1] = 0.0f;
        store3(out.albedo, i, zero);
        out.opacity[i] = 0.0f;
        out.metallic[i] = 0.0f;
        out.roughness[i] = 1.0f;
        out.ior[i] = 1.5f;
        out.transmission[i] = 0.0f;
        store3(out.emission, i, zero);
        out.mat_id[i] = -1;
        out.valid[i] = false;
        return;
    }
    const float t = __ldg(ln.t + i * ln.st), u = __ldg(ln.u + i * ln.su),
                v = __ldg(ln.v + i * ln.sv);
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        o[k] = __ldg(ln.o + i * ln.so + k * ln.so3);
        d[k] = __ldg(ln.d + i * ln.sd + k * ln.sd3);
    }
    int inst;
    const int64_t row = eidola::shade_row(tb.inst, tri, &inst);
    const bool instanced = tb.inst.tri_base != nullptr;
    const int64_t mat = ldg64(tb.tri_mat + row);
    float fp = 0.0f;
    if (ln.has_cone) {
        const float cone = ln.cone != nullptr ? __ldg(ln.cone) : ln.cone_value;
        fp = (t * cone) * __ldg(tb.tri_uv_density + row);
        if (instanced) fp = fp * __ldg(tb.uvd_scale + inst);
    }
    const float pos[3] = {o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t};
    store3(out.pos, i, pos);

    // normals: the vertex normals mixed, the geometric normal, each
    // rotated into world space on an instanced scene, then the flips
    const float w = (1.0f - u) - v;
    float nrm[3], geo[3];
    mixed_dir(tb.tri_nrm, row, w, u, v, nrm);
    decode_unit(ldg64(tb.tri_gn + row), geo);
    if (instanced) {
        const float* nr = tb.nrm_rot + static_cast<int64_t>(inst) * 9;
        rot_apply(nr, nrm);
        rot_apply(nr, geo);
        const float sg = __ldg(tb.det_sign + inst);
        geo[0] = geo[0] * sg;
        geo[1] = geo[1] * sg;
        geo[2] = geo[2] * sg;
        normalize(geo);
    }
    normalize(nrm);
    if (dot3(geo, d) > 0.0f) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            geo[k] = -geo[k];
            nrm[k] = -nrm[k];
        }
    }
    if (dot3(nrm, geo) < 0.0f) {
        nrm[0] = geo[0];
        nrm[1] = geo[1];
        nrm[2] = geo[2];
    }
    store3(out.geo_nrm, i, geo);

    const float* uvs = tb.tri_uv + row * 6;
    const float uv0 = bary(__ldg(uvs), __ldg(uvs + 2), __ldg(uvs + 4), w,
                           u, v);
    const float uv1 = bary(__ldg(uvs + 1), __ldg(uvs + 3), __ldg(uvs + 5), w,
                           u, v);
    out.uv[i * 2] = uv0;
    out.uv[i * 2 + 1] = uv1;
    out.mat_id[i] = mat;
    out.ior[i] = __ldg(tb.ior + mat);
    out.transmission[i] = __ldg(tb.transmission + mat);
    const bool cone = ln.has_cone != 0;

    // base colour x texture x vertex colour
    {
        float tex[4], vcol[4], col[3][4];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int64_t p = ldg64(tb.tri_color + row * 3 + j);
#pragma unroll
            for (int c = 0; c < 4; ++c)
                col[j][c] = static_cast<float>((p >> (8 * c)) & 0xFF) *
                            kInv255;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
            vcol[c] = bary(col[0][c], col[1][c], col[2][c], w, u, v);
        sample(tb, ldg64(tb.base_tex + mat), uv0, uv1, cone, fp, tex);
        float albedo[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
            albedo[c] = (__ldg(tb.base_color + mat * 4 + c) * tex[c]) *
                        vcol[c];
        store3(out.albedo, i, albedo);
        out.opacity[i] = (__ldg(tb.base_color + mat * 4 + 3) * tex[3]) *
                         vcol[3];
    }
    {
        float mr[4];
        sample(tb, ldg64(tb.mr_tex + mat), uv0, uv1, cone, fp, mr);
        out.metallic[i] = clampf(__ldg(tb.metallic + mat) * mr[2], 0.0f, 1.0f);
        out.roughness[i] = clampf(__ldg(tb.roughness + mat) * mr[1],
                                  static_cast<float>(0.02), 1.0f);
    }
    {
        float em[4], emission[3];
        sample(tb, ldg64(tb.emissive_tex + mat), uv0, uv1, cone, fp, em);
#pragma unroll
        for (int c = 0; c < 3; ++c)
            emission[c] = __ldg(tb.emissive + mat * 3 + c) * em[c];
        store3(out.emission, i, emission);
    }

    // the normal map in the tangent frame
    const int64_t ntex = ldg64(tb.normal_tex + mat);
    if (ntex >= 0) {
        float tan[3], bit[3], nm[4];
        mixed_dir(tb.tri_tangent, row, w, u, v, tan);
        if (instanced)
            rot_apply(tb.rot + static_cast<int64_t>(inst) * 9, tan);
        normalize(tan);
        const float* hs = tb.tri_hand + row * 3;
        const float hand = bary(__ldg(hs), __ldg(hs + 1), __ldg(hs + 2), w, u,
                                v);
        const float td = dot3(tan, nrm);
#pragma unroll
        for (int k = 0; k < 3; ++k) tan[k] = tan[k] - nrm[k] * td;
        normalize(tan);
        cross(nrm, tan, bit);
        // torch.sign: -1, 0 or 1 (0 for +-0 and NaN)
        const float sg = static_cast<float>((0.0f < hand) - (hand < 0.0f));
#pragma unroll
        for (int k = 0; k < 3; ++k) bit[k] = bit[k] * sg;
        sample(tb, ntex, uv0, uv1, cone, fp, nm);
        const float n0 = nm[0] * 2.0f - 1.0f, n1 = nm[1] * 2.0f - 1.0f,
                    n2 = nm[2] * 2.0f - 1.0f;
        float mapped[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
            mapped[k] = (tan[k] * n0 + bit[k] * n1) + nrm[k] * n2;
        normalize(mapped);
        nrm[0] = mapped[0];
        nrm[1] = mapped[1];
        nrm[2] = mapped[2];
    }
    store3(out.nrm, i, nrm);
    out.valid[i] = true;
}

}  // namespace

extern "C" {

// sizeof(Lanes), sizeof(Tables), sizeof(Out): the wrapper checks its
// ctypes mirrors of the three structs against them
void eidola_shade_state_abi(int64_t* sizes) {
    sizes[0] = sizeof(Lanes);
    sizes[1] = sizeof(Tables);
    sizes[2] = sizeof(Out);
}

// lanes, tables, out: a Lanes, a Tables and an Out (void pointers: a C
// function of the library's types would not be exported)
int eidola_shade_state(const void* lanes, const void* tables,
                       const void* out, void* stream) {
    const Lanes& ln = *static_cast<const Lanes*>(lanes);
    if (ln.n <= 0) return 0;
    const int64_t grid = (ln.n + kThreads - 1) / kThreads;
    shade_state_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        ln, *static_cast<const Tables*>(tables),
        *static_cast<const Out*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
