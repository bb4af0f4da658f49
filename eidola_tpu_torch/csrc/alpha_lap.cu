// One lap of the alpha HitTest's queue march for Hopper (sm_90a): the
// alpha test, the compaction and the sort keys of the queued rays in one
// launch (lap_prep), and the scatter of the re-trace's results back into
// the band in another (lap_merge).
//
// Replaces no TPU kernel: the JAX package's queue march
// (eidola_tpu/render/tracer.py:138-187) is XLA's gathers, selects and
// scatters.  On the card the port ran a lap as ~320 torch launches for an
// elementwise pass over at most 32,768 queued rays, and the frame (58
// laps on the standin at 1920x1080) was set by the host's dispatch, not
// by the card.  The two kernels take the place of all but the walk and
// the sort between them: render/tracer.py's `_march_lap` runs
//   lap_prep -> the stable sort of its keys (ops/packets.sort_order) ->
//   closest_hit_sorted(order=...) -> lap_merge.
// The texture fetch and the instance search are csrc/scene_fetch.cuh's,
// shared with csrc/shade_state.cu.
//
// lap_prep, one thread per queued lane k < n (i = sel[k], a band index):
//   - the alpha test of render/tracer.py's `_alpha_passthrough` on the
//     record (tri, t, u, v)[i]: the shading row (an upper-bound search of
//     the instances' tri_base on an instanced scene, the triangle itself on
//     a flat one), the uv interpolated with w0 = (1 - u) - v, the
//     material's base-colour alpha times the level-0 bilinear alpha of its
//     base texture (scene/textures.py's `_bilinear_level`: wrap modes,
//     combine order; the channels are independent, so alpha alone is the
//     same bits), 1 on the untextured 1x1 stack and for tex_id < 0; one
//     PCG advance of the lane's rng word (ops/rng.py); MASK passes through
//     below the cutoff, BLEND when the draw is >= the opacity;
//   - the budget and the re-trace segment of `_march_band` (occl: a test
//     is consumed and a solid hit occludes; else a re-trace is consumed);
//   - the wavefront sort key of ops/packets.py's `ray_sort_keys` over the
//     hop BVH's root box, under the layout `KEY` names, dead = tx < tn;
//   - writes the compact rays (o, d, tn, tx), the keys and the lap's
//     scratch (go, occ, budget left, rng word).
// lap_merge, one thread per queued lane, in place on the band: the record
// takes the re-trace's hit where go, the rng word, pending, occluded |=
// occ, the budget.  The queued indices are distinct, so no two threads
// write one element.
//
// Arithmetic: f32 built with -fmad=false, every operation in the plain
// version's order and rounding (IEEE division, floorf, round-to-nearest
// int -> float, truncating float -> int), uint32 words for the rng, so
// each lane's results equal the plain lap's bit for bit.
//
// What bounds it on this card: neither.  A lap moves ~260 bytes a lane
// (the band's record, rng, budget and ray, the triangle's material and
// uv rows, four texels, the compact rays and scratch out; ~80 bytes in
// lap_merge) and does ~100 operations a lane, so 32,768 lanes are ~3 us
// at 3.35 TB/s: each launch is bound by its own launch cost.  The design
// is the fewest launches: everything elementwise of a lap in two, one
// thread a lane, 256 threads a block.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "scene_fetch.cuh"

namespace {

using eidola::clamp_minf;
using eidola::clampf;

constexpr int kThreads = 256;
constexpr int64_t kMask = 1;     // scene/data.py ALPHA_MASK
constexpr int64_t kBlend = 2;    // ALPHA_BLEND

// the band's flat planes, indexed by the queued band indices
struct Band {
    const float* o;          // (R, 3)
    const float* d;          // (R, 3)
    const float* tmax;       // (R,)
    int64_t* tri;
    float* t;
    float* u;
    float* v;
    int64_t* rng;            // uint32 words held in int64
    bool* pending;
    bool* occluded;
    int64_t* bleft;
};

// what the alpha test reads of the scene (int arrays are int64)
struct Tables {
    const int64_t* tri_mat;      // (T,)
    const float* tri_uv;         // (T, 3, 2)
    const float* base_color;     // (M, 4)
    const int64_t* base_tex;     // (M,)
    const int64_t* alpha_mode;   // (M,)
    const float* alpha_cutoff;   // (M,)
    eidola::TexStack tex;
    eidola::InstSearch inst;     // tri_base nullptr on a flat scene
};

// the lap's compact outputs, (n,) or (n, 3)
struct Lap {
    float* o;
    float* d;
    float* tn;
    float* tx;
    int64_t* keys;
    bool* go;
    bool* occ;
    int64_t* bleft;
    int64_t* rng;
};

// ops/packets.py _expand_bits_u32
__device__ __forceinline__ uint64_t expand_bits(uint64_t v) {
    v = (v * 0x00010001ull) & 0xFF0000FFull;
    v = (v * 0x00000101ull) & 0x0F00F00Full;
    v = (v * 0x00000011ull) & 0xC30C30C3ull;
    v = (v * 0x00000005ull) & 0x49249249ull;
    return v;
}

__device__ uint64_t morton(const float p[3], int bits) {
    const float scale = static_cast<float>(1 << bits);
    const float top = static_cast<float>((1 << bits) - 1);
    uint64_t q[3];
    for (int a = 0; a < 3; ++a)
        q[a] = static_cast<uint64_t>(
            static_cast<int64_t>(clampf(p[a] * scale, 0.0f, top)));
    return (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1) |
           expand_bits(q[2]);
}

// ops/packets.py ray_sort_keys; key 0 = o15d6, 1 = d3o21, 2 = o21d3
__device__ int64_t sort_key(const float* root, const float o[3],
                            const float d[3], bool dead, int key) {
    float p[3];
    for (int a = 0; a < 3; ++a) {
        const float ext = clamp_minf(root[3 + a] - root[a],
                                     static_cast<float>(1e-6));
        p[a] = clampf((o[a] - root[a]) / ext, 0.0f, 1.0f);
    }
    const uint64_t octant = (static_cast<uint64_t>(d[0] < 0.0f) << 2) |
                            (static_cast<uint64_t>(d[1] < 0.0f) << 1) |
                            static_cast<uint64_t>(d[2] < 0.0f);
    const uint64_t dead_u = static_cast<uint64_t>(dead) << 30;
    if (key == 1) return static_cast<int64_t>(dead_u | (octant << 21) |
                                              morton(p, 7));
    if (key == 0) {
        uint64_t d6 = 0;
        for (int a = 0; a < 3; ++a) {
            const int64_t dq = static_cast<int64_t>(
                clampf((d[a] + 1.0f) * 2.0f, 0.0f, 3.0f));
            d6 |= static_cast<uint64_t>(dq) << (4 - 2 * a);
        }
        return static_cast<int64_t>(dead_u | (morton(p, 5) << 6) | d6);
    }
    return static_cast<int64_t>(dead_u | (morton(p, 7) << 3) | octant);
}

__global__ void __launch_bounds__(kThreads)
lap_prep_kernel(const int64_t* __restrict__ sel, int n, Band band,
                Tables tb, const float* __restrict__ root, int occl,
                int key, Lap out) {
    const int k = blockIdx.x * kThreads + threadIdx.x;
    if (k >= n) return;
    const int64_t i = sel[k];
    const int64_t tri = band.tri[i];
    const float t = band.t[i], u = band.u[i], v = band.v[i];

    // the alpha test (render/tracer.py _alpha_passthrough)
    int inst;
    const int64_t row = eidola::shade_row(tb.inst, tri > 0 ? tri : 0, &inst);
    const int64_t mat = tb.tri_mat[row];
    const int64_t am = tb.alpha_mode[mat];
    const float* uvs = tb.tri_uv + row * 6;
    const float w0 = (1.0f - u) - v;
    const float uv0 = uvs[0] * w0 + uvs[2] * u + uvs[4] * v;
    const float uv1 = uvs[1] * w0 + uvs[3] * u + uvs[5] * v;
    float tex_a = 1.0f;
    if (!tb.tex.untextured) {
        const int64_t tex_id = tb.base_tex[mat];
        float c[4];
        eidola::bilinear_level<3>(tb.tex, tex_id > 0 ? tex_id : 0, uv0, uv1,
                                  0, c);
        if (tex_id >= 0) tex_a = c[3];
    }
    const float opac = tb.base_color[mat * 4 + 3] * tex_a;
    uint32_t s = static_cast<uint32_t>(band.rng[i]);
    s = s * 747796405u + 2891336453u;
    uint32_t word = ((s >> ((s >> 28) + 4)) ^ s) * 277803737u;
    word = (word >> 22) ^ word;
    const float draw = __uint_as_float((word >> 9) | 0x3F800000u) - 1.0f;
    const bool pt = tri >= 0 &&
                    ((am == kMask && opac < tb.alpha_cutoff[mat]) ||
                     (am == kBlend && draw >= opac));

    // the budget and the re-trace segment (render/tracer.py _march_band)
    int64_t b = band.bleft[i];
    bool go, occ;
    if (occl) {
        b -= 1;                   // a test consumed
        occ = !pt;                // a solid hit occludes
        go = pt && b > 0;
    } else {
        occ = false;
        go = pt;
        b -= go;                  // a re-trace consumed
    }
    const float tn = go ? t * static_cast<float>(1.0 + 1e-4) +
                              static_cast<float>(1e-5)
                        : 1.0f;
    const float tx = go ? band.tmax[i] : -1.0f;

    float o[3], d[3];
    for (int a = 0; a < 3; ++a) {
        o[a] = band.o[i * 3 + a];
        d[a] = band.d[i * 3 + a];
        out.o[k * 3 + a] = o[a];
        out.d[k * 3 + a] = d[a];
    }
    out.tn[k] = tn;
    out.tx[k] = tx;
    out.keys[k] = sort_key(root, o, d, tx < tn, key);
    out.go[k] = go;
    out.occ[k] = occ;
    out.bleft[k] = b;
    out.rng[k] = static_cast<int64_t>(s);
}

__global__ void __launch_bounds__(kThreads)
lap_merge_kernel(const int64_t* __restrict__ sel, int n, Band band,
                 const int64_t* __restrict__ tri2,
                 const float* __restrict__ t2, const float* __restrict__ u2,
                 const float* __restrict__ v2, Lap lap, int occl) {
    const int k = blockIdx.x * kThreads + threadIdx.x;
    if (k >= n) return;
    const int64_t i = sel[k];
    const bool go = lap.go[k];
    if (go) {
        band.tri[i] = tri2[k];
        band.t[i] = t2[k];
        band.u[i] = u2[k];
        band.v[i] = v2[k];
    }
    const int64_t b = lap.bleft[k];
    band.rng[i] = lap.rng[k];
    band.pending[i] = go && tri2[k] >= 0 && (occl || b > 0);
    if (lap.occ[k]) band.occluded[i] = true;
    band.bleft[i] = b;
}

Band make_band(const float* o, const float* d, const float* tmax,
               int64_t* tri, float* t, float* u, float* v, int64_t* rng,
               bool* pending, bool* occluded, int64_t* bleft) {
    return Band{o, d, tmax, tri, t, u, v, rng, pending, occluded, bleft};
}

Lap make_lap(float* o, float* d, float* tn, float* tx, int64_t* keys,
             bool* go, bool* occ, int64_t* bleft, int64_t* rng) {
    return Lap{o, d, tn, tx, keys, go, occ, bleft, rng};
}

}  // namespace

extern "C" {

// band: o, d, tmax, tri, t, u, v, rng, pending, occluded, bleft;
// lap outputs: o, d, tn, tx, keys, go, occ, bleft, rng
int eidola_lap_prep(const int64_t* sel, int n, const float* o, const float* d,
                    const float* tmax, int64_t* tri, float* t, float* u,
                    float* v, int64_t* rng, bool* pending, bool* occluded,
                    int64_t* bleft, const int64_t* tri_mat,
                    const float* tri_uv, const float* base_color,
                    const int64_t* base_tex, const int64_t* alpha_mode,
                    const float* alpha_cutoff, const float* tex,
                    const int64_t* tex_size, const int64_t* tex_wrap,
                    int64_t tex_h, int64_t tex_w2, int untextured,
                    const int64_t* tri_base, const int64_t* attr_base,
                    int n_inst, const float* root, int occl, int key,
                    float* lo, float* ld, float* ltn, float* ltx,
                    int64_t* lkeys, bool* lgo, bool* locc, int64_t* lbleft,
                    int64_t* lrng, void* stream) {
    if (n <= 0) return 0;
    const Band band = make_band(o, d, tmax, tri, t, u, v, rng, pending,
                                occluded, bleft);
    const Tables tb{tri_mat, tri_uv, base_color, base_tex, alpha_mode,
                    alpha_cutoff,
                    {tex, tex_size, tex_wrap, tex_h, tex_w2, untextured},
                    {tri_base, attr_base, n_inst}};
    const Lap out = make_lap(lo, ld, ltn, ltx, lkeys, lgo, locc, lbleft, lrng);
    const int grid = (n + kThreads - 1) / kThreads;
    lap_prep_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        sel, n, band, tb, root, occl, key, out);
    return static_cast<int>(cudaGetLastError());
}

int eidola_lap_merge(const int64_t* sel, int n, const float* o,
                     const float* d, const float* tmax, int64_t* tri,
                     float* t, float* u, float* v, int64_t* rng,
                     bool* pending, bool* occluded, int64_t* bleft,
                     const int64_t* tri2, const float* t2, const float* u2,
                     const float* v2, float* lo, float* ld, float* ltn,
                     float* ltx, int64_t* lkeys, bool* lgo, bool* locc,
                     int64_t* lbleft, int64_t* lrng, int occl,
                     void* stream) {
    if (n <= 0) return 0;
    const Band band = make_band(o, d, tmax, tri, t, u, v, rng, pending,
                                occluded, bleft);
    const Lap lap = make_lap(lo, ld, ltn, ltx, lkeys, lgo, locc, lbleft, lrng);
    const int grid = (n + kThreads - 1) / kThreads;
    lap_merge_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        sel, n, band, tri2, t2, u2, v2, lap, occl);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
