// Per-event BVH leaf intersection for Hopper (sm_90a).
//
// Replaces the Pallas kernel of eidola_tpu/ops/bvh_mxu.py:
//   mt_mxu (_kernel, bvh_mxu.py:83-124; call :151)
//
// Input is a list of CE leaf events, each one gathered leaf row of n
// triangles (v0, e1, e2, pad: 12 f32 each) and 128 ray lanes.  Moller-
// Trumbore's four determinant forms are linear in ten ray features
// f = [o - a, d, (o - a) x d, 1] (a = the leaf's first vertex), so per
// event the TPU kernel ran one (4n x 16) @ (16 x 128) product on its
// matrix unit, then the epilogue (det guard 1e-12, inv = 1/det,
// t/u/v = num * inv, inside test, tmin < t < tlim) and a per-lane
// minimum over the n triangles, lowest index on ties.  Output per lane:
// (t, k, u, v), with t = 1e30, k = 0, u = v = 0 on a miss.  Nothing
// folds across events.
//
// What bounds it on this card: per lane and triangle the function needs
// the products by the 19 nonzero coefficients, their 15 sums and the
// epilogue (~44 f32 operations), against ~9 KB per event in and out (the
// 3 KB leaf row at n = 64, 8 ray planes in, 4 planes out).  At n = 64
// that is ~39 operations per byte, twice the H100's f32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20): it is operations-bound.  This kernel
// does 4 full dots of 10 products and 9 sums (~90 operations, zero
// coefficients included, and without FMA contraction each its own
// instruction), about twice what the bound counts.
//
// Design (simple and right first; speed is later work):
//  - One 128-thread block per event, one thread per lane.  The TPU
//    kernel's (CE, 4n, 16) coefficient and (CE, 16, 128) feature tensors
//    are never written to device memory: the block builds its event's
//    4n x 10 used coefficients in shared memory from the leaf row (10 KB
//    at n = 64, one triangle per thread), and each thread forms its
//    lane's 10 features in registers.
//  - Each thread loops over the n triangles with the epilogue and a
//    strict-< running minimum from +inf, which keeps the lowest index
//    attaining the minimum, as the Pallas kernel's iota-min does.
//  - Every dot sums features 0..9 in order, zero coefficients included;
//    built with -fmad=false and no fast math, and t = tn * (1/det), so
//    every product and sum rounds like the plain torch version
//    (ops/bvh_mxu.py:mt_mxu_ref) and the two agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LANES 128
#define NFEAT 10
#define BIG 1e30f

struct Rays {
    const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tlim;
};

__device__ __forceinline__ void put(float* c, float f0, float f1, float f2,
                                    float f3, float f4, float f5, float f6,
                                    float f7, float f8, float f9) {
    c[0] = f0; c[1] = f1; c[2] = f2; c[3] = f3; c[4] = f4;
    c[5] = f5; c[6] = f6; c[7] = f7; c[8] = f8; c[9] = f9;
}

__device__ __forceinline__ float dot10(const float* c, const float* f) {
    float acc = c[0] * f[0];
#pragma unroll
    for (int j = 1; j < NFEAT; ++j) acc = acc + c[j] * f[j];
    return acc;
}

// coefficient column (block, k) at cm[(block * N + k) * NFEAT]
template <int N>
__global__ void __launch_bounds__(LANES)
mt_mxu_kernel(const float* __restrict__ row, Rays R,
              float* __restrict__ t_out, int* __restrict__ k_out,
              float* __restrict__ u_out, float* __restrict__ v_out) {
    __shared__ float cm[4 * N * NFEAT];
    const int e = blockIdx.x;
    const float* tri = row + (size_t)e * N * 12;
    const float ax = tri[0], ay = tri[1], az = tri[2];
    for (int k = threadIdx.x; k < N; k += LANES) {
        const float* p = tri + k * 12;
        const float v0x = p[0] - ax, v0y = p[1] - ay, v0z = p[2] - az;
        const float e1x = p[3], e1y = p[4], e1z = p[5];
        const float e2x = p[6], e2y = p[7], e2z = p[8];
        const float nx = e1y * e2z - e1z * e2y;
        const float ny = e1z * e2x - e1x * e2z;
        const float nz = e1x * e2y - e1y * e2x;
        const float ct = -((v0x * nx + v0y * ny) + v0z * nz);
        const float ux = v0y * e2z - v0z * e2y;     // (v0 - a) x e2
        const float uy = v0z * e2x - v0x * e2z;
        const float uz = v0x * e2y - v0y * e2x;
        const float wx = e1y * v0z - e1z * v0y;     // e1 x (v0 - a)
        const float wy = e1z * v0x - e1x * v0z;
        const float wz = e1x * v0y - e1y * v0x;
        put(cm + (0 * N + k) * NFEAT, 0.f, 0.f, 0.f, -nx, -ny, -nz,
            0.f, 0.f, 0.f, 0.f);
        put(cm + (1 * N + k) * NFEAT, nx, ny, nz, 0.f, 0.f, 0.f,
            0.f, 0.f, 0.f, ct);
        put(cm + (2 * N + k) * NFEAT, 0.f, 0.f, 0.f, ux, uy, uz,
            e2x, e2y, e2z, 0.f);
        put(cm + (3 * N + k) * NFEAT, 0.f, 0.f, 0.f, wx, wy, wz,
            -e1x, -e1y, -e1z, 0.f);
    }
    __syncthreads();

    const size_t off = (size_t)e * LANES + threadIdx.x;
    const float ox = R.ox[off] - ax, oy = R.oy[off] - ay, oz = R.oz[off] - az;
    const float dx = R.dx[off], dy = R.dy[off], dz = R.dz[off];
    float f[NFEAT];
    f[0] = ox; f[1] = oy; f[2] = oz;
    f[3] = dx; f[4] = dy; f[5] = dz;
    f[6] = oy * dz - oz * dy;
    f[7] = oz * dx - ox * dz;
    f[8] = ox * dy - oy * dx;
    f[9] = 1.0f;
    const float tmin = R.tmin[off];
    const float tlim = R.tlim[off];

    float tb = INFINITY, ub = 0.f, vb = 0.f;
    int kb = 0;
#pragma unroll 2
    for (int k = 0; k < N; ++k) {
        const float det = dot10(cm + (0 * N + k) * NFEAT, f);
        const float tn = dot10(cm + (1 * N + k) * NFEAT, f);
        const float un = dot10(cm + (2 * N + k) * NFEAT, f);
        const float vn = dot10(cm + (3 * N + k) * NFEAT, f);
        const bool ok = fabsf(det) > 1e-12f;
        const float inv = ok ? 1.0f / det : 0.0f;
        const float t = tn * inv, u = un * inv, v = vn * inv;
        const bool hit = ok && u >= 0.f && v >= 0.f && u + v <= 1.0f &&
                         t > tmin && t < tlim;
        const float tm = hit ? t : BIG;
        if (tm < tb) { tb = tm; kb = k; ub = u; vb = v; }
    }
    const bool miss = tb >= BIG;
    t_out[off] = tb;
    k_out[off] = miss ? 0 : kb;
    u_out[off] = miss ? 0.f : ub;
    v_out[off] = miss ? 0.f : vb;
}

extern "C" {

int eidola_mt_mxu(const float* row, const float* ox, const float* oy,
                  const float* oz, const float* dx, const float* dy,
                  const float* dz, const float* tmin, const float* tlim,
                  float* t_out, int* k_out, float* u_out, float* v_out,
                  int ce, int n, void* stream) {
    if (ce <= 0) return 0;
    Rays R{ox, oy, oz, dx, dy, dz, tmin, tlim};
    cudaStream_t s = (cudaStream_t)stream;
    if (n == 64)
        mt_mxu_kernel<64><<<ce, LANES, 0, s>>>(row, R, t_out, k_out, u_out,
                                               v_out);
    else if (n == 8)
        mt_mxu_kernel<8><<<ce, LANES, 0, s>>>(row, R, t_out, k_out, u_out,
                                              v_out);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
