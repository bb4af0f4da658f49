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
// (67 TFLOP/s / 3.35 TB/s = 20): it is operations-bound, and built
// without FMA contraction each product and sum is its own instruction.
//
// Design (the closest-hit drain's, mt_tri4.cuh, without the fold):
//  - A 128-thread block (one thread per lane) takes a fixed run of
//    consecutive events.  The TPU kernel's (CE, 4n, 16) coefficient and
//    (CE, 16, 128) feature tensors are never written to device memory:
//    for each event the block builds the 19 nonzero coefficient rows of
//    its n triangles (build_cmat's formulas, one triangle a thread) into
//    shared memory in mt_tri4.cuh's staged layout, and each thread forms
//    its lane's features in registers.
//  - Pipelined over the block's events with one barrier each: event
//    r + 2's leaf row starts its cp.async and event r + 1's rays load
//    into registers while event r is tested; right after its own test a
//    thread builds its share of event r + 1's coefficients into the other
//    buffer.
//  - Four triangles at a time from float4 reads (one 16-byte broadcast
//    load per coefficient row and four triangles), the reciprocals after
//    one warp-uniform range check (rcp_in_range), a warp vote after the
//    u test that skips a triangle no lane can hit; a dead lane
//    (t_lim <= t_min) joins no vote.  A miss keeps (1e30, 0, 0, 0), the
//    t test is strict (t < t_lim), the strict-< minimum keeps the lowest
//    k, as the Pallas kernel's iota-min does.
//  - Every dot sums its nonzero products in feature order; built with
//    -fmad=false and no fast math, and t = tn * (1/det), so every product
//    and sum rounds like the plain torch version (ops/bvh_mxu.py:
//    mt_mxu_ref) and the two agree bit for bit.
//
// Times (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py, the whole wrapper
// call): 1.12 ms on the largest drain of a 1080p bistro_standin DI frame
// (85,475 events, n = 64; 14% of (event, warp, triangle) pass the vote),
// against 2.59 ms for the one-event-a-block kernel with dense dots and an
// IEEE division per triangle that this replaced, 1.25 ms for mt_fused on
// the same events, and a bound of 0.46 ms.

#include "mt_tri4.cuh"

// events a block takes, by drain size: runs of up to MXU_EVENTS for a
// large drain, one event a block for a small one so that it still spreads
// over the card (132 SMs x 4 blocks, 8 waves)
#define MXU_EVENTS 8
static int events_per_block(int ce) {
    const int c = ce / (132 * 4 * 8);
    return c < 1 ? 1 : (c > MXU_EVENTS ? MXU_EVENTS : c);
}

// start the copy of event e's leaf row (N x 12 floats) into buf
template <int N>
__device__ __forceinline__ void stage_row(float* buf, const float* row,
                                          int e) {
    const float* src = row + (size_t)e * N * 12;
    for (int c = threadIdx.x; c < N * 3; c += LANES)
        cp_async16(buf + c * 4, src + c * 4);
    cp_async_commit();
}

// build_cmat's 19 nonzero coefficients of triangle k (< N) of a staged
// leaf row, into mt_tri4.cuh's staged layout
template <int N>
__device__ __forceinline__ void build_tri(float* cm, const float* tri,
                                          int k) {
    const float* p = tri + k * 12;
    const float v0x = p[0] - tri[0], v0y = p[1] - tri[1];
    const float v0z = p[2] - tri[2];
    const float e1x = p[3], e1y = p[4], e1z = p[5];
    const float e2x = p[6], e2y = p[7], e2z = p[8];
    const float nx = e1y * e2z - e1z * e2y;
    const float ny = e1z * e2x - e1x * e2z;
    const float nz = e1x * e2y - e1y * e2x;
    float* c = cm + k;
    c[0 * N] = -nx;  c[1 * N] = -ny;  c[2 * N] = -nz;
    c[3 * N] = nx;   c[4 * N] = ny;   c[5 * N] = nz;
    c[6 * N] = -((v0x * nx + v0y * ny) + v0z * nz);
    c[7 * N] = v0y * e2z - v0z * e2y;     // (v0 - a) x e2
    c[8 * N] = v0z * e2x - v0x * e2z;
    c[9 * N] = v0x * e2y - v0y * e2x;
    c[10 * N] = e2x;  c[11 * N] = e2y;  c[12 * N] = e2z;
    c[13 * N] = e1y * v0z - e1z * v0y;    // e1 x (v0 - a)
    c[14 * N] = e1z * v0x - e1x * v0z;
    c[15 * N] = e1x * v0y - e1y * v0x;
    c[16 * N] = -e1x;  c[17 * N] = -e1y;  c[18 * N] = -e1z;
}

template <int N>
__global__ void __launch_bounds__(LANES, 4)
mt_mxu_kernel(const float* __restrict__ row, Rays R,
              float* __restrict__ t_out, int* __restrict__ k_out,
              float* __restrict__ u_out, float* __restrict__ v_out,
              int ce, int per_block) {
    __shared__ __align__(16) float raw[2][N * 12];
    __shared__ __align__(16) float cm[2][NCOEF * N];
    int e = blockIdx.x * per_block;
    const int e1 = min(ce, e + per_block);

    stage_row<N>(raw[0], row, e);
    if (e + 1 < e1) stage_row<N>(raw[1], row, e + 1);
    cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x < N) build_tri<N>(cm[0], raw[0], threadIdx.x);
    Event ev = load_event(R, (size_t)e * LANES + threadIdx.x, raw[0][0],
                          raw[0][1], raw[0][2]);

    for (int b = 0;; ++e, b ^= 1) {
        // cm[b] is built and raw[b ^ 1] holds leaf e + 1 (everyone's
        // copies have landed); raw[b] was read by cm[b]'s build, and
        // nobody reads cm[b ^ 1] any more
        cp_async_wait_all();
        __syncthreads();
        const bool more = e + 1 < e1;
        Event nx = ev;
        if (more) {
            if (e + 2 < e1) stage_row<N>(raw[b], row, e + 2);
            const float* a = raw[b ^ 1];
            nx = load_event(R, (size_t)(e + 1) * LANES + threadIdx.x, a[0],
                            a[1], a[2]);
        }
        const bool alive = ev.tlim > ev.tmin;
        Best best{BIG, 0.f, 0.f, 0};
#pragma unroll 1
        for (int g = 0; g < N / 4; ++g)
            closest4<MT_STRICT, N>(cm[b], g, ev, ev.tlim, true, alive, best);
        const size_t off = (size_t)e * LANES + threadIdx.x;
        t_out[off] = best.t;
        k_out[off] = best.k;
        u_out[off] = best.u;
        v_out[off] = best.v;
        if (!more) break;
        if (threadIdx.x < N) build_tri<N>(cm[b ^ 1], raw[b ^ 1], threadIdx.x);
        ev = nx;
    }
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
    const int per = events_per_block(ce);
    const int grid = (ce + per - 1) / per;
    if (n == 64)
        mt_mxu_kernel<64><<<grid, LANES, 0, s>>>(row, R, t_out, k_out, u_out,
                                                 v_out, ce, per);
    else if (n == 8)
        mt_mxu_kernel<8><<<grid, LANES, 0, s>>>(row, R, t_out, k_out, u_out,
                                                v_out, ce, per);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}

}  // extern "C"
