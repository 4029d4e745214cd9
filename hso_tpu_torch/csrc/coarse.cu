// K3: the coarse tracker's inverse-compositional LM loop of one pyramid level.
//
// Replaces the Pallas kernel coarse_level_ic_tpu (track/coarse_pallas.py of
// the JAX package).  That kernel puts features on the 128-lane axis,
// transposes its inputs and rebuilds a full GxG bilinear grid per feature by
// a 24-step separable accumulation, because the TPU cannot gather.  None of
// that carries over: here each (feature, pattern point) pair is one work item
// that reads its four bilinear taps straight from the feature's window.
//
// Bound: latency, not bytes or operations.  Every LM iteration ends in a
// global reduction (35 normal-equation entries, the energy and the term
// count) followed by a scalar 7x7 Cholesky, an SE(3) exponential and an
// accept/reject decision, so the iterations are serial.  What can shrink is
// the time of one evaluation, and that is what the design is about:
//
//  * One thread-block cluster (8 blocks, the portable maximum; needs sm_90)
//    runs the level.  Block r owns features [r*F, (r+1)*F), F = ceil(N/8), and
//    copies their windows (cp.async, all in flight at once), template
//    Jacobians, points, anchors and visibility into its shared memory ONCE,
//    with one record per item (its feature, its pattern offsets, its
//    reference value); every evaluation reads them from there.  A block has
//    256 threads, 512 when that still leaves more than one item per thread,
//    so an item is one or two per thread; its feature's projection is
//    recomputed per item, so there is no separate projection pass.
//  * One cluster-wide sum per evaluation in a fixed order: a block reduces
//    its 37 partials (hso::block_sums) into a slot of its own shared memory,
//    cluster.sync(), then 37 threads of EVERY block add the 8 slots in rank
//    order through distributed shared memory.  All blocks hold bit-identical
//    sums and run the scalar step redundantly (warp 0 of every block, in
//    registers, with no square root or division on its chain; a block
//    barrier, 15 ns on this card, hands the new state to the other warps), so
//    nothing crosses the cluster twice, the loop's exit is uniform over the
//    cluster, and there is no second cluster barrier.  Slots alternate by
//    evaluation parity: a block's next write cannot overtake a neighbour's
//    read of the previous one.  A last cluster.sync() keeps shared memory
//    alive for remote readers.  No float atomics: two runs are bitwise equal.
//  * Shapes whose per-block data does not fit 227 KB run the same kernel with
//    the windows left in global memory (template flag RESIDENT = false) and
//    only the per-item tables resident.  The plan depends on (N, P) alone.
//  * The projection is the camera's (template parameter MODEL): the ideal
//    pinhole, the pinhole with radial-tangential distortion (k1 k2 p1 p2 k3)
//    or the FOV/ATAN model (omega and 2 tan(omega/2)), with the formulas of
//    the port's cameras/models.py.  The residual's Jacobian stays the
//    template Jacobian computed outside, on both sides; only the projection
//    that places the pattern in the current window changes.  The ideal
//    instance is the code of the entry hso_coarse_level_ic, whose arguments
//    and bits did not change when the models came.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"

namespace cg = cooperative_groups;

struct PatternTable {
    int dx[32];
    int dy[32];
};

namespace {

constexpr int WIN = 24;
constexpr int WIN2 = WIN * WIN;
constexpr int NS = 37;            // 28 lower-triangular H entries, 7 of b, E, n_terms
constexpr int CLUSTER = 8;
constexpr int THREADS = 256;      // of a block; doubled for long item lists
constexpr int MAX_THREADS = 512;
constexpr int SMALL = 176;        // 2 slots + 2 totals of NS floats, the 14 floats of a
                                  // step, padded to 16 bytes
constexpr size_t SMEM_MAX = 232448;

// 0 = the plan's own choice; set through hso_coarse_plan_override (tuning only)
int g_cluster = 0;
int g_threads = 0;

enum Model { IDEAL = 0, RADTAN = 1, FOV = 2 };

struct Args {
    const float* w_cur;       // (N, 24, 24)
    const float* ref_patch;   // (N, P)
    const float* j_ic;        // (N, P, 6)
    const float* xyz_ref;     // (N, 3)
    const int* au;            // (N)
    const int* av;            // (N)
    const unsigned char* vis; // (N)
    float fx, fy, cx, cy;
    float dc[5];              // the model's coefficients (radtan: k1 k2 p1 p2 k3;
                              // fov: omega, 2 tan(omega/2))
    int N, P, g, center;
    int is_top, border, h_img, w_img;
    float huber, cutoff;
};

struct Plan {
    int cluster, threads, resident, feats;
    size_t smem;
};

// Dynamic shared memory of one block: the reduction buffer, the slots and
// totals, then the block's features (windows only when resident).
size_t smem_bytes(int threads, int feats, int P, bool resident) {
    const size_t floats = ((size_t)NS * (threads / 32) + 3) / 4 * 4 + SMALL +
                          (resident ? (size_t)feats * WIN2 : 0) + (size_t)feats * P * 10 +
                          (size_t)feats * 5;
    return (floats * 4 + feats + 15) / 16 * 16;
}

Plan plan_of(int N, int P) {
    Plan p;
    p.cluster = g_cluster > 0 ? g_cluster : CLUSTER;
    p.feats = (N + p.cluster - 1) / p.cluster;
    // more than two items per thread: twice the threads halve the item pass
    // and cost the reduction little
    p.threads = g_threads > 0 ? g_threads : (p.feats * P > 2 * THREADS ? 2 * THREADS : THREADS);
    p.resident = smem_bytes(p.threads, p.feats, P, true) <= SMEM_MAX ? 1 : 0;
    p.smem = smem_bytes(p.threads, p.feats, P, p.resident != 0);
    return p;
}

// The block's view of its shared memory.
struct Smem {
    float* red;            // NS * warps of the block
    float* slots;          // 2 * NS: this block's sums, by evaluation parity
    float* tot;            // 2 * NS: the cluster's sums, current and candidate
    float* step;           // 14: the trial state (Tn, an, step norm) from warp 0
    const float* win;      // nf * 576 (shared when resident, else global)
    float4* item;          // nf * P: feature (int bits), centre + dx, centre + dy, reference
    float* jic;            // nf * P * 6
    float* xyz;            // nf * 3
    float* au;             // nf
    float* av;             // nf
    unsigned char* vis;    // nf
    int nf;                // features this block owns (may be 0)
};

// The level's pixel of a camera-frame point through the camera's model.
template <int MODEL>
__device__ __forceinline__ void project(const Args& A, float xc, float yc, float zc, float& u,
                                        float& v) {
    const float zi = 1.0f / (fabsf(zc) < 1e-9f ? 1e-9f : zc);
    if (MODEL == IDEAL) {
        u = A.fx * xc * zi + A.cx;
        v = A.fy * yc * zi + A.cy;
        return;
    }
    const float x = xc * zi, y = yc * zi;
    float xd, yd;
    if (MODEL == RADTAN) {
        const float r2 = x * x + y * y;
        const float r4 = r2 * r2;
        const float r6 = r4 * r2;
        const float a1 = 2.0f * x * y;
        const float a2 = r2 + 2.0f * x * x;
        const float a3 = r2 + 2.0f * y * y;
        const float cdist = 1.0f + A.dc[0] * r2 + A.dc[1] * r4 + A.dc[4] * r6;
        xd = x * cdist + A.dc[2] * a1 + A.dc[3] * a2;
        yd = y * cdist + A.dc[2] * a3 + A.dc[3] * a1;
    } else {
        const float r = sqrtf(x * x + y * y);
        const float rs = fmaxf(r, 1e-12f);
        const float fac = r < 1e-12f ? 1.0f : atanf(rs * A.dc[1]) / (rs * A.dc[0]);
        xd = fac * x;
        yd = fac * y;
    }
    u = A.fx * xd + A.cx;
    v = A.fy * yd + A.cy;
}

// Evaluate the robust system at (T, a) over the cluster: fills dst[NS]
// (shared, this block's copy of the cluster-wide sums) for all threads.
template <int MODEL>
__device__ __forceinline__ void evaluate(const Args& A, const Smem& S,
                                         const float (&T)[12], float a, int parity, float* dst,
                                         cg::cluster_group& cluster) {
    float acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.f;
    const float max_energy = 2.0f * A.huber * A.cutoff - A.huber * A.huber;
    const float span = (float)(A.g - 1);
    const int items = S.nf * A.P;
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
        const float4 rec = S.item[item];
        const int n = __float_as_int(rec.x);
        const float X = S.xyz[3 * n], Y = S.xyz[3 * n + 1], Z = S.xyz[3 * n + 2];
        const float xc = T[0] * X + T[1] * Y + T[2] * Z + T[3];
        const float yc = T[4] * X + T[5] * Y + T[6] * Z + T[7];
        const float zc = T[8] * X + T[9] * Y + T[10] * Z + T[11];
        float u, v;
        project<MODEL>(A, xc, yc, zc, u, v);
        const float rel_u = u - (float)A.center - S.au[n];
        const float rel_v = v - (float)A.center - S.av[n];
        const float uf = floorf(u), vf = floorf(v);
        const bool valid = S.vis[n] && (zc > 0.0f) && (rel_u >= 0.0f) &&
                           (rel_u + span <= (float)(WIN - 1)) && (rel_v >= 0.0f) &&
                           (rel_v + span <= (float)(WIN - 1)) && (uf - A.border >= 0.0f) &&
                           (vf - A.border >= 0.0f) && (uf + A.border < (float)A.w_img) &&
                           (vf + A.border < (float)A.h_img);
        if (!valid) continue;
        const float pu = rel_u + rec.y;
        const float pv = rel_v + rec.z;
        const float cur = hso::sample_window(S.win + (size_t)n * WIN2, WIN, pu, pv);
        const float ref = rec.w;
        const float r = cur - a * ref;
        const float abs_r = fabsf(r);
        const float hw = abs_r < A.huber ? 1.0f : A.huber / fmaxf(abs_r, 1e-12f);
        bool sat = false;
        float e;
        if (A.is_top) {
            e = hw * r * r;
        } else {
            sat = abs_r > A.cutoff;
            e = sat ? max_energy : hw * r * r * (2.0f - hw);
        }
        acc[35] += e;
        acc[36] += 1.0f;
        const float wgt = sat ? 0.f : hw;
        float J[7];
        J[0] = -ref;
        const float2* jp = reinterpret_cast<const float2*>(S.jic + (size_t)item * 6);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
            const float2 j2 = jp[q];
            J[2 * q + 1] = a * j2.x;
            J[2 * q + 2] = a * j2.y;
        }
        int idx = 0;
#pragma unroll
        for (int i = 0; i < 7; ++i) {
            const float wi = wgt * J[i];
            acc[28 + i] -= wi * r;
#pragma unroll
            for (int j = 0; j <= i; ++j) acc[idx++] += wi * J[j];
        }
    }
    float* slot = S.slots + parity * NS;
    hso::block_sums<NS>(acc, S.red, slot);
    cluster.sync();                       // every block's slot is written and visible
    if (threadIdx.x < NS) {
        const unsigned nb = cluster.num_blocks();
        float part[CLUSTER];             // all remote reads in flight, then a fixed order
#pragma unroll
        for (unsigned r = 0; r < CLUSTER; ++r)
            part[r] = r < nb ? *cluster.map_shared_rank(slot + threadIdx.x, r) : 0.f;
        float s = 0.f;
#pragma unroll
        for (unsigned r = 0; r < CLUSTER; ++r) s += part[r];
        dst[threadIdx.x] = s;
    }
    __syncthreads();
}

template <bool RESIDENT, int MODEL>
__global__ void __launch_bounds__(MAX_THREADS)
coarse_level_ic_kernel(Args A, PatternTable pat, const float* __restrict__ T0,
                       const float* __restrict__ sc, int n_iter, int feats,
                       float* __restrict__ out) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, nthreads = blockDim.x;
    extern __shared__ __align__(16) float smem[];

    const int n0 = min(rank * feats, A.N);
    const int nf = min(feats, A.N - n0);
    const int P = A.P;
    Smem S;
    S.nf = nf;
    S.red = smem;
    S.slots = S.red + (NS * (nthreads >> 5) + 3) / 4 * 4;
    S.tot = S.slots + 2 * NS;
    S.step = S.tot + 2 * NS;
    float* s_win = S.slots + SMALL;
    S.item = reinterpret_cast<float4*>(s_win + (RESIDENT ? feats * WIN2 : 0));
    S.jic = reinterpret_cast<float*>(S.item + feats * P);
    S.xyz = S.jic + feats * P * 6;
    S.au = S.xyz + feats * 3;
    S.av = S.au + feats;
    S.vis = reinterpret_cast<unsigned char*>(S.av + feats);

    // ---- the block's features into shared memory, once per level ----
    const float* g_win = A.w_cur + (size_t)n0 * WIN2;
    if (RESIDENT) {
        if ((reinterpret_cast<size_t>(g_win) & 15u) == 0) {
            const float4* src = reinterpret_cast<const float4*>(g_win);
            float4* dst = reinterpret_cast<float4*>(s_win);
            for (int i = tid; i < nf * (WIN2 / 4); i += nthreads)
                __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
            __pipeline_commit();
        } else {
            for (int i = tid; i < nf * WIN2; i += nthreads) s_win[i] = g_win[i];
        }
        S.win = s_win;
    } else {
        S.win = g_win;
    }
    for (int i = tid; i < nf * P * 6; i += nthreads) S.jic[i] = A.j_ic[(size_t)n0 * P * 6 + i];
    for (int i = tid; i < nf * P; i += nthreads) {
        const int n = i / P, k = i - n * P;
        S.item[i] = make_float4(__int_as_float(n), (float)(A.center + pat.dx[k]),
                                (float)(A.center + pat.dy[k]), A.ref_patch[(size_t)n0 * P + i]);
    }
    for (int i = tid; i < nf * 3; i += nthreads) S.xyz[i] = A.xyz_ref[(size_t)n0 * 3 + i];
    for (int i = tid; i < nf; i += nthreads) {
        S.au[i] = (float)A.au[n0 + i];
        S.av[i] = (float)A.av[n0 + i];
        S.vis[i] = A.vis[n0 + i];
    }
    A.huber = sc[1];
    A.cutoff = sc[2];
    // LM state: the same bits in every thread of every block
    float T[12], Tn[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = T0[k];
    float a = sc[0], an, stepnorm;
    float lam = 0.1f;
    int cur = 0, it = 0, evals = 0;
    __pipeline_wait_prior(0);
    __syncthreads();

    evaluate<MODEL>(A, S, T, a, evals++ & 1, S.tot + cur * NS, cluster);
    float nt = S.tot[cur * NS + 36];
    float E = S.tot[cur * NS + 35] / fmaxf(nt, 1.0f);

    while (it < n_iter) {
        if (tid < 32) {                    // the scalar step: warp 0, then one block barrier
            hso::coarse_lm_step(S.tot + cur * NS, lam, T, a, Tn, an, stepnorm);
            if (tid == 0) {
#pragma unroll
                for (int k = 0; k < 12; ++k) S.step[k] = Tn[k];
                S.step[12] = an;
                S.step[13] = stepnorm;
            }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 12; ++k) Tn[k] = S.step[k];
        an = S.step[12];
        stepnorm = S.step[13];
        const float* cand = S.tot + (1 - cur) * NS;
        evaluate<MODEL>(A, S, Tn, an, evals++ & 1, S.tot + (1 - cur) * NS, cluster);
        const float E_new = cand[35] / fmaxf(cand[36], 1.0f);
        if (E_new < E) {                              // false on NaN: reject
#pragma unroll
            for (int k = 0; k < 12; ++k) T[k] = Tn[k];
            a = an;
            E = E_new;
            nt = cand[36];
            cur = 1 - cur;                            // the candidate's sums become current
            lam = lam * 0.5f;
        } else {
            lam = fmaxf(lam * 4.0f, 1e-3f);
        }
        ++it;
        if (stepnorm <= 1e-4f) break;
    }
    cluster.sync();          // no block leaves while another may still read its slots
    if (rank == 0 && tid == 0) {
#pragma unroll
        for (int k = 0; k < 12; ++k) out[k] = T[k];
        out[12] = a;
        out[13] = E;
        out[14] = nt;
        out[15] = (float)it;
    }
}

template <bool RESIDENT, int MODEL>
cudaError_t launch(const Plan& pl, const Args& A, const PatternTable& pat, const float* T0,
                   const float* sc, int n_iter, float* out, cudaStream_t stream) {
    auto kernel = coarse_level_ic_kernel<RESIDENT, MODEL>;
    static hso::SmemOptIn opted;       // one per template instance
    const cudaError_t e = hso::allow_dynamic_smem(kernel, pl.smem, opted);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(pl.cluster);
    cfg.blockDim = dim3(pl.threads);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, A, pat, T0, sc, n_iter, pl.feats, out);
}

template <int MODEL>
cudaError_t launch_model(const Plan& pl, const Args& A, const PatternTable& pat, const float* T0,
                         const float* sc, int n_iter, float* out, cudaStream_t stream) {
    return pl.resident ? launch<true, MODEL>(pl, A, pat, T0, sc, n_iter, out, stream)
                       : launch<false, MODEL>(pl, A, pat, T0, sc, n_iter, out, stream);
}

int level_ic(const float* w_cur, const float* ref_patch, const float* j_ic, const float* xyz_ref,
             const int* au, const int* av, const unsigned char* vis, const float* T0,
             const float* sc, float fx, float fy, float cx, float cy, int N, int P, int g,
             int center, const PatternTable* pat, int n_iter, int is_top, int border, int h_img,
             int w_img, int model, const float (&coef)[5], float* out, cudaStream_t stream) {
    Args A;
    A.w_cur = w_cur; A.ref_patch = ref_patch; A.j_ic = j_ic; A.xyz_ref = xyz_ref;
    A.au = au; A.av = av; A.vis = vis;
    A.fx = fx; A.fy = fy; A.cx = cx; A.cy = cy;
    for (int k = 0; k < 5; ++k) A.dc[k] = coef[k];
    A.N = N; A.P = P; A.g = g; A.center = center;
    A.is_top = is_top; A.border = border; A.h_img = h_img; A.w_img = w_img;
    A.huber = 0.f; A.cutoff = 0.f;   // read from sc on the device
    const Plan pl = plan_of(N, P);
    if (pl.smem > SMEM_MAX) return (int)cudaErrorInvalidConfiguration;
    cudaError_t e;
    switch (model) {
        case IDEAL: e = launch_model<IDEAL>(pl, A, *pat, T0, sc, n_iter, out, stream); break;
        case RADTAN: e = launch_model<RADTAN>(pl, A, *pat, T0, sc, n_iter, out, stream); break;
        case FOV: e = launch_model<FOV>(pl, A, *pat, T0, sc, n_iter, out, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

}  // namespace

// The launch plan of (N, P): out4 = {cluster, threads, resident, smem bytes}.
// Returns 0, or 1 when even the non-resident variant does not fit.
extern "C" int hso_coarse_launch_plan(int N, int P, int* out4) {
    const Plan pl = plan_of(N, P);
    out4[0] = pl.cluster;
    out4[1] = pl.threads;
    out4[2] = pl.resident;
    out4[3] = (int)pl.smem;
    return pl.smem <= SMEM_MAX ? 0 : 1;
}

// Tuning only: force the cluster size (1..8) and the block size (a multiple of
// 32 from 64 to 512); 0 gives a choice back to the plan.
extern "C" int hso_coarse_plan_override(int cluster, int threads) {
    if (cluster < 0 || cluster > CLUSTER || threads < 0 || threads > MAX_THREADS || threads % 32 ||
        (threads > 0 && threads < 64))
        return 1;
    g_cluster = cluster;
    g_threads = threads;
    return 0;
}

// One level through the ideal pinhole.
extern "C" int hso_coarse_level_ic(const float* w_cur, const float* ref_patch, const float* j_ic,
                                   const float* xyz_ref, const int* au, const int* av,
                                   const unsigned char* vis, const float* T0, const float* sc,
                                   float fx, float fy, float cx, float cy, int N, int P, int g,
                                   int center, const PatternTable* pat, int n_iter, int is_top,
                                   int border, int h_img, int w_img, float* out,
                                   cudaStream_t stream) {
    const float none[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    return level_ic(w_cur, ref_patch, j_ic, xyz_ref, au, av, vis, T0, sc, fx, fy, cx, cy, N, P,
                    g, center, pat, n_iter, is_top, border, h_img, w_img, IDEAL, none, out,
                    stream);
}

// One level through the camera model `model` (0 ideal, 1 radtan, 2 fov) with
// its coefficients c0..c4 (radtan: k1 k2 p1 p2 k3; fov: omega, 2 tan(omega/2),
// the rest unused).
extern "C" int hso_coarse_level_ic_model(const float* w_cur, const float* ref_patch,
                                         const float* j_ic, const float* xyz_ref, const int* au,
                                         const int* av, const unsigned char* vis, const float* T0,
                                         const float* sc, float fx, float fy, float cx, float cy,
                                         int N, int P, int g, int center, const PatternTable* pat,
                                         int n_iter, int is_top, int border, int h_img, int w_img,
                                         int model, float c0, float c1, float c2, float c3,
                                         float c4, float* out, cudaStream_t stream) {
    const float coef[5] = {c0, c1, c2, c3, c4};
    return level_ic(w_cur, ref_patch, j_ic, xyz_ref, au, av, vis, T0, sc, fx, fy, cx, cy, N, P,
                    g, center, pat, n_iter, is_top, border, h_img, w_img, model, coef, out,
                    stream);
}
