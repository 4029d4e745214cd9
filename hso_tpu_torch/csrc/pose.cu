// K5: the motion-only pose LM trial loop.
//
// Replaces the Pallas kernel pose_lm_tpu (track/pose_pallas.py of the JAX
// package): Nielsen-damped LM on the scaled unit-plane reprojection error,
// corner residuals in 2-D, edgelet residuals projected on the gradient, split
// robust scales, TEMPORARY points weighted x0.5, 6x6 normal equations over
// all observations, at most 5 damping trials per iteration.
//
// Bound: latency.  The observations are a few kilobytes (N*12 floats) and the
// up to 12*5 trials are serial, each a block-wide reduction around a scalar
// 6x6 Cholesky and an SE(3) exponential, so one block runs them all (the data
// is 16 KB: a cluster would buy nothing).  What the design shortens is the
// trial:
//  * a thread keeps its observation in registers for the whole kernel
//    (threads = N rounded up to a warp, at most 512 so that a thread may hold
//    128 registers; beyond that a strided remainder is read from global memory);
//  * ONE fused pass per trial evaluates a pose: residual, weight, chi2 and the
//    27 normal-equation sums at that pose, 28 sums through hso::block_sums;
//  * three systems rotate in shared memory: the current one (at T), the
//    candidate's (at the trial pose) and the one the last accepted step was
//    solved from (A_last).  A trial is solve -> one pass at the trial pose ->
//    accept/reject; on accept the candidate's system becomes the current one,
//    on reject the current one is reused with the new damping, so nothing is
//    rebuilt;
//  * warp 0 runs the scalar step in registers (hso::pose_lm_step: no square
//    root or division on its chain) and a block barrier, 15 ns on this card,
//    hands the trial pose to the other warps: three block barriers per trial.
//    No float atomics: two runs are bitwise equal.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int NSYS = 27;       // 21 lower-triangular A entries + 6 of b
constexpr int NP = NSYS + 1;   // ... and chi2
constexpr float HUBER_K = 1.345f;
constexpr float STEP_EPS = 1e-10f;
constexpr int MAX_TRIALS = 5;

struct Obs {
    const float* p_world;        // (N, 3)
    const float* obs_uv;         // (N, 2)
    const float* grad;           // (N, 2)
    const float* sic;            // (N)
    const unsigned char* edge;   // (N)
    const unsigned char* temp;   // (N)
    const unsigned char* valid;  // (N)
    int N;
    float s_pt, s_ls;
};

// One observation, as a thread holds it.
struct Ob {
    float X, Y, Z, u, v, gu, gv, sic;
    bool edge, temp, valid;
};

__device__ __forceinline__ Ob load_ob(const Obs& O, int n) {
    Ob o;
    o.valid = n < O.N && O.valid[n] != 0;
    if (!o.valid) {
        o.X = o.Y = o.Z = o.u = o.v = o.gu = o.gv = o.sic = 0.f;
        o.edge = o.temp = false;
        return o;
    }
    o.X = O.p_world[3 * n]; o.Y = O.p_world[3 * n + 1]; o.Z = O.p_world[3 * n + 2];
    o.u = O.obs_uv[2 * n]; o.v = O.obs_uv[2 * n + 1];
    o.gu = O.grad[2 * n]; o.gv = O.grad[2 * n + 1];
    o.sic = O.sic[n];
    o.edge = O.edge[n] != 0;
    o.temp = O.temp[n] != 0;
    return o;
}

// Add one observation's terms at pose T: acc[0..20] A (lower triangle,
// packed), acc[21..26] b, acc[27] chi2.
__device__ __forceinline__ void accumulate(const Ob& o, const float (&T)[12], float s_pt,
                                           float s_ls, float (&acc)[NP]) {
    if (!o.valid) return;
    const float x = T[0] * o.X + T[1] * o.Y + T[2] * o.Z + T[3];
    const float y = T[4] * o.X + T[5] * o.Y + T[6] * o.Z + T[7];
    const float z = T[8] * o.X + T[9] * o.Y + T[10] * o.Z + T[11];
    const float zr = 1.0f / (fabsf(z) < 1e-12f ? 1e-12f : z);
    const float eu = (o.u - x * zr) * o.sic;
    const float ev = (o.v - y * zr) * o.sic;
    const float r_edge = o.gu * eu + o.gv * ev;
    const float r_abs = o.edge ? fabsf(r_edge) : sqrtf(eu * eu + ev * ev);
    const float xs = o.edge ? fabsf(r_edge) / s_ls : r_abs / s_pt;
    float w = xs < HUBER_K ? 1.0f : HUBER_K / fmaxf(xs, 1e-12f);
    if (o.temp) w *= 0.5f;
    acc[27] += r_abs * r_abs * w;

    const float zi = 1.0f / (fabsf(z) < 1e-8f ? 1e-8f : z);
    const float zi2 = zi * zi;
    float j0[6] = {-zi, 0.f, x * zi2, x * y * zi2, -(1.0f + x * x * zi2), y * zi};
    float j1[6] = {0.f, -zi, y * zi2, 1.0f + y * y * zi2, -x * y * zi2, -x * zi};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
        j0[k] *= o.sic;
        j1[k] *= o.sic;
    }
    if (o.edge) {
        float je[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) je[k] = o.gu * j0[k] + o.gv * j1[k];
        int idx = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            acc[21 + i] -= je[i] * r_edge * w;
#pragma unroll
            for (int j = 0; j <= i; ++j) acc[idx++] += je[i] * je[j] * w;
        }
    } else {
        int idx = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            acc[21 + i] -= (j0[i] * eu + j1[i] * ev) * w;
#pragma unroll
            for (int j = 0; j <= i; ++j) acc[idx++] += (j0[i] * j0[j] + j1[i] * j1[j]) * w;
        }
    }
}

// The fused pass at pose T: dst[NP] (shared) holds the system and chi2 for
// all threads on return.
__device__ __forceinline__ void fused_pass(const Obs& O, const Ob& mine, const float (&T)[12],
                                           float* red, float* dst) {
    float acc[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) acc[k] = 0.f;
    accumulate(mine, T, O.s_pt, O.s_ls, acc);
    for (int n = threadIdx.x + blockDim.x; n < O.N; n += blockDim.x)
        accumulate(load_ob(O, n), T, O.s_pt, O.s_ls, acc);
    hso::block_sums<NP>(acc, red, dst);
    __syncthreads();
}

__global__ void __launch_bounds__(MAX_THREADS)
pose_lm_kernel(Obs O, const float* __restrict__ T0, const float* __restrict__ scales, int n_iter,
               float* __restrict__ out) {
    __shared__ float red[NP * (MAX_THREADS / 32)];
    __shared__ float s_sys[3][NP];
    __shared__ float s_step[19];                // Tn, dT, ok from warp 0

    O.s_pt = scales[0];
    O.s_ls = scales[1];
    const Ob mine = load_ob(O, threadIdx.x);
    // LM state: the same bits in every thread
    float T[12], Tn[12], dT[6];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = T0[k];
    int cur = 0, cand = 1, last = 2;
    bool have_last = false, stop = false;
    float mu = 0.1f, nu = 2.0f;
    int trials = 0;

    fused_pass(O, mine, T, red, s_sys[cur]);
    float chi2 = s_sys[cur][27];

    for (int it = 0; it < n_iter && !stop; ++it) {
        bool accepted = false;
        for (int trial = 0; trial < MAX_TRIALS; ++trial) {
            if (threadIdx.x < 32) {             // the scalar step: warp 0, then one barrier
                const bool ok0 = hso::pose_lm_step(s_sys[cur], mu, T, Tn, dT);   // exp(dT) * T
                if (threadIdx.x == 0) {
#pragma unroll
                    for (int k = 0; k < 12; ++k) s_step[k] = Tn[k];
#pragma unroll
                    for (int k = 0; k < 6; ++k) s_step[12 + k] = dT[k];
                    s_step[18] = ok0 ? 1.0f : 0.0f;
                }
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < 12; ++k) Tn[k] = s_step[k];
#pragma unroll
            for (int k = 0; k < 6; ++k) dT[k] = s_step[12 + k];
            const bool ok = s_step[18] != 0.0f;
            fused_pass(O, mine, Tn, red, s_sys[cand]);
            const float chi2_new = s_sys[cand][27];
            const float rho = ok ? chi2 - chi2_new : -1.0f;
            trials += 1;
            if (rho > 0.f) {
#pragma unroll
                for (int k = 0; k < 12; ++k) T[k] = Tn[k];
                chi2 = chi2_new;
                // the step was solved from the current system: it becomes
                // A_last, the candidate's becomes current
                const int spare = last;
                last = cur;
                cur = cand;
                cand = spare;
                have_last = true;
                // the raw chi2 decrease feeds the Nielsen update
                const float q = 2.0f * rho - 1.0f;
                mu = mu * fmaxf(1.0f / 3.0f, fminf(1.0f - q * q * q, 2.0f / 3.0f));
                nu = 2.0f;
                float mx = 0.f;
#pragma unroll
                for (int i = 0; i < 6; ++i) mx = fmaxf(mx, fabsf(dT[i]));
                if (mx <= STEP_EPS) stop = true;
                accepted = true;
                break;
            }
            mu = fmaxf(mu * nu, 1e-4f);
            nu = nu * 2.0f;
        }
        if (!accepted) stop = true;
    }
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < 12; ++k) out[k] = T[k];
        for (int i = 0; i < 6; ++i)
            for (int j = 0; j < 6; ++j) {
                const int lo = i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
                out[12 + i * 6 + j] = have_last ? s_sys[last][lo] : 0.f;
            }
        out[48] = chi2;
        out[49] = (float)trials;
        for (int k = 50; k < 64; ++k) out[k] = 0.f;
    }
}

}  // namespace

extern "C" int hso_pose_lm(const float* T0, const float* p_world, const float* obs_uv,
                           const float* grad, const float* sqrt_inv_cov,
                           const unsigned char* is_edgelet, const unsigned char* is_temporary,
                           const unsigned char* valid, const float* scales, int N, int n_iter,
                           float* out, cudaStream_t stream) {
    Obs O;
    O.p_world = p_world; O.obs_uv = obs_uv; O.grad = grad; O.sic = sqrt_inv_cov;
    O.edge = is_edgelet; O.temp = is_temporary; O.valid = valid; O.N = N;
    O.s_pt = 0.f; O.s_ls = 0.f;    // read from `scales` on the device
    int threads = (N + 31) / 32 * 32;
    threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
    pose_lm_kernel<<<1, threads, 0, stream>>>(O, T0, scales, n_iter, out);
    return (int)cudaGetLastError();
}
