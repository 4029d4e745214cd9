// K5: the motion-only pose LM trial loop.
//
// Replaces the Pallas kernel pose_lm_tpu (track/pose_pallas.py of the JAX
// package): Nielsen-damped LM on the scaled unit-plane reprojection error,
// corner residuals in 2-D, edgelet residuals projected on the gradient, split
// robust scales, TEMPORARY points weighted x0.5, 6x6 normal equations over
// all observations, at most 5 damping trials per iteration.
//
// Bound: latency.  The observations are a few kilobytes (N*12 floats) and each
// trial is two block-wide reductions (27 normal-equation entries, then the
// trial's chi2) around a scalar 6x6 Cholesky and an SE(3) exponential, so the
// up to 12*5 trials are serial and one block runs them all.  Design: threads
// stride over the observations with the partials in registers, fixed-order
// shuffle + shared-memory tree (no float atomics), thread 0 does the scalar
// bookkeeping and broadcasts through shared memory; the trial loop leaves as
// soon as a trial is accepted or the step vanishes, as the plain version does.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NSYS = 27;       // 21 lower-triangular A entries + 6 of b
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

struct Res {
    float px, py, pz, eu, ev, r_edge, r_abs, wgt;
    bool edge;
};

__device__ __forceinline__ Res residual(const Obs& O, const float* T, int n) {
    Res r;
    const float X = O.p_world[3 * n], Y = O.p_world[3 * n + 1], Z = O.p_world[3 * n + 2];
    r.px = T[0] * X + T[1] * Y + T[2] * Z + T[3];
    r.py = T[4] * X + T[5] * Y + T[6] * Z + T[7];
    r.pz = T[8] * X + T[9] * Y + T[10] * Z + T[11];
    const float zi = 1.0f / (fabsf(r.pz) < 1e-12f ? 1e-12f : r.pz);
    const float sic = O.sic[n];
    r.eu = (O.obs_uv[2 * n] - r.px * zi) * sic;
    r.ev = (O.obs_uv[2 * n + 1] - r.py * zi) * sic;
    r.r_edge = O.grad[2 * n] * r.eu + O.grad[2 * n + 1] * r.ev;
    r.edge = O.edge[n] != 0;
    r.r_abs = r.edge ? fabsf(r.r_edge) : sqrtf(r.eu * r.eu + r.ev * r.ev);
    const float x = r.edge ? fabsf(r.r_edge) / O.s_ls : r.r_abs / O.s_pt;
    float w = x < HUBER_K ? 1.0f : HUBER_K / fmaxf(x, 1e-12f);
    if (O.temp[n]) w *= 0.5f;
    r.wgt = O.valid[n] ? w : 0.f;
    return r;
}

__device__ void chi2_of(const Obs& O, const float* T_sh, float* warp_buf, float* out1) {
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = T_sh[k];
    float acc[1] = {0.f};
    for (int n = threadIdx.x; n < O.N; n += blockDim.x) {
        if (!O.valid[n]) continue;
        const Res r = residual(O, T, n);
        acc[0] += r.r_abs * r.r_abs * r.wgt;
    }
    hso::block_reduce_sum<1>(acc, warp_buf, out1);
}

__device__ void system_of(const Obs& O, const float* T_sh, float* warp_buf, float* out27) {
    float T[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T[k] = T_sh[k];
    float acc[NSYS];
#pragma unroll
    for (int k = 0; k < NSYS; ++k) acc[k] = 0.f;
    for (int n = threadIdx.x; n < O.N; n += blockDim.x) {
        if (!O.valid[n]) continue;
        const Res r = residual(O, T, n);
        const float zi = 1.0f / (fabsf(r.pz) < 1e-8f ? 1e-8f : r.pz);
        const float zi2 = zi * zi;
        const float sic = O.sic[n];
        const float x = r.px, y = r.py;
        float j0[6] = {-zi, 0.f, x * zi2, x * y * zi2, -(1.0f + x * x * zi2), y * zi};
        float j1[6] = {0.f, -zi, y * zi2, 1.0f + y * y * zi2, -x * y * zi2, -x * zi};
#pragma unroll
        for (int k = 0; k < 6; ++k) {
            j0[k] *= sic;
            j1[k] *= sic;
        }
        const float w = r.wgt;
        if (r.edge) {
            const float gu = O.grad[2 * n], gv = O.grad[2 * n + 1];
            float je[6];
#pragma unroll
            for (int k = 0; k < 6; ++k) je[k] = gu * j0[k] + gv * j1[k];
            int idx = 0;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                acc[21 + i] -= je[i] * r.r_edge * w;
#pragma unroll
                for (int j = 0; j <= i; ++j) acc[idx++] += je[i] * je[j] * w;
            }
        } else {
            int idx = 0;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                acc[21 + i] -= (j0[i] * r.eu + j1[i] * r.ev) * w;
#pragma unroll
                for (int j = 0; j <= i; ++j) acc[idx++] += (j0[i] * j0[j] + j1[i] * j1[j]) * w;
            }
        }
    }
    hso::block_reduce_sum<NSYS>(acc, warp_buf, out27);
}

__global__ void __launch_bounds__(THREADS)
pose_lm_kernel(Obs O, const float* __restrict__ T0, const float* __restrict__ scales, int n_iter,
               float* __restrict__ out) {
    __shared__ float warp_buf[32 * NSYS];
    __shared__ float s_sys[NSYS];
    __shared__ float s_chi[1];
    __shared__ float s_T[12], s_Tn[12], s_dT[6], s_Alast[36];
    __shared__ float s_chi2, s_mu, s_nu;
    __shared__ int s_stop, s_accepted, s_ok, s_trials;

    O.s_pt = scales[0];
    O.s_ls = scales[1];
    if (threadIdx.x == 0) {
        for (int k = 0; k < 12; ++k) s_T[k] = T0[k];
        for (int k = 0; k < 36; ++k) s_Alast[k] = 0.f;
        s_mu = 0.1f;
        s_nu = 2.0f;
        s_stop = 0;
        s_trials = 0;
    }
    __syncthreads();
    chi2_of(O, s_T, warp_buf, s_chi);
    if (threadIdx.x == 0) s_chi2 = s_chi[0];
    __syncthreads();

    for (int it = 0; it < n_iter; ++it) {
        if (s_stop) break;                 // uniform: read after a barrier
        if (threadIdx.x == 0) s_accepted = 0;
        __syncthreads();
        for (int trial = 0; trial < MAX_TRIALS; ++trial) {
            system_of(O, s_T, warp_buf, s_sys);
            if (threadIdx.x == 0) {
                float Ad[36], dT[6];
                for (int i = 0; i < 6; ++i)
                    for (int j = 0; j <= i; ++j) {
                        const float a = s_sys[i * (i + 1) / 2 + j];
                        Ad[i * 6 + j] = a;
                        Ad[j * 6 + i] = a;
                    }
                for (int i = 0; i < 6; ++i) Ad[i * 6 + i] += Ad[i * 6 + i] * s_mu;
                hso::chol_solve<6>(Ad, s_sys + 21, dT);
                bool ok = true;
                for (int i = 0; i < 6; ++i) ok = ok && isfinite(dT[i]);
                for (int i = 0; i < 6; ++i) s_dT[i] = ok ? dT[i] : 0.f;
                float R[9], t[3];
                hso::se3_exp(s_dT, R, t);
                hso::se3_mul_left(R, t, s_T, s_Tn);     // T_new = exp(dT) * T
                s_ok = ok ? 1 : 0;
            }
            __syncthreads();
            chi2_of(O, s_Tn, warp_buf, s_chi);
            if (threadIdx.x == 0) {
                const float chi2_new = s_chi[0];
                const float rho = s_ok ? s_chi2 - chi2_new : -1.0f;
                s_trials += 1;
                if (rho > 0.f) {
                    for (int k = 0; k < 12; ++k) s_T[k] = s_Tn[k];
                    s_chi2 = chi2_new;
                    for (int i = 0; i < 6; ++i)
                        for (int j = 0; j < 6; ++j) {
                            const int lo = i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
                            s_Alast[i * 6 + j] = s_sys[lo];
                        }
                    // the raw chi2 decrease feeds the Nielsen update
                    const float q = 2.0f * rho - 1.0f;
                    s_mu = s_mu * fmaxf(1.0f / 3.0f, fminf(1.0f - q * q * q, 2.0f / 3.0f));
                    s_nu = 2.0f;
                    float mx = 0.f;
                    for (int i = 0; i < 6; ++i) mx = fmaxf(mx, fabsf(s_dT[i]));
                    if (mx <= STEP_EPS) s_stop = 1;
                    s_accepted = 1;
                } else {
                    s_mu = fmaxf(s_mu * s_nu, 1e-4f);
                    s_nu = s_nu * 2.0f;
                }
            }
            __syncthreads();
            if (s_accepted) break;         // uniform
        }
        __syncthreads();                   // everyone has read s_accepted
        if (threadIdx.x == 0 && !s_accepted) s_stop = 1;
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        for (int k = 0; k < 12; ++k) out[k] = s_T[k];
        for (int k = 0; k < 36; ++k) out[12 + k] = s_Alast[k];
        out[48] = s_chi2;
        out[49] = (float)s_trials;
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
    pose_lm_kernel<<<1, THREADS, 0, stream>>>(O, T0, scales, n_iter, out);
    return (int)cudaGetLastError();
}
