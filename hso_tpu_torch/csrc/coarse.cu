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
// accept/reject decision, so the iterations are serial and one block runs the
// whole loop.  Per iteration the block touches N*P*(4 taps + 7 Jacobian
// entries) floats, all served by L2 after the first pass.
// Design: 512 threads; phase A projects the N features once per evaluation
// into shared memory, phase B strides over the N*P items accumulating 37
// partials in registers, then a fixed-order shuffle + shared-memory tree
// (no float atomics: two runs are bitwise equal).  Thread 0 does the scalar
// bookkeeping and broadcasts through shared memory.  The windows (N*576
// floats, 774 KB at N=336) do not fit one block's shared memory and are
// re-read from L2 each iteration; spreading the evaluation over a cluster
// with the windows resident in distributed shared memory is what a later
// change can do about that.
#include "common.cuh"

struct PatternTable {
    int dx[32];
    int dy[32];
};

namespace {

constexpr int WIN = 24;
constexpr int NS = 37;   // 28 lower-triangular H entries, 7 of b, E, n_terms
constexpr int THREADS = 512;

struct Args {
    const float* w_cur;       // (N, 24, 24)
    const float* ref_patch;   // (N, P)
    const float* j_ic;        // (N, P, 6)
    const float* xyz_ref;     // (N, 3)
    const int* au;            // (N)
    const int* av;            // (N)
    const unsigned char* vis; // (N)
    float fx, fy, cx, cy;
    int N, P, g, center;
    int is_top, border, h_img, w_img;
    float huber, cutoff;
};

// Evaluate the robust system at (T, a): fills sums[NS] (shared) for all threads.
__device__ void evaluate(const Args& A, const PatternTable& pat, const float* T, float a,
                         float* s_relu, float* s_relv, unsigned char* s_valid,
                         float* warp_buf, float* sums) {
    const float T0 = T[0], T1 = T[1], T2 = T[2], T3 = T[3];
    const float T4 = T[4], T5 = T[5], T6 = T[6], T7 = T[7];
    const float T8 = T[8], T9 = T[9], T10 = T[10], T11 = T[11];
    __syncthreads();   // earlier readers of s_relu/s_valid are done
    for (int n = threadIdx.x; n < A.N; n += blockDim.x) {
        const float X = A.xyz_ref[3 * n], Y = A.xyz_ref[3 * n + 1], Z = A.xyz_ref[3 * n + 2];
        const float xc = T0 * X + T1 * Y + T2 * Z + T3;
        const float yc = T4 * X + T5 * Y + T6 * Z + T7;
        const float zc = T8 * X + T9 * Y + T10 * Z + T11;
        const float zi = 1.0f / (fabsf(zc) < 1e-9f ? 1e-9f : zc);
        const float u = A.fx * xc * zi + A.cx;
        const float v = A.fy * yc * zi + A.cy;
        const float rel_u = u - (float)A.center - (float)A.au[n];
        const float rel_v = v - (float)A.center - (float)A.av[n];
        const float uf = floorf(u), vf = floorf(v);
        const float span = (float)(A.g - 1);
        const bool valid = A.vis[n] && (zc > 0.0f) && (rel_u >= 0.0f) &&
                           (rel_u + span <= (float)(WIN - 1)) && (rel_v >= 0.0f) &&
                           (rel_v + span <= (float)(WIN - 1)) && (uf - A.border >= 0.0f) &&
                           (vf - A.border >= 0.0f) && (uf + A.border < (float)A.w_img) &&
                           (vf + A.border < (float)A.h_img);
        s_relu[n] = rel_u;
        s_relv[n] = rel_v;
        s_valid[n] = valid ? 1 : 0;
    }
    __syncthreads();

    float acc[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) acc[k] = 0.f;
    const float max_energy = 2.0f * A.huber * A.cutoff - A.huber * A.huber;
    const int items = A.N * A.P;
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
        const int n = item / A.P;
        if (!s_valid[n]) continue;
        const int k = item - n * A.P;
        const float pu = s_relu[n] + (float)(A.center + pat.dx[k]);
        const float pv = s_relv[n] + (float)(A.center + pat.dy[k]);
        const float cur = hso::sample_window(A.w_cur + (size_t)n * WIN * WIN, WIN, pu, pv);
        const float ref = A.ref_patch[item];
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
        const float* jp = A.j_ic + (size_t)item * 6;
#pragma unroll
        for (int q = 0; q < 6; ++q) J[q + 1] = a * jp[q];
        int idx = 0;
#pragma unroll
        for (int i = 0; i < 7; ++i) {
            const float wi = wgt * J[i];
            acc[28 + i] -= wi * r;
#pragma unroll
            for (int j = 0; j <= i; ++j) acc[idx++] += wi * J[j];
        }
    }
    hso::block_reduce_sum<NS>(acc, warp_buf, sums);
}

__global__ void __launch_bounds__(THREADS)
coarse_level_ic_kernel(Args A, PatternTable pat, const float* __restrict__ T0,
                       const float* __restrict__ sc, int n_iter, float* __restrict__ out) {
    extern __shared__ float dyn[];
    float* s_relu = dyn;
    float* s_relv = dyn + A.N;
    unsigned char* s_valid = reinterpret_cast<unsigned char*>(dyn + 2 * A.N);
    __shared__ float warp_buf[32 * NS];
    __shared__ float sums[NS];
    __shared__ float s_T[12], s_Tn[12], s_Hb[35];
    __shared__ float s_a, s_an, s_lam, s_E, s_nt, s_stepnorm;
    __shared__ int s_it, s_stop;

    A.huber = sc[1];
    A.cutoff = sc[2];
    if (threadIdx.x == 0) {
        for (int k = 0; k < 12; ++k) s_T[k] = T0[k];
        s_a = sc[0];
        s_lam = 0.1f;
        s_it = 0;
        s_stop = 0;
    }
    __syncthreads();
    evaluate(A, pat, s_T, s_a, s_relu, s_relv, s_valid, warp_buf, sums);
    if (threadIdx.x == 0) {
        for (int k = 0; k < 35; ++k) s_Hb[k] = sums[k];
        s_nt = sums[36];
        s_E = sums[35] / fmaxf(sums[36], 1.0f);
    }
    __syncthreads();

    while (s_it < n_iter && !s_stop) {
        if (threadIdx.x == 0) {
            float Hl[49], b[7], step[7];
            for (int i = 0; i < 7; ++i) {
                b[i] = s_Hb[28 + i];
                for (int j = 0; j <= i; ++j) {
                    const float h = s_Hb[i * (i + 1) / 2 + j];
                    Hl[i * 7 + j] = h;
                    Hl[j * 7 + i] = h;
                }
            }
            const float lam = s_lam;
            for (int i = 0; i < 7; ++i) Hl[i * 7 + i] += Hl[i * 7 + i] * lam;
            hso::chol_solve<7>(Hl, b, step);
            const float extrap = lam < 1e-3f ? sqrtf(sqrtf(1e-3f / lam)) : 1.0f;
            bool finite = true;
            for (int i = 0; i < 7; ++i) {
                step[i] *= extrap;
                finite = finite && isfinite(step[i]);
            }
            float sn = 0.f;
            float xi[6];
            for (int i = 0; i < 7; ++i) {
                if (!finite) step[i] = 0.f;
                sn += step[i] * step[i];
            }
            for (int i = 0; i < 6; ++i) xi[i] = -step[i + 1];
            float R[9], t[3];
            hso::se3_exp(xi, R, t);
            hso::se3_mul_right(s_T, R, t, s_Tn);      // IC update: T_new = T * dT
            s_an = s_a + step[0];
            s_stepnorm = sqrtf(sn);
        }
        __syncthreads();
        evaluate(A, pat, s_Tn, s_an, s_relu, s_relv, s_valid, warp_buf, sums);
        if (threadIdx.x == 0) {
            const float E_new = sums[35] / fmaxf(sums[36], 1.0f);
            if (E_new < s_E) {                         // false on NaN: reject
                for (int k = 0; k < 12; ++k) s_T[k] = s_Tn[k];
                s_a = s_an;
                s_E = E_new;
                for (int k = 0; k < 35; ++k) s_Hb[k] = sums[k];
                s_nt = sums[36];
                s_lam = s_lam * 0.5f;
            } else {
                s_lam = fmaxf(s_lam * 4.0f, 1e-3f);
            }
            s_it = s_it + 1;
            s_stop = s_stepnorm <= 1e-4f ? 1 : 0;
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        for (int k = 0; k < 12; ++k) out[k] = s_T[k];
        out[12] = s_a;
        out[13] = s_E;
        out[14] = s_nt;
        out[15] = (float)s_it;
    }
}

}  // namespace

extern "C" int hso_coarse_level_ic(const float* w_cur, const float* ref_patch, const float* j_ic,
                                   const float* xyz_ref, const int* au, const int* av,
                                   const unsigned char* vis, const float* T0, const float* sc,
                                   float fx, float fy, float cx, float cy, int N, int P, int g,
                                   int center, const PatternTable* pat, int n_iter, int is_top,
                                   int border, int h_img, int w_img, float* out,
                                   cudaStream_t stream) {
    Args A;
    A.w_cur = w_cur; A.ref_patch = ref_patch; A.j_ic = j_ic; A.xyz_ref = xyz_ref;
    A.au = au; A.av = av; A.vis = vis;
    A.fx = fx; A.fy = fy; A.cx = cx; A.cy = cy;
    A.N = N; A.P = P; A.g = g; A.center = center;
    A.is_top = is_top; A.border = border; A.h_img = h_img; A.w_img = w_img;
    A.huber = 0.f; A.cutoff = 0.f;   // read from sc on the device
    const size_t dyn_bytes = (size_t)N * (2 * sizeof(float) + 1) + 16;
    if (dyn_bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(coarse_level_ic_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)dyn_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    coarse_level_ic_kernel<<<1, THREADS, dyn_bytes, stream>>>(A, *pat, T0, sc, n_iter, out);
    return (int)cudaGetLastError();
}
