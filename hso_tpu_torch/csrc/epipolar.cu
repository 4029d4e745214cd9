// K6: dense zero-mean NCC of each seed's 8x8 template over its search window,
// sampled along the seed's epipolar segment; best score, second-best score at
// step distance > 1, and the first step that reaches the best.
//
// Replaces the Pallas kernel zmncc_line_scores_tpu (ops/epipolar_pallas.py of
// the JAX package).  That kernel puts 128 seeds on the lane axis, transposes
// the windows to (EW, EW, S) and samples the score map by a dense weighted
// sum over all of it; here a seed is one thread block.  Its window, template,
// the two row-sum planes and the (EW-7)^2 score map sit in shared memory
// (21.6 KB at EW 40, 32 KB at EW 48), the threads stride over score-map
// positions, and warp 0 then reads four taps per line step from the map and
// reduces best / first-hit step / second-best with shuffles in a fixed order.
// No atomics: two runs are bitwise equal.
//
// Bound: operations (64 multiply-adds per map entry against one read of
// EW*EW + 64 floats per seed); nothing but three numbers per seed goes back to
// device memory.
//
// Rounding: var_t = sum(t^2) - sum(t)^2/64 and num = corr - mean*sum(t) cancel
// in low-texture windows and are then divided, so every sum that feeds them is
// taken in the order of the plain PyTorch version (zmncc_line_scores_plain)
// with explicitly rounded multiplies and adds (__fmul_rn/__fadd_rn keep nvcc
// from contracting them into FMAs): those intermediates agree bit for bit.
//
// The plain version samples the map densely (every entry times its two-tap
// weight), so a single non-finite map entry turns all of a seed's unmasked
// scores into NaN there.  The kernel keeps that contract with one block-wide
// flag instead of the dense product.
#include "common.cuh"

namespace {

constexpr int PATCH = 8;
constexpr int THREADS = 256;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ int warp_min_int(int x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__global__ void __launch_bounds__(THREADS)
zmncc_line_kernel(const float* __restrict__ windows, const float* __restrict__ ref_patch,
                  const float* __restrict__ su0, const float* __restrict__ sv0,
                  const float* __restrict__ dir_u, const float* __restrict__ dir_v,
                  const int* __restrict__ n_line, const int* __restrict__ au,
                  const int* __restrict__ av, const int* __restrict__ hs,
                  const int* __restrict__ ws, int ew, int n_steps,
                  float* __restrict__ best_out, float* __restrict__ second_out,
                  int* __restrict__ k_out) {
    extern __shared__ float sm[];
    const int s = blockIdx.x;
    const int ow = ew - PATCH + 1;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float* w = sm;                          // ew * ew
    float* t = w + ew * ew;                 // 64
    float* rs1 = t + PATCH * PATCH;         // ew * ow row sums of w
    float* rs2 = rs1 + ew * ow;             // ew * ow row sums of w*w
    float* zm = rs2 + ew * ow;              // ow * ow score map
    float* sc = zm + ow * ow;               // n_steps line scores
    float* stat = sc + n_steps;             // [ref_mean, ref_den]

    for (int i = tid; i < ew * ew; i += THREADS) w[i] = windows[(size_t)s * ew * ew + i];
    if (tid < PATCH * PATCH) t[tid] = ref_patch[(size_t)s * PATCH * PATCH + tid];
    __syncthreads();

    // template mean and zero-mean energy: lane l holds entries l and l+32, then
    // a butterfly (the halving tree of the plain version)
    if (warp == 0) {
        const float a = t[lane], b = t[lane + 32];
        const float mean = hso::warp_sum(__fadd_rn(a, b)) * (1.0f / 64.0f);
        const float da = __fsub_rn(a, mean), db = __fsub_rn(b, mean);
        const float den = hso::warp_sum(__fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)));
        if (lane == 0) {
            stat[0] = mean;
            stat[1] = den;
        }
    }
    // row sums over 8 columns, left to right
    for (int i = tid; i < ew * ow; i += THREADS) {
        const int y = i / ow, x = i - y * ow;
        const float* row = w + y * ew + x;
        float a1 = row[0], a2 = __fmul_rn(row[0], row[0]);
#pragma unroll
        for (int dx = 1; dx < PATCH; ++dx) {
            a1 = __fadd_rn(a1, row[dx]);
            a2 = __fadd_rn(a2, __fmul_rn(row[dx], row[dx]));
        }
        rs1[i] = a1;
        rs2[i] = a2;
    }
    __syncthreads();

    const float ref_mean = stat[0], ref_den = stat[1];
    int bad = 0;
    for (int i = tid; i < ow * ow; i += THREADS) {
        const int y = i / ow, x = i - y * ow;
        float st = rs1[y * ow + x], st2 = rs2[y * ow + x];
#pragma unroll
        for (int dy = 1; dy < PATCH; ++dy) {
            st = __fadd_rn(st, rs1[(y + dy) * ow + x]);
            st2 = __fadd_rn(st2, rs2[(y + dy) * ow + x]);
        }
        float corr = 0.f;
#pragma unroll
        for (int a = 0; a < PATCH; ++a) {
#pragma unroll
            for (int b = 0; b < PATCH; ++b) {
                const float p = __fmul_rn(w[(y + a) * ew + x + b], t[a * PATCH + b]);
                corr = (a == 0 && b == 0) ? p : __fadd_rn(corr, p);
            }
        }
        const float num = __fsub_rn(corr, __fmul_rn(ref_mean, st));
        float var_t = __fsub_rn(st2, __fmul_rn(__fmul_rn(st, st), 1.0f / 64.0f));
        if (!(var_t != var_t)) var_t = fmaxf(var_t, 0.0f);      // a NaN stays a NaN
        const float z = num / (sqrtf(__fmul_rn(ref_den, var_t)) + 1e-12f);
        if (!isfinite(z)) bad = 1;
        zm[i] = z;
    }
    const int poisoned = __syncthreads_or(bad);     // also the barrier before the line pass
    if (warp != 0) return;

    const float u0 = su0[s], v0 = sv0[s], du = dir_u[s], dv = dir_v[s];
    const float nl = (float)n_line[s];
    const float au_ = (float)au[s], av_ = (float)av[s];
    const float hf = (float)hs[s], wf = (float)ws[s];
    const float lim = (float)(ow - 1);
    const float NEG = -INFINITY;

    float l_best = NEG;
    int l_nan = n_steps;                    // first NaN step seen by this lane
    for (int k = lane; k < n_steps; k += 32) {
        const float kf = (float)k;
        const float su = __fadd_rn(u0, __fmul_rn(du, kf));
        const float sv = __fadd_rn(v0, __fmul_rn(dv, kf));
        const float pu = __fadd_rn(__fadd_rn(su, 4.0f), au_);
        const float pv = __fadd_rn(__fadd_rn(sv, 4.0f), av_);
        const bool inside = (kf <= nl) && (su >= 0.0f) && (su <= lim) && (sv >= 0.0f) &&
                            (sv <= lim) && (pu - 4.0f >= 0.0f) && (pu + 4.0f <= wf - 1.0f) &&
                            (pv - 4.0f >= 0.0f) && (pv + 4.0f <= hf - 1.0f);
        float val = NEG;
        if (inside) {
            if (poisoned) {
                val = nanf("");
            } else {
                // two-tap weights max(0, 1 - |s - y|); a tap of weight 0 is not read
                // (at s == ow-1 exactly the second tap would be index ow)
                const int x0 = (int)floorf(su), y0 = (int)floorf(sv);
                const float wx0 = fmaxf(0.0f, 1.0f - fabsf(su - (float)x0));
                const float wx1 = fmaxf(0.0f, 1.0f - fabsf(su - (float)(x0 + 1)));
                const float wy0 = fmaxf(0.0f, 1.0f - fabsf(sv - (float)y0));
                const float wy1 = fmaxf(0.0f, 1.0f - fabsf(sv - (float)(y0 + 1)));
                const bool x1ok = (wx1 > 0.0f) && (x0 + 1 < ow);
                const bool y1ok = (wy1 > 0.0f) && (y0 + 1 < ow);
                float r0 = wy0 * zm[y0 * ow + x0];
                if (y1ok) r0 += wy1 * zm[(y0 + 1) * ow + x0];
                val = wx0 * r0;
                if (x1ok) {
                    float r1 = wy0 * zm[y0 * ow + x0 + 1];
                    if (y1ok) r1 += wy1 * zm[(y0 + 1) * ow + x0 + 1];
                    val += wx1 * r1;
                }
            }
        }
        sc[k] = val;
        if (val != val) l_nan = min(l_nan, k);
        else l_best = fmaxf(l_best, val);
    }
    __syncwarp();
    const int first_nan = warp_min_int(l_nan);
    float best, second;
    int kb;
    if (first_nan < n_steps) {              // a NaN wins the maximum, at its first step
        best = nanf("");
        second = nanf("");
        kb = first_nan;
    } else {
        best = warp_max(l_best);
        int l_k = n_steps;
        for (int k = lane; k < n_steps; k += 32)
            if (sc[k] >= best) l_k = min(l_k, k);
        kb = warp_min_int(l_k);             // smallest step that reaches the best
        float l_second = NEG;
        for (int k = lane; k < n_steps; k += 32)
            if (k - kb > 1 || kb - k > 1) l_second = fmaxf(l_second, sc[k]);
        second = warp_max(l_second);
    }
    if (lane == 0) {
        best_out[s] = best;
        second_out[s] = second;
        k_out[s] = min(max(kb, 0), n_steps - 1);
    }
}

}  // namespace

extern "C" int hso_zmncc_line_scores(const float* windows, const float* ref_patch,
                                     const float* su0, const float* sv0, const float* dir_u,
                                     const float* dir_v, const int* n_line, const int* au,
                                     const int* av, const int* hs, const int* ws, int S, int ew,
                                     int n_steps, float* best, float* second, int* k_best,
                                     cudaStream_t stream) {
    const int ow = ew - PATCH + 1;
    const size_t bytes =
        (size_t)(ew * ew + PATCH * PATCH + 2 * ew * ow + ow * ow + n_steps + 2) * sizeof(float);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(zmncc_line_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    zmncc_line_kernel<<<S, THREADS, bytes, stream>>>(windows, ref_patch, su0, sv0, dir_u, dir_v,
                                                     n_line, au, av, hs, ws, ew, n_steps, best,
                                                     second, k_best);
    return (int)cudaGetLastError();
}
