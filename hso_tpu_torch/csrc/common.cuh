// Shared device helpers of the hand-written kernels: deterministic block
// reductions, small Cholesky solves in registers, SE(3) exponential and 3x4
// products, and the scalar steps of the two LM kernels; on the host side the
// opt-in to more than 48 KB of dynamic shared memory.
//
// Determinism: every sum is taken in a fixed order (per-thread partials laid
// out in shared memory, a serial pass in thread order, then a shuffle
// butterfly).  No floating-point atomics anywhere, so two runs on the same
// inputs are bitwise equal.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hso {

// Butterfly sum over a warp: every lane gets the same value, in a fixed order.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// Transposed sum over a warp: every lane holds M values (M a power of two up
// to 32); on return lane l holds, in the value returned, the sum over all 32
// lanes of entry l / (32 / M).  Recursive halving: at each step a lane keeps one
// half of its entries and hands the other half to its partner, so M entries
// cost M - 1 shuffles (plus 5 - log2(M) to finish) where M butterflies would
// cost 5 M.  The order of every addition is fixed.  Written as a template
// recursion so that every array index is a constant and the values stay in
// registers.
template <int M, int OFF>
struct TransposeSum {
    static __device__ __forceinline__ float run(const float (&v)[M], unsigned lane) {
        constexpr int H = M / 2;
        const bool upper = (lane & OFF) != 0;
        float w[H];
#pragma unroll
        for (int j = 0; j < H; ++j) {
            const float send = upper ? v[j] : v[j + H];
            const float keep = upper ? v[j + H] : v[j];
            w[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
        }
        return TransposeSum<H, OFF / 2>::run(w, lane);
    }
};

template <int OFF>
struct TransposeSum<1, OFF> {
    static __device__ __forceinline__ float run(const float (&v)[1], unsigned) {
        float x = v[0];
#pragma unroll
        for (int off = OFF; off >= 1; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        return x;
    }
};

template <int M>
__device__ __forceinline__ float warp_transpose_sum(const float (&v)[M]) {
    return TransposeSum<M, 16>::run(v, threadIdx.x & 31u);
}

// Host side: let `kernel` ask for `bytes` of dynamic shared memory.  Up to
// 48 KB needs nothing; above it the kernel opts in, once per device and only
// when a launch needs more than any before it.  `seen` is the caller's record
// for this kernel (a function-local static; one per template instance).
struct SmemOptIn {
    size_t allowed[64] = {};
};

template <class Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes, SmemOptIn& seen) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    const bool known = dev >= 0 && dev < 64;
    if (known && bytes <= seen.allowed[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess && known) seen.allowed[dev] = bytes;
    return e;
}

__host__ __device__ constexpr int next_pow2(int n) { return n <= 1 ? 1 : 2 * next_pow2((n + 1) / 2); }

// K sums over the block in a fixed order, without K shuffle trees in sequence:
// each warp sums its lanes' partials by transposed sums (32 entries at a time,
// the rest padded to a power of two) and writes its K sums to
// wbuf[warp * K + k] (shared, K * blockDim.x / 32 floats); after one barrier
// thread k < K adds the warps' sums in warp order and writes out[k] (shared).
// blockDim.x must be a multiple of 32 and at least K.  There is NO barrier
// after the write of out: the caller places the block or cluster barrier that
// its readers need, and that same barrier is what allows wbuf to be written
// again.
template <int K>
__device__ __forceinline__ void block_sums(const float (&v)[K], float* __restrict__ wbuf,
                                           float* __restrict__ out) {
    constexpr int FULL = K / 32 * 32;
    constexpr int REM = K - FULL;
    const unsigned lane = threadIdx.x & 31u;
    const unsigned warp = threadIdx.x >> 5;
    const unsigned nwarps = blockDim.x >> 5;
#pragma unroll
    for (int c = 0; c < FULL; c += 32) {
        float t[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) t[j] = v[c + j];
        wbuf[warp * K + c + lane] = warp_transpose_sum<32>(t);
    }
    if constexpr (REM > 0) {
        constexpr int PAD = next_pow2(REM);
        constexpr int GROUP = 32 / PAD;
        float t[PAD];
#pragma unroll
        for (int j = 0; j < PAD; ++j) t[j] = j < REM ? v[FULL + (j < REM ? j : 0)] : 0.f;   // padded with zeros
        const float x = warp_transpose_sum<PAD>(t);
        if (lane % GROUP == 0 && lane / GROUP < REM) wbuf[warp * K + FULL + lane / GROUP] = x;
    }
    __syncthreads();
    if (threadIdx.x < K) {
        float s = 0.f;
#pragma unroll 8
        for (unsigned w = 0; w < nwarps; ++w) s += wbuf[w * K + threadIdx.x];
        out[threadIdx.x] = s;
    }
}

// Solve A x = b for a small SPD matrix by Cholesky and two substitutions,
// wholly in registers: L holds the lower triangle of A packed row by row
// (entry (i, j), j <= i, at i*(i+1)/2 + j) and is overwritten; every loop is
// unrolled so that every index is a constant.  The serial chain is what costs
// here, so there is no square root and no division on it: each pivot gives
// one reciprocal square root (the hardware's estimate refined by one Newton
// step, exact to rounding), the off-diagonal entries and both substitutions
// multiply by it.  A non-positive (or NaN) pivot gives NaN in x, so the
// caller's finite test rejects the step (fmaxf(NaN, x) returns x on this
// hardware, hence the explicit test); 1e-12 guards tiny positive pivots.
template <int N>
__device__ __forceinline__ void chol_solve_packed(float (&L)[N * (N + 1) / 2], const float (&b)[N],
                                                  float (&x)[N]) {
    float inv[N];          // 1 / L[j][j]
#pragma unroll
    for (int j = 0; j < N; ++j) {
        float s = L[j * (j + 1) / 2 + j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= L[j * (j + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
        const float sc = fmaxf(s, 1e-12f);
        float r = rsqrtf(sc);
        r = r * (1.5f - 0.5f * sc * r * r);
        inv[j] = (s <= 0.f || isnan(s)) ? nanf("") : r;
#pragma unroll
        for (int i = j + 1; i < N; ++i) {
            float t = L[i * (i + 1) / 2 + j];
#pragma unroll
            for (int k = 0; k < j; ++k) t -= L[i * (i + 1) / 2 + k] * L[j * (j + 1) / 2 + k];
            L[i * (i + 1) / 2 + j] = t * inv[j];
        }
    }
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i * (i + 1) / 2 + k] * y[k];
        y[i] = s * inv[i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < N; ++k) s -= L[k * (k + 1) / 2 + i] * x[k];
        x[i] = s * inv[i];
    }
}

// SE(3) exponential of xi = [rho, phi] -> R (row-major 3x3), t (3).  The
// coefficients a = sin(th)/th, b = (1 - cos th)/th^2, c = (th - sin th)/th^3 are
// even power series in th; below th^2 = 0.25 (28 degrees, far above any LM
// step) six terms of each are exact to float32 rounding (the first omitted
// term is below 1e-13) and put three short multiply-add chains where a square
// root, a sine, a cosine and three divisions stood on the serial path.  The
// package's se3 module switches to two terms below th^2 = 1e-6; the series
// agrees with both of its branches to rounding.
__device__ __forceinline__ void se3_exp(const float* xi, float* R, float* t) {
    const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
    const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
    float a, b, c;
    if (theta2 < 0.25f) {
        const float q = theta2;
        a = 1.0f + q * (-1.0f / 6 + q * (1.0f / 120 + q * (-1.0f / 5040 + q * (1.0f / 362880 +
            q * (-1.0f / 39916800)))));
        b = 0.5f + q * (-1.0f / 24 + q * (1.0f / 720 + q * (-1.0f / 40320 + q * (1.0f / 3628800 +
            q * (-1.0f / 479001600)))));
        c = 1.0f / 6 + q * (-1.0f / 120 + q * (1.0f / 5040 + q * (-1.0f / 362880 +
            q * (1.0f / 39916800 + q * (-1.0f / 6227020800.0f)))));
    } else {
        const float theta = sqrtf(theta2);
        const float sn = sinf(theta), cs = cosf(theta);
        a = sn / theta;
        b = (1.0f - cs) / theta2;
        c = (theta - sn) / (theta2 * theta);
    }
    const float K[9] = {0.f, -p2, p1, p2, 0.f, -p0, -p1, p0, 0.f};
    float K2[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            K2[i * 3 + j] = K[i * 3 + 0] * K[0 * 3 + j] + K[i * 3 + 1] * K[1 * 3 + j] +
                            K[i * 3 + 2] * K[2 * 3 + j];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        float ti = 0.f;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float I = (i == j) ? 1.0f : 0.0f;
            R[i * 3 + j] = I + a * K[i * 3 + j] + b * K2[i * 3 + j];
            ti += (I + b * K[i * 3 + j] + c * K2[i * 3 + j]) * xi[j];
        }
        t[i] = ti;
    }
}

// out = T * [R|t]  (T, out row-major 3x4)
__device__ __forceinline__ void se3_mul_right(const float* T, const float* R, const float* t, float* out) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
            out[i * 4 + j] = T[i * 4 + 0] * R[0 * 3 + j] + T[i * 4 + 1] * R[1 * 3 + j] +
                             T[i * 4 + 2] * R[2 * 3 + j];
        out[i * 4 + 3] = T[i * 4 + 0] * t[0] + T[i * 4 + 1] * t[1] + T[i * 4 + 2] * t[2] +
                         T[i * 4 + 3];
    }
}

// out = [R|t] * T  (T, out row-major 3x4)
__device__ __forceinline__ void se3_mul_left(const float* R, const float* t, const float* T, float* out) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float v = R[i * 3 + 0] * T[0 * 4 + j] + R[i * 3 + 1] * T[1 * 4 + j] +
                      R[i * 3 + 2] * T[2 * 4 + j];
            if (j == 3) v += t[i];
            out[i * 4 + j] = v;
        }
    }
}

// Scalar step of the coarse tracker's LM (kernel K3) from the 35 sums
// Hb = [H lower triangle packed (28), b (7)] over [exposure ratio; se3]:
// damped solve, extrapolation below lam 1e-3, a non-finite step becomes 0,
// inverse-compositional update Tn = T * exp(-step[1:7]), an = a + step[0].
// Everything stays in registers; every block of a cluster runs it on the same
// sums and holds the same bits.
__device__ __forceinline__ void coarse_lm_step(const float* Hb, float lam, const float (&T)[12],
                                               float a, float (&Tn)[12], float& an,
                                               float& stepnorm) {
    float L[28], b[7], step[7];
#pragma unroll
    for (int k = 0; k < 28; ++k) L[k] = Hb[k];
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        b[i] = Hb[28 + i];
        L[i * (i + 1) / 2 + i] += L[i * (i + 1) / 2 + i] * lam;
    }
    chol_solve_packed<7>(L, b, step);
    const float extrap = lam < 1e-3f ? sqrtf(sqrtf(1e-3f / lam)) : 1.0f;
    bool finite = true;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        step[i] *= extrap;
        finite = finite && isfinite(step[i]);
    }
    float sn = 0.f;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        if (!finite) step[i] = 0.f;
        sn += step[i] * step[i];
    }
    float xi[6], R[9], t[3];
#pragma unroll
    for (int i = 0; i < 6; ++i) xi[i] = -step[i + 1];
    se3_exp(xi, R, t);
    se3_mul_right(T, R, t, Tn);
    an = a + step[0];
    stepnorm = sqrtf(sn);
}

// Scalar step of the pose LM (kernel K5) from the 27 sums S = [A lower
// triangle packed (21), b (6)]: damped solve, a non-finite step becomes 0 and
// returns false, Tn = exp(dT) * T.  In registers, as coarse_lm_step.
__device__ __forceinline__ bool pose_lm_step(const float* S, float mu, const float (&T)[12],
                                             float (&Tn)[12], float (&dT)[6]) {
    float L[21], b[6];
#pragma unroll
    for (int k = 0; k < 21; ++k) L[k] = S[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        b[i] = S[21 + i];
        L[i * (i + 1) / 2 + i] += L[i * (i + 1) / 2 + i] * mu;
    }
    chol_solve_packed<6>(L, b, dT);
    bool ok = true;
#pragma unroll
    for (int i = 0; i < 6; ++i) ok = ok && isfinite(dT[i]);
#pragma unroll
    for (int i = 0; i < 6; ++i) dT[i] = ok ? dT[i] : 0.f;
    float R[9], t[3];
    se3_exp(dT, R, t);
    se3_mul_left(R, t, T, Tn);
    return ok;
}

// Bilinear read at (px, py) inside a win x win window; a tap outside the
// window reads 0, and so does a non-finite coordinate.
__device__ __forceinline__ float sample_window(const float* w, int win, float px, float py) {
    if (!(px > -1.0f && px < (float)win && py > -1.0f && py < (float)win)) return 0.f;
    const float x0f = floorf(px), y0f = floorf(py);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const float fx = px - x0f, fy = py - y0f;
    const bool xa = x0 >= 0, xb = x0 + 1 < win, ya = y0 >= 0, yb = y0 + 1 < win;
    const float v00 = (xa && ya) ? w[y0 * win + x0] : 0.f;
    const float v10 = (xb && ya) ? w[y0 * win + x0 + 1] : 0.f;
    const float v01 = (xa && yb) ? w[(y0 + 1) * win + x0] : 0.f;
    const float v11 = (xb && yb) ? w[(y0 + 1) * win + x0 + 1] : 0.f;
    return v00 * ((1.0f - fx) * (1.0f - fy)) + v10 * (fx * (1.0f - fy)) +
           v01 * ((1.0f - fx) * fy) + v11 * (fx * fy);
}

}  // namespace hso
