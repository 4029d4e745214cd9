// Shared device helpers of the hand-written kernels: deterministic block
// reductions, small Cholesky solves, SE(3) exponential and 3x4 products.
//
// Determinism: every sum is taken in a fixed order (warp shuffle tree, then a
// serial pass over the warps' partials).  No floating-point atomics anywhere,
// so two runs on the same inputs are bitwise equal.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace hso {

// Sum K per-thread partials over the block.  blockDim.x must be a multiple of
// 32 and at least K.  warp_buf holds 32*K floats, out holds K floats, both in
// shared memory; out is valid for every thread on return.
template <int K>
__device__ __forceinline__ void block_reduce_sum(float (&v)[K], float* warp_buf, float* out) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned warp = threadIdx.x >> 5;
    const unsigned nwarps = (blockDim.x + 31u) >> 5;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        float x = v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
        if (lane == 0) warp_buf[warp * K + k] = x;
    }
    __syncthreads();
    if (threadIdx.x < K) {
        float s = 0.f;
        for (unsigned w = 0; w < nwarps; ++w) s += warp_buf[w * K + threadIdx.x];
        out[threadIdx.x] = s;
    }
    __syncthreads();
}

// Butterfly sum over a warp: every lane gets the same value, in a fixed order.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// Solve A x = b for a small SPD matrix (row-major N*N) by Cholesky and two
// substitutions.  A non-positive (or NaN) pivot gives NaN in x, so the
// caller's finite test rejects the step; 1e-12 guards tiny positive pivots.
template <int N>
__device__ inline void chol_solve(const float* A, const float* b, float* x) {
    float L[N][N];
    for (int j = 0; j < N; ++j) {
        float s = A[j * N + j];
        for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
        const float d = (s <= 0.f || isnan(s)) ? nanf("") : sqrtf(fmaxf(s, 1e-12f));
        L[j][j] = d;
        const float inv_d = 1.0f / d;
        for (int i = j + 1; i < N; ++i) {
            float t = A[i * N + j];
            for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
            L[i][j] = t * inv_d;
        }
    }
    float y[N];
    for (int i = 0; i < N; ++i) {
        float s = b[i];
        for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
        y[i] = s / L[i][i];
    }
    for (int i = N - 1; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < N; ++k) s -= L[k][i] * x[k];
        x[i] = s / L[i][i];
    }
}

// SE(3) exponential of xi = [rho, phi] -> R (row-major 3x3), t (3), with the
// small-angle Taylor guards of the package's se3 module (theta^2 < 1e-6).
__device__ inline void se3_exp(const float* xi, float* R, float* t) {
    const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
    const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
    const bool small = theta2 < 1e-6f;
    const float theta2s = small ? 1.0f : theta2;
    const float theta = sqrtf(theta2s);
    const float sn = sinf(theta), cs = cosf(theta);
    const float a = small ? 1.0f - theta2 / 6.0f : sn / theta;
    const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cs) / theta2s;
    const float c = small ? 1.0f / 6.0f - theta2 / 120.0f : (theta - sn) / (theta2s * theta);
    const float K[9] = {0.f, -p2, p1, p2, 0.f, -p0, -p1, p0, 0.f};
    float K2[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            K2[i * 3 + j] = K[i * 3 + 0] * K[0 * 3 + j] + K[i * 3 + 1] * K[1 * 3 + j] +
                            K[i * 3 + 2] * K[2 * 3 + j];
    for (int i = 0; i < 3; ++i) {
        float ti = 0.f;
        for (int j = 0; j < 3; ++j) {
            const float I = (i == j) ? 1.0f : 0.0f;
            R[i * 3 + j] = I + a * K[i * 3 + j] + b * K2[i * 3 + j];
            ti += (I + b * K[i * 3 + j] + c * K2[i * 3 + j]) * xi[j];
        }
        t[i] = ti;
    }
}

// out = T * [R|t]  (T, out row-major 3x4)
__device__ inline void se3_mul_right(const float* T, const float* R, const float* t, float* out) {
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j)
            out[i * 4 + j] = T[i * 4 + 0] * R[0 * 3 + j] + T[i * 4 + 1] * R[1 * 3 + j] +
                             T[i * 4 + 2] * R[2 * 3 + j];
        out[i * 4 + 3] = T[i * 4 + 0] * t[0] + T[i * 4 + 1] * t[1] + T[i * 4 + 2] * t[2] +
                         T[i * 4 + 3];
    }
}

// out = [R|t] * T  (T, out row-major 3x4)
__device__ inline void se3_mul_left(const float* R, const float* t, const float* T, float* out) {
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 4; ++j) {
            float v = R[i * 3 + 0] * T[0 * 4 + j] + R[i * 3 + 1] * T[1 * 4 + j] +
                      R[i * 3 + 2] * T[2 * 4 + j];
            if (j == 3) v += t[i];
            out[i * 4 + j] = v;
        }
    }
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
