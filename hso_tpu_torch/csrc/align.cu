// K4: fused feature alignment (mixed 2-D corner / 1-D edgelet inverse-
// compositional LM), final NCC against the template and central-difference
// gradient at the result.
//
// Replaces the Pallas kernel align_match_tpu (ops/align_pallas.py of the JAX
// package).  That kernel puts candidates on the lane axis, transposes windows
// and templates to (..., S) and samples each 8x8 patch by a separable
// accumulation over the whole window; here a candidate is one warp, its
// window and 10x10 template sit in shared memory, each lane owns two of the
// 64 patch pixels and samples them with four taps, and every sum is a warp
// shuffle butterfly (fixed order, all lanes get the same value).
//
// Bound: operations and latency of the serial iterations; the bytes are one
// read of the windows and templates (S*(win*win+100) floats) and 8*S floats
// out.  All n_iter iterations run under the `active` mask exactly as the
// plain version does: a candidate that converged or left its window keeps
// the state it had, and no early exit changes which state is kept.
// `win` is a run-time parameter (24 for the matcher, 40 for the depth
// filter), shared memory is sized from it.
#include "common.cuh"

namespace {

constexpr int PATCH = 8;
constexpr int HALF = 4;
constexpr int BORD = 10;
constexpr int WARPS = 4;

__global__ void __launch_bounds__(WARPS * 32)
align_match_kernel(const unsigned char* __restrict__ is_edge, const float* __restrict__ direction,
                   const float* __restrict__ ref_border, const float* __restrict__ px_init,
                   const unsigned char* __restrict__ valid, const float* __restrict__ windows,
                   const int* __restrict__ au, const int* __restrict__ av,
                   const int* __restrict__ hs, const int* __restrict__ ws, int S, int win,
                   int n_iter, float* __restrict__ out) {
    extern __shared__ float sm[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s = blockIdx.x * WARPS + warp;
    if (s >= S) return;                    // whole warp leaves; no block barrier below
    const int nw = win * win;
    float* w = sm + warp * (nw + BORD * BORD);
    float* t = w + nw;
    for (int i = lane; i < nw; i += 32) w[i] = windows[(size_t)s * nw + i];
    for (int i = lane; i < BORD * BORD; i += 32) t[i] = ref_border[(size_t)s * BORD * BORD + i];
    __syncwarp();

    const bool edge = is_edge[s] != 0;
    const bool valid_ = valid[s] != 0;
    float d_u = direction[2 * s], d_v = direction[2 * s + 1];
    const float dn = fmaxf(sqrtf(d_u * d_u + d_v * d_v), 1e-9f);
    d_u /= dn;
    d_v /= dn;
    const float au_ = (float)au[s], av_ = (float)av[s];
    const float hf = (float)hs[s], wf = (float)ws[s];

    // template values / gradients / weights of this lane's two pixels
    float val[2], dx[2], dy[2], jd[2], wgt1[2], wgt2[2], wgt[2];
    int px_x[2], px_y[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int p = lane + 32 * q;
        const int y = p >> 3, x = p & 7;
        px_x[q] = x;
        px_y[q] = y;
        val[q] = t[(y + 1) * BORD + x + 1];
        dx[q] = 0.5f * (t[(y + 1) * BORD + x + 2] - t[(y + 1) * BORD + x]);
        dy[q] = 0.5f * (t[(y + 2) * BORD + x + 1] - t[y * BORD + x + 1]);
        wgt2[q] = sqrtf(250.0f / (250.0f + dx[q] * dx[q] + dy[q] * dy[q]));
        jd[q] = dx[q] * d_u + dy[q] * d_v;
        wgt1[q] = sqrtf(250.0f / (250.0f + jd[q] * jd[q]));
        wgt[q] = edge ? wgt1[q] : wgt2[q];
    }
    using hso::warp_sum;
    // 3-DoF corner Hessian (j3 = [dx, dy, 1]) with 1.001 diagonal, adjugate inverse
    const float h00 = warp_sum(wgt2[0] * dx[0] * dx[0] + wgt2[1] * dx[1] * dx[1]) * 1.001f;
    const float h01 = warp_sum(wgt2[0] * dx[0] * dy[0] + wgt2[1] * dx[1] * dy[1]);
    const float h02 = warp_sum(wgt2[0] * dx[0] + wgt2[1] * dx[1]);
    const float h11 = warp_sum(wgt2[0] * dy[0] * dy[0] + wgt2[1] * dy[1] * dy[1]) * 1.001f;
    const float h12 = warp_sum(wgt2[0] * dy[0] + wgt2[1] * dy[1]);
    const float h22 = warp_sum(wgt2[0] + wgt2[1]) * 1.001f;
    const float c00 = h11 * h22 - h12 * h12;
    const float c01 = h02 * h12 - h01 * h22;
    const float c02 = h01 * h12 - h02 * h11;
    const float c11 = h00 * h22 - h02 * h02;
    const float c12 = h01 * h02 - h00 * h12;
    const float c22 = h00 * h11 - h01 * h01;
    float det3 = h00 * c00 + h01 * c01 + h02 * c02;
    if (fabsf(det3) < 1e-12f) det3 = 1e-12f;
    const float i3 = 1.0f / det3;
    // 2-DoF edgelet Hessian (j2 = [jd, 1]) with 1.001 diagonal
    const float a2 = warp_sum(wgt1[0] * jd[0] * jd[0] + wgt1[1] * jd[1] * jd[1]) * 1.001f;
    const float b2 = warp_sum(wgt1[0] * jd[0] + wgt1[1] * jd[1]);
    const float c2 = warp_sum(wgt1[0] + wgt1[1]) * 1.001f;
    float det2 = a2 * c2 - b2 * b2;
    if (fabsf(det2) < 1e-12f) det2 = 1e-12f;
    const float i2 = 1.0f / det2;

    float u = px_init[2 * s], v = px_init[2 * s + 1];
    float mean = 0.f, chi2 = 0.f;
    bool active = valid_, conv = false;
    const float wlim = (float)(win - 1);

    for (int it = 0; it < n_iter; ++it) {
        const float rel_u = (u - HALF) - au_;
        const float rel_v = (v - HALF) - av_;
        const float ur = floorf(u), vr = floorf(v);
        const bool inb = (ur >= HALF) && (vr >= HALF) && (ur < wf - HALF) && (vr < hf - HALF) &&
                         (rel_u >= 0.0f) && (rel_u + (PATCH - 1) <= wlim) && (rel_v >= 0.0f) &&
                         (rel_v + (PATCH - 1) <= wlim);
        active = active && inb && isfinite(u) && isfinite(v);

        float res[2];
#pragma unroll
        for (int q = 0; q < 2; ++q)
            res[q] = hso::sample_window(w, win, rel_u + px_x[q], rel_v + px_y[q]) - val[q] + mean;
        const float new_chi2 = warp_sum(res[0] * res[0] * wgt[0] + res[1] * res[1] * wgt[1]);
        const float g0 = -warp_sum(res[0] * wgt2[0] * dx[0] + res[1] * wgt2[1] * dx[1]);
        const float g1 = -warp_sum(res[0] * wgt2[0] * dy[0] + res[1] * wgt2[1] * dy[1]);
        const float g2 = -warp_sum(res[0] * wgt2[0] + res[1] * wgt2[1]);
        const float e0 = -warp_sum(res[0] * wgt1[0] * jd[0] + res[1] * wgt1[1] * jd[1]);
        const float e1 = -warp_sum(res[0] * wgt1[0] + res[1] * wgt1[1]);
        const float upd3_0 = i3 * (c00 * g0 + c01 * g1 + c02 * g2);
        const float upd3_1 = i3 * (c01 * g0 + c11 * g1 + c12 * g2);
        const float upd3_2 = i3 * (c02 * g0 + c12 * g1 + c22 * g2);
        const float upd2_0 = i2 * (c2 * e0 - b2 * e1);
        const float upd2_1 = i2 * (-b2 * e0 + a2 * e1);

        const float du = edge ? upd2_0 * d_u : upd3_0;
        const float dv = edge ? upd2_0 * d_v : upd3_1;
        const float dm = edge ? upd2_1 : upd3_2;
        if (active) {
            u += du;
            v += dv;
            mean += dm;
            chi2 = new_chi2;
        }
        const bool small = edge ? (upd2_0 * upd2_0 < 0.01f * 0.01f)
                                : (upd3_0 * upd3_0 + upd3_1 * upd3_1 < 0.03f * 0.03f);
        conv = conv || (active && small);
        active = active && !small;
    }
    conv = conv && (chi2 <= 1000.0f * PATCH * PATCH) && valid_;

    // final patch -> NCC against the template interior
    const float rel_u = (u - HALF) - au_;
    const float rel_v = (v - HALF) - av_;
    float pa[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
        pa[q] = hso::sample_window(w, win, rel_u + px_x[q], rel_v + px_y[q]);
    const float pm = warp_sum(pa[0] + pa[1]) * (1.0f / 64.0f);
    const float vm = warp_sum(val[0] + val[1]) * (1.0f / 64.0f);
    const float a0 = pa[0] - pm, a1 = pa[1] - pm, b0 = val[0] - vm, b1 = val[1] - vm;
    const float num = warp_sum(a0 * b0 + a1 * b1);
    const float saa = warp_sum(a0 * a0 + a1 * a1);
    const float sbb = warp_sum(b0 * b0 + b1 * b1);
    const float score = num / (sqrtf(saa * sbb) + 1e-12f);

    if (lane == 0) {
        // central-difference gradient at the result (window coords u - anchor)
        const float ru = u - au_, rv = v - av_;
        const float gx = 0.5f * (hso::sample_window(w, win, ru + 1.0f, rv) -
                                 hso::sample_window(w, win, ru - 1.0f, rv));
        const float gy = 0.5f * (hso::sample_window(w, win, ru, rv + 1.0f) -
                                 hso::sample_window(w, win, ru, rv - 1.0f));
        out[0 * S + s] = u;
        out[1 * S + s] = v;
        out[2 * S + s] = conv ? 1.0f : 0.0f;
        out[3 * S + s] = score;
        out[4 * S + s] = gx;
        out[5 * S + s] = gy;
        out[6 * S + s] = chi2;
        out[7 * S + s] = mean;
    }
}

}  // namespace

extern "C" int hso_align_match(const unsigned char* is_edge, const float* direction,
                               const float* ref_border, const float* px_init,
                               const unsigned char* valid, const float* windows, const int* au,
                               const int* av, const int* hs, const int* ws, int S, int win,
                               int n_iter, float* out, cudaStream_t stream) {
    const size_t bytes = (size_t)WARPS * (win * win + BORD * BORD) * sizeof(float);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(align_match_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (S + WARPS - 1) / WARPS;
    align_match_kernel<<<blocks, WARPS * 32, bytes, stream>>>(
        is_edge, direction, ref_border, px_init, valid, windows, au, av, hs, ws, S, win, n_iter,
        out);
    return (int)cudaGetLastError();
}
