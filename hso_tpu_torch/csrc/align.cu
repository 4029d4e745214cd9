// K4: fused feature alignment (2-D corner / 1-D edgelet inverse-compositional
// LM), final NCC against the template and central-difference gradient at the
// result.
//
// Replaces the Pallas kernel align_match_tpu (ops/align_pallas.py of the JAX
// package).  That kernel puts candidates on the lane axis, transposes windows
// and templates to (..., S), samples each 8x8 patch by a separable
// accumulation over the whole window and runs both solvers and all iterations
// for every candidate, because its lanes cannot diverge.  Here a candidate is
// one warp, and a warp's life is as long as its candidate needs:
//
//  * The warp branches ONCE on the candidate's kind: the corner and the
//    edgelet instance each hold only their own weights, Hessian and sums.
//  * Every load is started before anything depends on one: the candidate's
//    scalars, the template taps (read from device memory, each lane five for
//    each of its two pixels) and, for a live candidate, the cp.async copy of
//    its window to shared memory (16-byte chunks) share one trip to memory.
//    The copy is awaited only after the template's gradients, weights,
//    Hessian and its inverse are done.
//  * Each lane owns two of the 64 patch pixels and samples them with four
//    taps.  The sums of an iteration (chi2 and the gradient: 4 values, 3 for
//    an edgelet) go through ONE transposed warp sum (hso::warp_transpose_sum:
//    6 dependent shuffles, then one broadcast shuffle per value) in place of
//    a butterfly of 5 shuffles for each.  Fixed order, all lanes get the same
//    value: two runs are bitwise equal.
//  * The loop is left as soon as `active` is false.  `active` is uniform over
//    the warp and only ever falls, and a candidate that converged or left its
//    window keeps the state it had, so leaving is exact; a candidate with
//    valid = 0 never enters the loop, copies no window, and reads the taps of
//    its final patch and gradient (at px_init) straight from device memory.
//
// Bound: latency of one warp's chain (window copy, set-up, iterations, final
// sums); the bytes are one read of the live windows and of the templates and
// 8*S floats out.  `win` is a run-time parameter (24 for the matcher, 40 for
// the depth filter); warps per block and shared memory follow from it
// (align_launch_plan in ops/align_cuda.py, plan_of below): 4 warps of win*win
// floats, so that at win 40 an SM's shared memory holds 32 warps.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int PATCH = 8;
constexpr int HALF = 4;
constexpr int BORD = 10;
constexpr int WARPS = 4;
constexpr size_t SMEM_MAX = 232448;
constexpr unsigned FULL = 0xffffffffu;

struct Plan {
    int warps, win_floats;
    size_t smem;
    bool fits;
};

__host__ __device__ inline int win_floats_of(int win) { return (win * win + 3) / 4 * 4; }

Plan plan_of(int S, int win) {
    Plan p;
    p.win_floats = win_floats_of(win);
    p.warps = WARPS;
    if (p.warps > S) p.warps = S < 1 ? 1 : S;
    while (p.warps > 1 && (size_t)p.warps * p.win_floats * sizeof(float) > SMEM_MAX) --p.warps;
    p.smem = (size_t)p.warps * p.win_floats * sizeof(float);
    p.fits = p.smem <= SMEM_MAX;
    return p;
}

struct Args {
    const unsigned char* is_edge;
    const float* direction;
    const float* ref_border;
    const float* px_init;
    const unsigned char* valid;
    const float* windows;
    const int* au;
    const int* av;
    const int* hs;
    const int* ws;
    int S, win, n_iter;
    float* out;
};

// What a warp reads of its candidate before anything depends on it: every
// load is started at the top of the kernel, so that the scalars, the template
// taps and (for a live candidate) the window copy share one trip to memory.
struct Candidate {
    bool valid;
    float d_u, d_v, au, av, hf, wf, u, v;
    float val[2], tl[2], tr[2], tu[2], td[2];      // template: centre, left, right, up, down
};

// One candidate on one warp.  EDGE: the 2-DoF edgelet [step along the normal,
// mean]; otherwise the 3-DoF corner [u, v, mean].  `w` is the candidate's
// window: in shared memory (the copy possibly still in flight) for a live
// candidate, in device memory for a dead one.
template <bool EDGE>
__device__ __forceinline__ void align_candidate(const Args& A, const Candidate& C, int s, int lane,
                                                const float* w) {
    using hso::sample_window;
    const int win = A.win;
    const bool valid_ = C.valid;
    const float au_ = C.au, av_ = C.av, hf = C.hf, wf = C.wf;
    float u = C.u, v = C.v;
    float mean = 0.f, chi2 = 0.f;
    bool conv = false;
    const float val[2] = {C.val[0], C.val[1]};
    const int px_x[2] = {lane & 7, lane & 7}, px_y[2] = {lane >> 3, (lane >> 3) + 4};

    if (valid_) {
        // gradients, weights and the inverse Hessian of this kind
        float dx[2], dy[2], jd[2], wgt[2];
        float d_u = C.d_u, d_v = C.d_v;
        if (EDGE) {
            const float dn = fmaxf(sqrtf(d_u * d_u + d_v * d_v), 1e-9f);
            d_u /= dn;
            d_v /= dn;
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            dx[q] = 0.5f * (C.tr[q] - C.tl[q]);
            dy[q] = 0.5f * (C.td[q] - C.tu[q]);
            if (EDGE) {
                jd[q] = dx[q] * d_u + dy[q] * d_v;
                wgt[q] = sqrtf(250.0f / (250.0f + jd[q] * jd[q]));
            } else {
                jd[q] = 0.f;
                wgt[q] = sqrtf(250.0f / (250.0f + dx[q] * dx[q] + dy[q] * dy[q]));
            }
        }
        // corner: adjugate of the 3x3 [dx, dy, 1] Hessian; edgelet: the 2x2 of
        // [jd, 1]; both with a 1.001 diagonal
        float c00 = 0.f, c01 = 0.f, c02 = 0.f, c11 = 0.f, c12 = 0.f, c22 = 0.f, inv_det;
        float a2 = 0.f, b2 = 0.f, c2 = 0.f;
        if (EDGE) {
            const float h[4] = {wgt[0] * jd[0] * jd[0] + wgt[1] * jd[1] * jd[1],
                                wgt[0] * jd[0] + wgt[1] * jd[1], wgt[0] + wgt[1], 0.f};
            const float r = hso::warp_transpose_sum<4>(h);       // lane l: entry l / 8
            a2 = __shfl_sync(FULL, r, 0) * 1.001f;
            b2 = __shfl_sync(FULL, r, 8);
            c2 = __shfl_sync(FULL, r, 16) * 1.001f;
            float det2 = a2 * c2 - b2 * b2;
            if (fabsf(det2) < 1e-12f) det2 = 1e-12f;
            inv_det = 1.0f / det2;
        } else {
            const float h[8] = {wgt[0] * dx[0] * dx[0] + wgt[1] * dx[1] * dx[1],
                                wgt[0] * dx[0] * dy[0] + wgt[1] * dx[1] * dy[1],
                                wgt[0] * dx[0] + wgt[1] * dx[1],
                                wgt[0] * dy[0] * dy[0] + wgt[1] * dy[1] * dy[1],
                                wgt[0] * dy[0] + wgt[1] * dy[1], wgt[0] + wgt[1], 0.f, 0.f};
            const float r = hso::warp_transpose_sum<8>(h);       // lane l: entry l / 4
            const float h00 = __shfl_sync(FULL, r, 0) * 1.001f;
            const float h01 = __shfl_sync(FULL, r, 4);
            const float h02 = __shfl_sync(FULL, r, 8);
            const float h11 = __shfl_sync(FULL, r, 12) * 1.001f;
            const float h12 = __shfl_sync(FULL, r, 16);
            const float h22 = __shfl_sync(FULL, r, 20) * 1.001f;
            c00 = h11 * h22 - h12 * h12;
            c01 = h02 * h12 - h01 * h22;
            c02 = h01 * h12 - h02 * h11;
            c11 = h00 * h22 - h02 * h02;
            c12 = h01 * h02 - h00 * h12;
            c22 = h00 * h11 - h01 * h01;
            float det3 = h00 * c00 + h01 * c01 + h02 * c02;
            if (fabsf(det3) < 1e-12f) det3 = 1e-12f;
            inv_det = 1.0f / det3;
        }

        __pipeline_wait_prior(0);           // this lane's chunks of the window have landed
        __syncwarp();                       // the window is whole

        const float wlim = (float)(win - 1);
        for (int it = 0; it < A.n_iter; ++it) {
            const float rel_u = (u - HALF) - au_;
            const float rel_v = (v - HALF) - av_;
            const float ur = floorf(u), vr = floorf(v);
            const bool inb = (ur >= HALF) && (vr >= HALF) && (ur < wf - HALF) &&
                             (vr < hf - HALF) && (rel_u >= 0.0f) &&
                             (rel_u + (PATCH - 1) <= wlim) && (rel_v >= 0.0f) &&
                             (rel_v + (PATCH - 1) <= wlim);
            // left the image or its window: the state stays as it is
            if (!(inb && isfinite(u) && isfinite(v))) break;

            // the whole patch lies inside the window and all its pixels share one
            // sub-pixel offset: one set of bilinear weights, taps without a bounds
            // test (but for the column and row just past a patch that ends on the
            // window's last one, whose weight is 0)
            const float x0f = floorf(rel_u), y0f = floorf(rel_v);
            const float fx = rel_u - x0f, fy = rel_v - y0f;
            const float w00 = (1.0f - fx) * (1.0f - fy), w10 = fx * (1.0f - fy);
            const float w01 = (1.0f - fx) * fy, w11 = fx * fy;
            float res[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int xi = (int)x0f + px_x[q], yi = (int)y0f + px_y[q];
                const float* p = w + yi * win + xi;
                const bool xb = xi + 1 < win, yb = yi + 1 < win;
                const float v00 = p[0], v10 = xb ? p[1] : 0.f;
                const float v01 = yb ? p[win] : 0.f, v11 = (xb && yb) ? p[win + 1] : 0.f;
                res[q] = (v00 * w00 + v10 * w10 + v01 * w01 + v11 * w11) - val[q] + mean;
            }
            const float rw0 = res[0] * wgt[0], rw1 = res[1] * wgt[1];
            float du, dv, dm;
            bool small;
            if (EDGE) {
                const float sums[4] = {res[0] * rw0 + res[1] * rw1, rw0 * jd[0] + rw1 * jd[1],
                                       rw0 + rw1, 0.f};
                const float r = hso::warp_transpose_sum<4>(sums);
                chi2 = __shfl_sync(FULL, r, 0);
                const float e0 = -__shfl_sync(FULL, r, 8);
                const float e1 = -__shfl_sync(FULL, r, 16);
                const float step = inv_det * (c2 * e0 - b2 * e1);
                dm = inv_det * (-b2 * e0 + a2 * e1);
                du = step * d_u;
                dv = step * d_v;
                small = step * step < 0.01f * 0.01f;
            } else {
                const float sums[4] = {res[0] * rw0 + res[1] * rw1, rw0 * dx[0] + rw1 * dx[1],
                                       rw0 * dy[0] + rw1 * dy[1], rw0 + rw1};
                const float r = hso::warp_transpose_sum<4>(sums);
                chi2 = __shfl_sync(FULL, r, 0);
                const float g0 = -__shfl_sync(FULL, r, 8);
                const float g1 = -__shfl_sync(FULL, r, 16);
                const float g2 = -__shfl_sync(FULL, r, 24);
                du = inv_det * (c00 * g0 + c01 * g1 + c02 * g2);
                dv = inv_det * (c01 * g0 + c11 * g1 + c12 * g2);
                dm = inv_det * (c02 * g0 + c12 * g1 + c22 * g2);
                small = du * du + dv * dv < 0.03f * 0.03f;
            }
            u += du;
            v += dv;
            mean += dm;
            if (small) {                    // converged: nothing moves from here on
                conv = true;
                break;
            }
        }
        conv = conv && (chi2 <= 1000.0f * PATCH * PATCH);
    }

    // final patch -> NCC against the template interior
    const float rel_u = (u - HALF) - au_;
    const float rel_v = (v - HALF) - av_;
    float pa[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) pa[q] = sample_window(w, win, rel_u + px_x[q], rel_v + px_y[q]);
    // central-difference gradient at the result (window coords u - anchor):
    // lanes 0..3 read one tap each, along with the patch
    const float ru = u - au_, rv = v - av_;
    const float tap_u = ru + (lane == 0 ? 1.0f : lane == 1 ? -1.0f : 0.0f);
    const float tap_v = rv + (lane == 2 ? 1.0f : lane == 3 ? -1.0f : 0.0f);
    const float tap = lane < 4 ? sample_window(w, win, tap_u, tap_v) : 0.f;
    const float m2[2] = {pa[0] + pa[1], val[0] + val[1]};
    const float rm = hso::warp_transpose_sum<2>(m2);             // lane l: entry l / 16
    const float pm = __shfl_sync(FULL, rm, 0) * (1.0f / 64.0f);
    const float vm = __shfl_sync(FULL, rm, 16) * (1.0f / 64.0f);
    const float a0 = pa[0] - pm, a1 = pa[1] - pm, b0 = val[0] - vm, b1 = val[1] - vm;
    const float n4[4] = {a0 * b0 + a1 * b1, a0 * a0 + a1 * a1, b0 * b0 + b1 * b1, 0.f};
    const float rn = hso::warp_transpose_sum<4>(n4);
    const float num = __shfl_sync(FULL, rn, 0);
    const float saa = __shfl_sync(FULL, rn, 8);
    const float sbb = __shfl_sync(FULL, rn, 16);
    const float score = num / (sqrtf(saa * sbb) + 1e-12f);

    const float gx = 0.5f * (__shfl_sync(FULL, tap, 0) - __shfl_sync(FULL, tap, 1));
    const float gy = 0.5f * (__shfl_sync(FULL, tap, 2) - __shfl_sync(FULL, tap, 3));
    if (lane == 0) {
        const int S = A.S;
        float* out = A.out;
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

__global__ void __launch_bounds__(WARPS * 32) align_match_kernel(Args A) {
    extern __shared__ __align__(16) float sm[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int s = blockIdx.x * (blockDim.x >> 5) + warp;
    if (s >= A.S) return;                  // whole warp leaves; no block barrier below
    float* w_sm = sm + (size_t)warp * win_floats_of(A.win);
    const int nw = A.win * A.win;
    const float* g_win = A.windows + (size_t)s * nw;
    const float* t = A.ref_border + (size_t)s * BORD * BORD;

    const bool edge = A.is_edge[s] != 0;
    Candidate C;
    C.valid = A.valid[s] != 0;
    C.d_u = A.direction[2 * s];
    C.d_v = A.direction[2 * s + 1];
    C.au = (float)A.au[s];
    C.av = (float)A.av[s];
    C.hf = (float)A.hs[s];
    C.wf = (float)A.ws[s];
    C.u = A.px_init[2 * s];
    C.v = A.px_init[2 * s + 1];
#pragma unroll
    for (int q = 0; q < 2; ++q) {          // this lane's pixels: lane and lane + 32
        const float* c = t + ((lane >> 3) + 4 * q + 1) * BORD + (lane & 7) + 1;
        C.val[q] = c[0];
        C.tl[q] = c[-1];
        C.tr[q] = c[1];
        C.tu[q] = c[-BORD];
        C.td[q] = c[BORD];
    }

    // the window: copied to shared memory for a live candidate (asynchronously
    // where it is 16-byte aligned); a dead one reads its few taps from device
    // memory
    const float* w = g_win;
    if (C.valid) {
        w = w_sm;
        if ((nw % 4 == 0) && ((reinterpret_cast<size_t>(g_win) & 15u) == 0)) {
            const float4* src = reinterpret_cast<const float4*>(g_win);
            float4* dst = reinterpret_cast<float4*>(w_sm);
            for (int i = lane; i < nw / 4; i += 32)
                __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
            __pipeline_commit();
        } else {
            for (int i = lane; i < nw; i += 32) w_sm[i] = g_win[i];
        }
    }
    if (edge) {
        align_candidate<true>(A, C, s, lane, w);
    } else {
        align_candidate<false>(A, C, s, lane, w);
    }
}

}  // namespace

// The launch plan of (S, win): out3 = {warps per block, threads, shared memory
// bytes}.  Returns 0, or 1 when one window does not fit shared memory.
extern "C" int hso_align_launch_plan(int S, int win, int* out3) {
    const Plan pl = plan_of(S, win);
    out3[0] = pl.warps;
    out3[1] = pl.warps * 32;
    out3[2] = (int)pl.smem;
    return pl.fits ? 0 : 1;
}

extern "C" int hso_align_match(const unsigned char* is_edge, const float* direction,
                               const float* ref_border, const float* px_init,
                               const unsigned char* valid, const float* windows, const int* au,
                               const int* av, const int* hs, const int* ws, int S, int win,
                               int n_iter, float* out, cudaStream_t stream) {
    const Plan pl = plan_of(S, win);
    if (!pl.fits) return (int)cudaErrorInvalidValue;
    static hso::SmemOptIn opted;
    const cudaError_t e = hso::allow_dynamic_smem(align_match_kernel, pl.smem, opted);
    if (e != cudaSuccess) return (int)e;
    const Args A = {is_edge, direction, ref_border, px_init, valid, windows, au, av, hs, ws,
                    S, win, n_iter, out};
    const int blocks = (S + pl.warps - 1) / pl.warps;
    align_match_kernel<<<blocks, pl.warps * 32, pl.smem, stream>>>(A);
    return (int)cudaGetLastError();
}
