// K6: zero-mean NCC of each seed's 8x8 template against its search window,
// sampled along the seed's epipolar segment; best score, second-best score at
// step distance > 1, and the first step that reaches the best.
//
// Replaces the Pallas kernel zmncc_line_scores_tpu (ops/epipolar_pallas.py of
// the JAX package).  That kernel puts 128 seeds on the lane axis, computes the
// dense (EW-7)^2 score map of every seed and samples it by a dense weighted
// sum, because the TPU has no gather.  A GPU has one, and the line reads at
// most 4 map entries per step, so this kernel computes only those:
//
//  * A seed is a group of GROUP threads (64: two warps); a block holds two
//    groups (the launch plan, zmncc_launch_plan in ops/epipolar_cuda.py and
//    plan_of below, sizes shared memory from EW and the step count).  Groups
//    never meet at a block barrier: each has its own named barrier, so a
//    group that is done leaves.
//  * The window of a seed (EW*EW floats, contiguous, 16-byte aligned) is
//    sent for by cp.async at the top of the kernel and arrives while the
//    steps are tested and the template's mean and energy are reduced.
//  * Leave early, exactly: every warp runs the window/image-bounds test of
//    all steps on the scalars.  A seed with no step inside gets
//    (-inf, -inf, 0), which is what the dense form gives it whatever its
//    window holds (a masked step is -inf even where the map is NaN); its
//    copy is awaited and nothing of it is read.  Dead and invisible slots are
//    such seeds.
//  * Work items are (step, map row): a thread computes the two adjacent map
//    entries its step's taps read in that row from one pass over 8 window rows
//    of 9 values (register tiling: each loaded value feeds both entries, their
//    row sums and the squares), the template in 64 registers.
//  * Warp 0 of the group then weights the four entries of every step and
//    reduces best / first-hit step / far second-best with shuffles in a fixed
//    order.  No atomics: two runs are bitwise equal.
//
// Poison rule.  The dense form multiplies every map entry by its weight, so
// one non-finite entry ANYWHERE in a seed's map turns all its unmasked scores
// into NaN.  Computing only the entries on the line keeps that rule exact by
// a guard: while the window arrives the group checks that every window and
// template value is finite and below 1e12 in magnitude.  Under the guard no
// map entry can be non-finite: |corr| <= 64e24 and |mean * sum| <= 64e24, so
// the numerator is finite and below 1.3e26; the denominator is at least 1e-12,
// so the quotient stays below 1.3e38 < FLT_MAX; where ref_den * var overflows,
// the root is +inf and the entry is 0; nothing is 0/0 or inf/inf.  A seed that
// fails the guard scans its whole map (strips of 4 entries per thread, same
// tiling) for a non-finite entry before its line is sampled.
//
// Rounding: var_t = sum(t^2) - sum(t)^2/64 and num = corr - mean*sum(t) cancel
// in low-texture windows and are then divided, so every sum that feeds them is
// taken in the order of the plain PyTorch version (zmncc_line_scores_plain)
// with explicitly rounded multiplies and adds (__fmul_rn/__fadd_rn keep nvcc
// from contracting them into FMAs): row sums left to right then top to bottom,
// the 64 products row-major, the template sums as a halving tree.  Each map
// entry therefore has the same bits whichever path computes it.
//
// Bound: operations on the entries computed (about 320 per entry) for live
// seeds, one read of EW*EW + 64 floats per live seed; three numbers per seed
// go back to device memory.
#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int PATCH = 8;
constexpr int GROUP = 64;             // threads per seed
constexpr int SEEDS_PER_BLOCK = 2;
constexpr int THREADS = GROUP * SEEDS_PER_BLOCK;
constexpr int MIN_BLOCKS = 4;         // per SM: caps a thread at 128 registers
constexpr size_t SMEM_MAX = 232448;
constexpr float GUARD = 1e12f;
constexpr unsigned FULL = 0xffffffffu;

struct Plan {
    int seeds, seed_floats;
    size_t smem;
    bool fits;
};

// Floats of one seed in shared memory: window, 4 map entries and 1 score per
// step, 8 flag words; rounded to 16 bytes so that every window is aligned.
__host__ __device__ inline int seed_floats_of(int ew, int n_steps) {
    return (ew * ew + 5 * n_steps + 8 + 3) / 4 * 4;
}

Plan plan_of(int S, int ew, int n_steps) {
    Plan p;
    p.seed_floats = seed_floats_of(ew, n_steps);
    p.seeds = SEEDS_PER_BLOCK;
    if (p.seeds > S) p.seeds = S < 1 ? 1 : S;
    while (p.seeds > 1 && (size_t)p.seeds * p.seed_floats * sizeof(float) > SMEM_MAX) --p.seeds;
    p.smem = (size_t)p.seeds * p.seed_floats * sizeof(float);
    p.fits = p.smem <= SMEM_MAX;
    return p;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
    return x;
}

__device__ __forceinline__ int warp_min_int(int x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(FULL, x, off));
    return x;
}

// Barrier among the GROUP threads of seed group g (named barrier 1 + g).
__device__ __forceinline__ void group_sync(int g) {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(GROUP) : "memory");
}

// The seed's segment: step k sits at (su, sv) in score-map coordinates and
// counts if it lies on the segment, in the map, and its patch in the image.
struct Line {
    float u0, v0, du, dv, nl, au, av, hf, wf, lim;
    __device__ __forceinline__ bool at(int k, float& su, float& sv) const {
        const float kf = (float)k;
        su = __fadd_rn(u0, __fmul_rn(du, kf));
        sv = __fadd_rn(v0, __fmul_rn(dv, kf));
        const float pu = __fadd_rn(__fadd_rn(su, 4.0f), au);
        const float pv = __fadd_rn(__fadd_rn(sv, 4.0f), av);
        return (kf <= nl) && (su >= 0.0f) && (su <= lim) && (sv >= 0.0f) && (sv <= lim) &&
               (pu - 4.0f >= 0.0f) && (pu + 4.0f <= wf - 1.0f) && (pv - 4.0f >= 0.0f) &&
               (pv + 4.0f <= hf - 1.0f);
    }
};

// R adjacent score-map entries (x .. x+R-1, y) of one seed.  One pass over the
// 8 window rows: R + 7 values are loaded per row and feed all R entries, their
// row sums and (squared once) the sums of squares.  Every sum is taken in the
// order of the plain version, so an entry has the same bits for every R.
template <int R>
__device__ __forceinline__ void score_strip(const float* __restrict__ w, int ew,
                                            const float (&t)[PATCH * PATCH], int x, int y,
                                            float ref_mean, float ref_den, float (&z)[R]) {
    float st[R], st2[R], corr[R];
#pragma unroll
    for (int a = 0; a < PATCH; ++a) {
        const float* row = w + (y + a) * ew + x;
        float v[R + PATCH - 1], q[R + PATCH - 1];
#pragma unroll
        for (int i = 0; i < R + PATCH - 1; ++i) {
            v[i] = row[i];
            q[i] = __fmul_rn(v[i], v[i]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float a1 = v[r], a2 = q[r];
#pragma unroll
            for (int b = 1; b < PATCH; ++b) {
                a1 = __fadd_rn(a1, v[r + b]);
                a2 = __fadd_rn(a2, q[r + b]);
            }
            st[r] = a == 0 ? a1 : __fadd_rn(st[r], a1);
            st2[r] = a == 0 ? a2 : __fadd_rn(st2[r], a2);
#pragma unroll
            for (int b = 0; b < PATCH; ++b) {
                const float p = __fmul_rn(v[r + b], t[a * PATCH + b]);
                corr[r] = (a == 0 && b == 0) ? p : __fadd_rn(corr[r], p);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const float num = __fsub_rn(corr[r], __fmul_rn(ref_mean, st[r]));
        float var_t = __fsub_rn(st2[r], __fmul_rn(__fmul_rn(st[r], st[r]), 1.0f / 64.0f));
        if (!(var_t != var_t)) var_t = fmaxf(var_t, 0.0f);      // a NaN stays a NaN
        z[r] = num / (sqrtf(__fmul_rn(ref_den, var_t)) + 1e-12f);
    }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
zmncc_line_kernel(const float* __restrict__ windows, const float* __restrict__ ref_patch,
                  const float* __restrict__ su0, const float* __restrict__ sv0,
                  const float* __restrict__ dir_u, const float* __restrict__ dir_v,
                  const int* __restrict__ n_line, const int* __restrict__ au,
                  const int* __restrict__ av, const int* __restrict__ hs,
                  const int* __restrict__ ws, int S, int ew, int n_steps, int seeds,
                  float* __restrict__ best_out, float* __restrict__ second_out,
                  int* __restrict__ k_out) {
    extern __shared__ __align__(16) float sm[];
    const int tid = threadIdx.x, lane = tid & 31;
    const int g = tid / GROUP, gt = tid - g * GROUP, gw = gt >> 5;      // group, thread and warp in it
    const int s = blockIdx.x * seeds + g;
    if (s >= S) return;                     // the whole group leaves
    const int ow = ew - PATCH + 1;
    const int nw = ew * ew;
    const float NEG = -INFINITY;

    Line ln;
    ln.u0 = su0[s];
    ln.v0 = sv0[s];
    ln.du = dir_u[s];
    ln.dv = dir_v[s];
    ln.nl = (float)n_line[s];
    ln.au = (float)au[s];
    ln.av = (float)av[s];
    ln.hf = (float)hs[s];
    ln.wf = (float)ws[s];
    ln.lim = (float)(ow - 1);

    float* w = sm + (size_t)g * seed_floats_of(ew, n_steps);   // ew * ew
    float* zt = w + nw;                     // 4 map entries per step
    float* sc = zt + 4 * n_steps;           // n_steps line scores
    int* flg = reinterpret_cast<int*>(sc + n_steps);            // 8 flag words

    // ---- the window, asynchronously; the step test and the template meanwhile ----
    const float* g_win = windows + (size_t)s * nw;
    const float* g_ref = ref_patch + (size_t)s * PATCH * PATCH;
    const bool vec = (nw % 4 == 0) && ((reinterpret_cast<size_t>(g_win) & 15u) == 0);
    bool ok = true;                         // the guard: finite and below GUARD
    if (vec) {
        const float4* src = reinterpret_cast<const float4*>(g_win);
        float4* dst = reinterpret_cast<float4*>(w);
        for (int i = gt; i < nw / 4; i += GROUP) __pipeline_memcpy_async(dst + i, src + i, sizeof(float4));
        __pipeline_commit();
    } else {
        for (int i = gt; i < nw; i += GROUP) {
            const float x = g_win[i];
            w[i] = x;
            ok = ok && (fabsf(x) < GUARD);
        }
    }
    // ---- leave early: no step inside -> (-inf, -inf, 0), the window unread ----
    bool any = false;
    for (int k0 = 0; k0 < n_steps; k0 += 32) {
        float su, sv;
        const int k = k0 + lane;
        any = __any_sync(FULL, k < n_steps && ln.at(k, su, sv)) || any;
    }
    if (!any) {
        if (vec) __pipeline_wait_prior(0);  // no copy is left in flight behind a thread
        if (gt == 0) {
            best_out[s] = NEG;
            second_out[s] = NEG;
            k_out[s] = 0;
        }
        return;
    }

    // template mean and zero-mean energy: lane l holds entries l and l+32, then
    // a butterfly (the halving tree of the plain version); every warp does it
    const float ta = g_ref[lane], tb = g_ref[lane + 32];
    ok = ok && (fabsf(ta) < GUARD) && (fabsf(tb) < GUARD);
    const float ref_mean = hso::warp_sum(__fadd_rn(ta, tb)) * (1.0f / 64.0f);
    const float da = __fsub_rn(ta, ref_mean), db = __fsub_rn(tb, ref_mean);
    const float ref_den = hso::warp_sum(__fadd_rn(__fmul_rn(da, da), __fmul_rn(db, db)));
    float t[PATCH * PATCH];
    if ((reinterpret_cast<size_t>(g_ref) & 15u) == 0) {
#pragma unroll
        for (int i = 0; i < PATCH * PATCH / 4; ++i) {
            const float4 x = reinterpret_cast<const float4*>(g_ref)[i];
            t[4 * i] = x.x;
            t[4 * i + 1] = x.y;
            t[4 * i + 2] = x.z;
            t[4 * i + 3] = x.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < PATCH * PATCH; ++i) t[i] = g_ref[i];
    }
    if (vec) {
        __pipeline_wait_prior(0);           // this thread's chunks have landed
        const float4* dst = reinterpret_cast<const float4*>(w);
        for (int i = gt; i < nw / 4; i += GROUP) {
            const float4 x = dst[i];
            ok = ok && (fabsf(x.x) < GUARD) && (fabsf(x.y) < GUARD) && (fabsf(x.z) < GUARD) &&
                 (fabsf(x.w) < GUARD);
        }
    }
    ok = __all_sync(FULL, ok);
    if (lane == 0) flg[gw] = ok;
    group_sync(g);                          // the window is whole; the flags are written
#pragma unroll
    for (int i = 0; i < GROUP / 32; ++i) ok = ok && flg[i];

    // ---- a seed that fails the guard: is any entry of its map non-finite? ----
    bool poisoned = false;
    if (!ok) {
        const int strips = (ow + 3) / 4;
        bool bad = false;
        for (int i = gt; i < ow * strips; i += GROUP) {
            const int y = i / strips;
            int x = (i - y * strips) * 4;
            if (x + 4 <= ow) {
                float z[4];
                score_strip<4>(w, ew, t, x, y, ref_mean, ref_den, z);
                bad = bad || !isfinite(z[0]) || !isfinite(z[1]) || !isfinite(z[2]) ||
                      !isfinite(z[3]);
            } else {
                for (; x < ow; ++x) {
                    float z[1];
                    score_strip<1>(w, ew, t, x, y, ref_mean, ref_den, z);
                    bad = bad || !isfinite(z[0]);
                }
            }
        }
        poisoned = __any_sync(FULL, bad);
        if (lane == 0) flg[4 + gw] = poisoned;
        group_sync(g);
#pragma unroll
        for (int i = 0; i < GROUP / 32; ++i) poisoned = poisoned || flg[4 + i];
    }

    // ---- the map entries the line reads: item = (step, row of its taps) ----
    if (!poisoned) {
        for (int i = gt; i < 2 * n_steps; i += GROUP) {
            const int k = i >> 1, row = i & 1;
            float su, sv;
            if (!ln.at(k, su, sv)) continue;
            const int x0 = (int)floorf(su), y0 = (int)floorf(sv);
            if (row == 1) {                 // the lower taps count only with weight > 0
                const float wy1 = fmaxf(0.0f, 1.0f - fabsf(sv - (float)(y0 + 1)));
                if (!((wy1 > 0.0f) && (y0 + 1 < ow))) continue;
            }
            if (x0 + 1 < ow) {
                float z[2];
                score_strip<2>(w, ew, t, x0, y0 + row, ref_mean, ref_den, z);
                zt[4 * k + 2 * row] = z[0];
                zt[4 * k + 2 * row + 1] = z[1];
            } else {
                float z[1];
                score_strip<1>(w, ew, t, x0, y0 + row, ref_mean, ref_den, z);
                zt[4 * k + 2 * row] = z[0];
            }
        }
    }
    group_sync(g);
    if (gw != 0) return;

    // ---- line pass, warp 0 of the group ----
    float l_best = NEG;
    int l_nan = n_steps;                    // first NaN step seen by this lane
    for (int k = lane; k < n_steps; k += 32) {
        float su, sv;
        const bool inside = ln.at(k, su, sv);
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
                const float* e = zt + 4 * k;            // [y0][x0], [y0][x0+1], [y0+1][x0], ..
                float r0 = wy0 * e[0];
                if (y1ok) r0 += wy1 * e[2];
                val = wx0 * r0;
                if (x1ok) {
                    float r1 = wy0 * e[1];
                    if (y1ok) r1 += wy1 * e[3];
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

// The launch plan of (S, EW, n_steps): out3 = {seeds per block, threads, shared
// memory bytes}.  Returns 0, or 1 when one seed does not fit shared memory.
extern "C" int hso_zmncc_launch_plan(int S, int ew, int n_steps, int* out3) {
    const Plan pl = plan_of(S, ew, n_steps);
    out3[0] = pl.seeds;
    out3[1] = GROUP * pl.seeds;
    out3[2] = (int)pl.smem;
    return pl.fits ? 0 : 1;
}

extern "C" int hso_zmncc_line_scores(const float* windows, const float* ref_patch,
                                     const float* su0, const float* sv0, const float* dir_u,
                                     const float* dir_v, const int* n_line, const int* au,
                                     const int* av, const int* hs, const int* ws, int S, int ew,
                                     int n_steps, float* best, float* second, int* k_best,
                                     cudaStream_t stream) {
    const Plan pl = plan_of(S, ew, n_steps);
    if (!pl.fits) return (int)cudaErrorInvalidValue;
    static hso::SmemOptIn opted;
    const cudaError_t e = hso::allow_dynamic_smem(zmncc_line_kernel, pl.smem, opted);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (S + pl.seeds - 1) / pl.seeds;
    zmncc_line_kernel<<<blocks, GROUP * pl.seeds, pl.smem, stream>>>(
        windows, ref_patch, su0, sv0, dir_u, dir_v, n_line, au, av, hs, ws, S, ew, n_steps,
        pl.seeds, best, second, k_best);
    return (int)cudaGetLastError();
}
