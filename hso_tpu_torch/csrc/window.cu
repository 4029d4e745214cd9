// K1 / K2: per-feature window extraction, one window-gather kernel for both.
//
// Replaces the Pallas kernels extract_windows_tpu (K1) and
// pack_level_windows_tpu (K2) of the JAX package's ops/window_pallas.py.
// Those load an aligned block and rotate it in registers because the TPU
// cannot address an arbitrary offset.  Here a window is a copy of win x win
// floats at a signed top-left anchor (au, av) of a row-major image, with
// zeros where it leaves the image; no arithmetic is done on a value, so the
// result is the plain version's to the bit.
//
// Bound: bytes.  336 windows of 24 x 24 floats read and written once are
// 1.5 MB, under half a microsecond of the card's memory rate; 1024 windows of
// 40 x 40 are 13 MB, 3.9 us.  What costs is the launch (about 1.6 us even for
// an empty kernel in a replayed graph) and, in a loop of scalar loads, the
// instructions and the round trips per element.
//
// Design:
//  * One launch serves several sources: up to 8 images (K1: one per job, so
//    the coarse tracker cuts its ref and cur windows of a level in one
//    launch) or up to 8 pyramid levels (K2: each row's source is level[s]; a
//    level outside [0, n_levels) gives zeros).
//  * One warp per window, 8 windows per block at win <= 32 and 4 above, so
//    the sweep's 1024 windows of 40 x 40 are one wave on 132 SMs.
//  * Aligned body, for a source whose base is 16-byte aligned, whose row
//    pitch 4W is a multiple of 16 and whose windows have win % 4 == 0: a row
//    of the window spans win/4 + 1 aligned 16-byte chunks of its image row;
//    each lane loads one chunk per pass (32 / (win/4 + 1) rows a pass), every
//    load of a round before the first store, takes the next chunk from its
//    neighbour lane by shuffles, picks the four floats at the anchor's offset
//    au & 3 (the same for the whole warp) and stores them as one 16-byte
//    store.  A chunk lies wholly inside or wholly outside its image row, so
//    the bounds test is per chunk, not per element, and no byte outside the
//    image is read.
//  * General body, for any other source: every lane issues all loads of a
//    round before its first store (one round at the window edges with an
//    instance of their own, 16 elements a lane a round otherwise), with no
//    division per element and no bounds test when the window lies inside the
//    image.
//  * Which body a source takes is decided before the launch by the pure
//    function window_plan (window_copy_plan in ops/window_cuda.py).
//
// The Tensor Memory Accelerator's tiled copy would do this copy with no
// instruction per element, but on the H100 it was measured on (driver
// 580.159.03) every cp.async.bulk.tensor load faults with an illegal
// instruction (probe.cu, hso_probe_tma; tools/probe_tma.py), so no body uses it.
//
// Every output (out) must be 16-byte aligned, as a fresh allocation is; an
// entry refuses one that is not.
#include <stdint.h>

#include "common.cuh"

struct LevelTable {
    const float* img[8];
    int h[8];
    int w[8];
};

// One job of hso_extract_windows_jobs: n windows of one (h, w) image at the
// anchors au, av, written to out as (n, win, win).
struct WindowJob {
    const float* img;
    int h;
    int w;
    const int* au;
    const int* av;
    int n;
    float* out;
};

namespace {

constexpr int kMaxSources = 8;
constexpr int kMaxAlignedWin = 124;   // a row's chunks must fit one warp: win / 4 + 1 <= 32

struct GatherParams {
    const float* img[kMaxSources];
    int h[kMaxSources];
    int w[kMaxSources];
    const int* au[kMaxSources];       // K1: per job; K2: entry 0 only
    const int* av[kMaxSources];
    float* out[kMaxSources];
    int row_end[kMaxSources];         // K1: the first row past job j
    const int* level;                 // K2: the source of each row
    int n_sources;
    int n_rows;
    int win;
    unsigned aligned_mask;            // bit i: source i takes the aligned body
};

struct Plan {
    bool aligned;
    int windows;      // windows (warps) per block
    int threads;
};

// The launch plan of one source: a pure function of its shape and address.
Plan window_plan(int w, int win, unsigned long long addr) {
    const int windows = win <= 32 ? 8 : 4;
    const bool aligned = addr % 16 == 0 && (4LL * w) % 16 == 0 && win % 4 == 0 && win >= 4 &&
                         win <= kMaxAlignedWin;
    return {aligned, windows, 32 * windows};
}

// A warp copies one window with 16-byte loads and stores (the aligned body).
// WIN > 0: an instance for that edge, one round; WIN == 0: any edge, 8 passes
// a round.
template <int WIN>
__device__ __forceinline__ void copy_window_aligned(const float* __restrict__ img, int H, int W,
                                                    int x0, int y0, int win,
                                                    float* __restrict__ out, int lane) {
    constexpr int P = WIN > 0 ? (WIN + 32 / (WIN / 4 + 1) - 1) / (32 / (WIN / 4 + 1)) : 8;
    const int nq = win / 4 + 1;               // aligned chunks one window row spans
    const int rpp = 32 / nq;                  // window rows a pass
    const int rr = lane / nq, q = lane - (lane / nq) * nq;
    const int s = x0 & 3;                     // the anchor's offset in its chunk
    const int xq = (x0 >> 2) + q;             // this lane's chunk in the image row
    const bool mine = rr < rpp;
    const bool col_in = mine && xq >= 0 && xq < (W >> 2);
    const bool writes = mine && q < nq - 1;
    const float4* __restrict__ src = reinterpret_cast<const float4*>(img);
    float4* __restrict__ dst = reinterpret_cast<float4*>(out);
    const int w4 = W >> 2, out4 = win >> 2;
    for (int r0 = 0; r0 < win; r0 += P * rpp) {
        float4 v[P];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const int r = r0 + p * rpp + rr;
            const int y = y0 + r;
            const bool ok = col_in && r < win && y >= 0 && y < H;
            v[p] = ok ? __ldg(src + (size_t)y * w4 + xq) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
            float4 n;
            n.x = __shfl_down_sync(0xffffffffu, v[p].x, 1);
            n.y = __shfl_down_sync(0xffffffffu, v[p].y, 1);
            n.z = __shfl_down_sync(0xffffffffu, v[p].z, 1);
            const int r = r0 + p * rpp + rr;
            if (writes && r < win) {
                float4 o = v[p];
                if (s == 1) o = make_float4(v[p].y, v[p].z, v[p].w, n.x);
                if (s == 2) o = make_float4(v[p].z, v[p].w, n.x, n.y);
                if (s == 3) o = make_float4(v[p].w, n.x, n.y, n.z);
                dst[(size_t)r * out4 + q] = o;
            }
        }
    }
}

// A warp copies one window with 4-byte loads (the general body): element
// i = lane + 32 k, E elements a lane a round, all loads of a round before its
// stores.  Row and column step along without a division; the bounds test is
// skipped when the window lies inside the image.
template <int E>
__device__ __forceinline__ void copy_window_general(const float* __restrict__ img, int H, int W,
                                                    int x0, int y0, int win,
                                                    float* __restrict__ out, int lane) {
    const int n = win * win;
    int r = lane / win, c = lane - (lane / win) * win;
    const int dr = 32 / win, dc = 32 - (32 / win) * win;
    const bool inside = x0 >= 0 && y0 >= 0 && x0 + win <= W && y0 + win <= H;
    for (int i = lane; i < n; i += 32 * E) {
        float v[E];
#pragma unroll
        for (int k = 0; k < E; ++k) {
            const int y = y0 + r, x = x0 + c;
            const bool ok = i + 32 * k < n && (inside || (y >= 0 && y < H && x >= 0 && x < W));
            v[k] = ok ? __ldg(img + (size_t)y * W + x) : 0.f;
            c += dc;
            r += dr;
            if (c >= win) {
                c -= win;
                ++r;
            }
        }
#pragma unroll
        for (int k = 0; k < E; ++k)
            if (i + 32 * k < n) out[i + 32 * k] = v[k];
    }
}

// One warp, one row of the output.  WIN > 0: an instance for that window
// edge; WIN == 0: any edge.
template <int WIN, bool LEVELS>
__device__ __forceinline__ void gather_row(const GatherParams& p) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + warp;
    if (row >= p.n_rows) return;
    const int win = WIN > 0 ? WIN : p.win;
    int src = 0, local = row;
    if (LEVELS) {
        src = __ldg(p.level + row);
    } else {
        while (row >= p.row_end[src]) ++src;
        local = row - (src > 0 ? p.row_end[src - 1] : 0);
    }
    const int j = LEVELS ? 0 : src;
    float* o = p.out[j] + (size_t)local * win * win;
    if (LEVELS && (src < 0 || src >= p.n_sources)) {
        for (int i = lane; i < win * win; i += 32) o[i] = 0.f;
        return;
    }
    const int x0 = __ldg(p.au[j] + local), y0 = __ldg(p.av[j] + local);
    if ((p.aligned_mask >> src) & 1u) {
        copy_window_aligned<WIN % 4 == 0 ? WIN : 0>(p.img[src], p.h[src], p.w[src], x0, y0, win,
                                                    o, lane);
    } else {
        constexpr int E = WIN > 0 ? (WIN * WIN + 31) / 32 : 16;
        copy_window_general<E>(p.img[src], p.h[src], p.w[src], x0, y0, win, o, lane);
    }
}

template <int WIN>
__global__ void __launch_bounds__(256) extract_windows_kernel(const __grid_constant__ GatherParams p) {
    gather_row<WIN, false>(p);
}

template <int WIN>
__global__ void __launch_bounds__(256)
    pack_level_windows_kernel(const __grid_constant__ GatherParams p) {
    gather_row<WIN, true>(p);
}

// The sources of a launch and the launch's block shape (the same for every
// source: it depends on win alone).  Returns 0 or an error.
int set_sources(GatherParams& p, int n, const float* const* img, const int* h, const int* w,
                int win, Plan& pl) {
    if (n < 1 || n > kMaxSources || win < 1) return (int)cudaErrorInvalidValue;
    p.n_sources = n;
    p.win = win;
    p.aligned_mask = 0;
    pl = {false, 8, 256};
    for (int i = 0; i < n; ++i) {
        if (h[i] < 1 || w[i] < 1) return (int)cudaErrorInvalidValue;
        const Plan s = window_plan(w[i], win, (unsigned long long)(uintptr_t)img[i]);
        p.img[i] = img[i];
        p.h[i] = h[i];
        p.w[i] = w[i];
        pl.windows = s.windows;
        pl.threads = s.threads;
        if (s.aligned) p.aligned_mask |= 1u << i;
    }
    return 0;
}

template <int WIN, bool LEVELS>
int launch_as(const GatherParams& p, const Plan& pl, cudaStream_t stream) {
    void (*kernel)(GatherParams) =
        LEVELS ? pack_level_windows_kernel<WIN> : extract_windows_kernel<WIN>;
    const int blocks = (p.n_rows + pl.windows - 1) / pl.windows;
    kernel<<<blocks, pl.threads, 0, stream>>>(p);
    return (int)cudaGetLastError();
}

template <bool LEVELS>
int launch(const GatherParams& p, const Plan& pl, cudaStream_t stream) {
    if (p.n_rows == 0) return 0;
    switch (p.win) {
        case 24: return launch_as<24, LEVELS>(p, pl, stream);
        case 40: return launch_as<40, LEVELS>(p, pl, stream);
        case 44: return launch_as<44, LEVELS>(p, pl, stream);
        default: return launch_as<0, LEVELS>(p, pl, stream);
    }
}

}  // namespace

// The plan of one source (h, w) at `base_addr` for windows of edge `win`:
// out3 = {aligned body (1) or general body (0), windows per block, threads}.
// Returns 0, or 1 for a shape no launch takes.
extern "C" int hso_window_launch_plan(int h, int w, int win, unsigned long long base_addr,
                                      int* out3) {
    if (h < 1 || w < 1 || win < 1) return 1;
    const Plan pl = window_plan(w, win, base_addr);
    out3[0] = pl.aligned ? 1 : 0;
    out3[1] = pl.windows;
    out3[2] = pl.threads;
    return 0;
}

// Up to 8 jobs of K1 in one launch; all jobs share the window edge.
extern "C" int hso_extract_windows_jobs(const WindowJob* jobs, int n_jobs, int win,
                                        cudaStream_t stream) {
    if (n_jobs < 1 || n_jobs > kMaxSources) return (int)cudaErrorInvalidValue;
    GatherParams p{};
    const float* img[kMaxSources];
    int h[kMaxSources], w[kMaxSources];
    int rows = 0;
    for (int j = 0; j < n_jobs; ++j) {
        if (jobs[j].n < 0) return (int)cudaErrorInvalidValue;
        img[j] = jobs[j].img;
        h[j] = jobs[j].h;
        w[j] = jobs[j].w;
        if ((uintptr_t)jobs[j].out % 16 != 0) return (int)cudaErrorInvalidValue;
        p.au[j] = jobs[j].au;
        p.av[j] = jobs[j].av;
        p.out[j] = jobs[j].out;
        rows += jobs[j].n;
        p.row_end[j] = rows;
    }
    p.n_rows = rows;
    p.level = nullptr;
    Plan pl;
    const int err = set_sources(p, n_jobs, img, h, w, win, pl);
    if (err != 0) return err;
    return launch<false>(p, pl, stream);
}

extern "C" int hso_extract_windows(const float* img, int H, int W, const int* au, const int* av,
                                   int N, int win, float* out, cudaStream_t stream) {
    const WindowJob job = {img, H, W, au, av, N, out};
    return hso_extract_windows_jobs(&job, 1, win, stream);
}

extern "C" int hso_pack_level_windows(const LevelTable* tbl, int n_levels, const int* level,
                                      const int* au, const int* av, int S, int win, float* out,
                                      cudaStream_t stream) {
    if ((uintptr_t)out % 16 != 0) return (int)cudaErrorInvalidValue;
    GatherParams p{};
    p.au[0] = au;
    p.av[0] = av;
    p.out[0] = out;
    p.row_end[0] = S;
    p.n_rows = S;
    p.level = level;
    Plan pl;
    const int err = set_sources(p, n_levels, tbl->img, tbl->h, tbl->w, win, pl);
    if (err != 0) return err;
    return launch<true>(p, pl, stream);
}
