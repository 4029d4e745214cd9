// K1 / K2: per-feature window extraction.
//
// Replaces the Pallas kernels extract_windows_tpu and pack_level_windows_tpu
// (ops/window_pallas.py of the JAX package).  Those load an aligned block and
// rotate it in registers because the TPU cannot address an arbitrary offset;
// here a window is a plain strided copy.
//
// Bound: at the main-path shapes (336 windows of 24x24 floats) the function
// moves about 1.5 MB in all, which the card's memory system does in under a
// microsecond; what remains is the launch.  Design: one block per window,
// consecutive threads on consecutive columns so each window row is one
// contiguous read and one contiguous write; inputs in their natural (H, W)
// layout, no padding.  K2 is the same routine with the image picked per row
// from a small table of level pointers passed by value.
#include "common.cuh"

struct LevelTable {
    const float* img[8];
    int h[8];
    int w[8];
};

namespace {

__device__ __forceinline__ void copy_window(const float* __restrict__ img, int H, int W, int au,
                                            int av, int win, float* __restrict__ out) {
    for (int i = threadIdx.x; i < win * win; i += blockDim.x) {
        const int r = i / win, c = i - r * win;
        const int y = av + r, x = au + c;
        out[i] = (y >= 0 && y < H && x >= 0 && x < W) ? __ldg(img + (size_t)y * W + x) : 0.f;
    }
}

__global__ void extract_windows_kernel(const float* __restrict__ img, int H, int W,
                                       const int* __restrict__ au, const int* __restrict__ av,
                                       int win, float* __restrict__ out) {
    const int n = blockIdx.x;
    copy_window(img, H, W, au[n], av[n], win, out + (size_t)n * win * win);
}

__global__ void pack_level_windows_kernel(LevelTable tbl, int n_levels,
                                          const int* __restrict__ level,
                                          const int* __restrict__ au,
                                          const int* __restrict__ av, int win,
                                          float* __restrict__ out) {
    const int s = blockIdx.x;
    const int l = level[s];
    float* o = out + (size_t)s * win * win;
    if (l < 0 || l >= n_levels) {
        for (int i = threadIdx.x; i < win * win; i += blockDim.x) o[i] = 0.f;
        return;
    }
    copy_window(tbl.img[l], tbl.h[l], tbl.w[l], au[s], av[s], win, o);
}

}  // namespace

extern "C" int hso_extract_windows(const float* img, int H, int W, const int* au, const int* av,
                                   int N, int win, float* out, cudaStream_t stream) {
    extract_windows_kernel<<<N, 128, 0, stream>>>(img, H, W, au, av, win, out);
    return (int)cudaGetLastError();
}

extern "C" int hso_pack_level_windows(const LevelTable* tbl, int n_levels, const int* level,
                                      const int* au, const int* av, int S, int win, float* out,
                                      cudaStream_t stream) {
    pack_level_windows_kernel<<<S, 128, 0, stream>>>(*tbl, n_levels, level, au, av, win, out);
    return (int)cudaGetLastError();
}
