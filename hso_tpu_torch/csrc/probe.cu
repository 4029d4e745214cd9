// Latency probes for the two serial LM kernels (K3 coarse level loop, K5 pose
// LM).  Neither kernel can come near a bytes or operations bound: an
// evaluation is a reduction, a barrier and a scalar step, one after another.
// These loops time each of those pieces alone on the card, with the code the
// kernels use (hso::block_sums, hso::coarse_lm_step, hso::pose_lm_step), so
// that a latency floor = evaluations x (reduction + barrier + scalar step)
// can be written beside each kernel's time.  Not on any path of the package:
// only measurement scripts launch them.
//
// hso_probe_tma asks whether the card's Tensor Memory Accelerator copies a
// tile (tools/probe_tma.py; the window kernels K1/K2 would use it).  A fault
// there poisons the CUDA context, so only a child process calls it.
#include <cooperative_groups.h>
#include <cuda.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

enum Kind {
    BLOCK_BARRIER = 0,    // __syncthreads()
    CLUSTER_BARRIER = 1,  // cluster.sync()
    BLOCK_SUMS_37 = 2,    // hso::block_sums<37> + __syncthreads()  (K3, inside a block)
    BLOCK_SUMS_28 = 3,    // hso::block_sums<28> + __syncthreads()  (K5)
    COARSE_STEP = 4,      // hso::coarse_lm_step by warp 0, result through shared memory
    POSE_STEP = 5,        // hso::pose_lm_step by warp 0, result through shared memory
    CLUSTER_SUM_37 = 6,   // slot write, cluster.sync(), 37 threads add the slots of all
                          // blocks through distributed shared memory, __syncthreads()
};

// A well-conditioned packed lower-triangular system [H or A | b] in s[0..n).
__device__ void fill_system(float* s, int dim) {
    int idx = 0;
    for (int i = 0; i < dim; ++i)
        for (int j = 0; j <= i; ++j) s[idx++] = i == j ? 10.0f + (float)i : 0.1f;
    for (int i = 0; i < dim; ++i) s[idx++] = 1e-3f * (float)(i + 1);
}

template <int KIND>
__global__ void __launch_bounds__(512) probe_kernel(int iters, float* __restrict__ out) {
    __shared__ float red[37 * 16];            // the warps' sums of hso::block_sums
    __shared__ float s_out[2][40];
    __shared__ float s_sys[40];
    cg::cluster_group cluster = cg::this_cluster();
    float x = (float)threadIdx.x * 1e-3f;     // carried through the loop: nothing folds away
    if (threadIdx.x == 0) fill_system(s_sys, KIND == POSE_STEP ? 6 : 7);
    if (threadIdx.x < 40) s_out[0][threadIdx.x] = s_out[1][threadIdx.x] = 0.f;
    __syncthreads();
    float T[12] = {1.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 0.f, 1.f, 0.f};
    for (int i = 0; i < iters; ++i) {
        if (KIND == BLOCK_BARRIER) {
            __syncthreads();
        } else if (KIND == CLUSTER_BARRIER) {
            cluster.sync();
        } else if (KIND == BLOCK_SUMS_37) {
            float acc[37];
#pragma unroll
            for (int k = 0; k < 37; ++k) acc[k] = x + (float)k;
            hso::block_sums<37>(acc, red, s_out[0]);
            __syncthreads();
            x = s_out[0][threadIdx.x % 37] * 1e-6f;
        } else if (KIND == BLOCK_SUMS_28) {
            float acc[28];
#pragma unroll
            for (int k = 0; k < 28; ++k) acc[k] = x + (float)k;
            hso::block_sums<28>(acc, red, s_out[0]);
            __syncthreads();
            x = s_out[0][threadIdx.x % 28] * 1e-6f;
        } else if (KIND == COARSE_STEP) {
            if (threadIdx.x < 32) {
                float Tn[12], an, sn;
                hso::coarse_lm_step(s_sys, 0.1f + fabsf(x) * 1e-3f, T, 1.0f, Tn, an, sn);
                if (threadIdx.x == 0) {
#pragma unroll
                    for (int k = 0; k < 12; ++k) s_out[0][k] = Tn[k];
                    s_out[0][12] = sn + an * 1e-6f;
                }
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < 12; ++k) T[k] = s_out[0][k];
            x = s_out[0][12];
            __syncthreads();
        } else if (KIND == POSE_STEP) {
            if (threadIdx.x < 32) {
                float Tn[12], dT[6];
                const bool ok = hso::pose_lm_step(s_sys, 0.1f + fabsf(x) * 1e-3f, T, Tn, dT);
                if (threadIdx.x == 0) {
#pragma unroll
                    for (int k = 0; k < 12; ++k) s_out[0][k] = Tn[k];
                    s_out[0][12] = ok ? dT[0] : 1.0f;
                }
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < 12; ++k) T[k] = s_out[0][k];
            x = s_out[0][12];
            __syncthreads();
        } else {
            float* slot = s_out[i & 1];
            if (threadIdx.x < 37) slot[threadIdx.x] = x;
            cluster.sync();
            if (threadIdx.x < 37) {
                float part[8];
#pragma unroll
                for (unsigned r = 0; r < 8; ++r)
                    part[r] = r < cluster.num_blocks()
                                  ? *cluster.map_shared_rank(slot + threadIdx.x, r) : 0.f;
                float s = 0.f;
#pragma unroll
                for (unsigned r = 0; r < 8; ++r) s += part[r];
                s_sys[threadIdx.x] = s * 1e-6f;
            }
            __syncthreads();
            x = s_sys[threadIdx.x % 37];
        }
    }
    cluster.sync();
    if (cluster.block_rank() == 0 && threadIdx.x == 0) out[0] = x + T[3];
}

template <int KIND>
cudaError_t launch(int threads, int cluster, int iters, float* out, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, probe_kernel<KIND>, iters, out);
}

// One thread: kind 0 copies the 24 x 24 box at (3, 2) of the image through a
// tensor map (cp.async.bulk.tensor.2d), kind 1 the image's first 2304 bytes
// by a plain bulk copy (cp.async.bulk); both land in shared memory, complete
// on an mbarrier and are written to out by the same thread.
__global__ void tma_probe_kernel(const __grid_constant__ CUtensorMap map, const float* img,
                                 int kind, float* out) {
    __shared__ __align__(128) float box[24 * 24];
    __shared__ __align__(8) uint64_t bar_mem;
    if (threadIdx.x != 0) return;
    const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(&bar_mem));
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(box));
    const uint32_t bytes = sizeof(box);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
    if (kind == 0) {
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
            "l"(reinterpret_cast<uint64_t>(&map)), "r"(3), "r"(2), "r"(bar)
            : "memory");
    } else {
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
            ::"r"(dst), "l"(img), "r"(bytes), "r"(bar)
            : "memory");
    }
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(bar), "r"(0u)
            : "memory");
    } while (!done);
    for (int i = 0; i < 24 * 24; ++i) out[i] = box[i];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

}  // namespace

// Launch the TMA probe (see tma_probe_kernel) on an (h, w) float image, h >= 26
// and w >= 27, 16-byte aligned with w % 4 == 0; out holds 576 floats.  Returns
// the launch's error, 900 when the driver has no cuTensorMapEncodeTiled, or
// 1000 + the CUresult of a tensor map that failed to encode.
extern "C" int hso_probe_tma(int kind, const float* img, int h, int w, float* out,
                             cudaStream_t stream) {
    CUtensorMap map{};
    if (kind == 0) {
        void* f = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                               cudaEnableDefault, &q);
#else
        const cudaError_t e =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
        if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return 900;
        const cuuint64_t dim[2] = {(cuuint64_t)w, (cuuint64_t)h};
        const cuuint64_t stride[1] = {(cuuint64_t)w * sizeof(float)};
        const cuuint32_t box[2] = {24, 24};
        const cuuint32_t elem[2] = {1, 1};
        const CUresult r = reinterpret_cast<EncodeTiled>(f)(
            &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(img), dim, stride, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return 1000 + (int)r;
    }
    tma_probe_kernel<<<1, 32, 0, stream>>>(map, img, kind, out);
    return (int)cudaGetLastError();
}

// Run `iters` rounds of one probe (see Kind) in one cluster of `cluster`
// blocks of `threads` threads; out[0] receives a value that depends on every
// round.  Time two lengths and divide the difference by the extra rounds.
extern "C" int hso_probe_latency(int kind, int threads, int cluster, int iters, float* out,
                                 cudaStream_t stream) {
    if (threads < 64 || threads > 512 || threads % 32 || cluster < 1 || cluster > 8) return 1;
    cudaError_t e;
    switch (kind) {
        case BLOCK_BARRIER: e = launch<BLOCK_BARRIER>(threads, cluster, iters, out, stream); break;
        case CLUSTER_BARRIER: e = launch<CLUSTER_BARRIER>(threads, cluster, iters, out, stream); break;
        case BLOCK_SUMS_37: e = launch<BLOCK_SUMS_37>(threads, cluster, iters, out, stream); break;
        case BLOCK_SUMS_28: e = launch<BLOCK_SUMS_28>(threads, cluster, iters, out, stream); break;
        case COARSE_STEP: e = launch<COARSE_STEP>(threads, cluster, iters, out, stream); break;
        case POSE_STEP: e = launch<POSE_STEP>(threads, cluster, iters, out, stream); break;
        case CLUSTER_SUM_37: e = launch<CLUSTER_SUM_37>(threads, cluster, iters, out, stream); break;
        default: return 1;
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
