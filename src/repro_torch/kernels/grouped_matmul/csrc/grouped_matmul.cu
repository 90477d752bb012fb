// Expert-blocked grouped matmul for Hopper (sm_90a), SIMT fp32 FMA.
//
// Replaces repro/kernels/grouped_matmul/kernel.py:_gmm_kernel (the Pallas
// TPU kernel).  It computes the same function, not the same blocks:
//   out[e, r, :] = x[e, r, :] @ w[e]   for r <  group_sizes[e]
//   out[e, r, :] = 0                   for r >= group_sizes[e]
// with x (E, C, d), w (E, d, f), out (E, C, f) in f32 or bf16, products
// accumulated in fp32 and the result written in x's type.  Any C, d, f:
// ragged edges are masked.
//
// Design.  One thread block per (column tile, row tile, expert) of 128x128
// outputs.  The TPU kernel's sequential contraction grid axis and its VMEM
// accumulator become a loop over d inside the block, through BK-deep
// shared-memory tiles, with the 128x128 fp32 accumulator held in
// registers (8x8 per thread).  The block reads group_sizes[e] itself in
// place of the TPU's scalar prefetch: a tile whose first row is at or past
// it writes zeros and returns, and in a partial tile the rows past it are
// neither loaded nor kept (they are written as exact zeros).
//
// Numerics.  In f32 every product is an fp32 FMA: no TF32, so the kernel
// matches a full-precision fp32 reference.  bf16 inputs are widened to
// fp32 on load; the result is rounded to bf16 once, on store.
//
// Bound.  At the streaming payload's shape (E=128, C=128, d=f=2048, f32)
// the call does 2*E*C*d*f = 137 GFLOP on fp32 CUDA cores against 2.4 GB
// of traffic (w read once dominates): 2.0 ms of operations at the H100's
// 67 TFLOP/s fp32 peak against 0.7 ms of bytes at 3.35 TB/s, so it is
// bound by operations.  The design answers with register blocking: each
// thread does 64 FMAs for every 16 shared-memory loads, and with C=128 a
// row tile spans the whole bin, so each w element is read from device
// memory once.  wgmma/TMA (tensor cores, bf16) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // output rows per block
constexpr int BN = 128;     // output columns per block
constexpr int BK = 8;       // contraction depth per shared-memory tile
constexpr int THREADS = 256;
constexpr int PAD = 4;      // keeps the transposed A tile free of bank conflicts

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int32_t* __restrict__ group_sizes, T* __restrict__ out,
           int C, int d, int f) {
    const int e = blockIdx.z;
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;
    const int tid = threadIdx.x;
    const int g = min(max(group_sizes[e], 0), C);
    T* o = out + (size_t)e * C * f;

    if (row0 >= g) {  // tile wholly past the bin's occupancy: zeros, no work
        for (int i = tid; i < BM * BN; i += THREADS) {
            const int r = row0 + i / BN, c = col0 + i % BN;
            if (r < C && c < f) o[(size_t)r * f + c] = from_f32<T>(0.f);
        }
        return;
    }

    const T* xe = x + (size_t)e * C * d;
    const T* we = w + (size_t)e * d * f;
    const int rows_live = min(BM, g - row0);

    __shared__ __align__(16) float As[BK][BM + PAD];  // A tile, transposed
    __shared__ __align__(16) float Bs[BK][BN];

    // thread (ty, tx) owns rows {ty*4 + i, 64 + ty*4 + i} and columns
    // {tx*4 + j, 64 + tx*4 + j}, i, j < 4: float4 reads of shared memory
    // that a warp spreads over distinct banks
    const int ty = tid / 16, tx = tid % 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
        for (int s = 0; s < (BM * BK) / THREADS; ++s) {
            const int i = tid + s * THREADS;
            const int r = i / BK, kk = i % BK, gk = k0 + kk;
            As[kk][r] = (r < rows_live && gk < d)
                            ? to_f32(xe[(size_t)(row0 + r) * d + gk]) : 0.f;
        }
#pragma unroll
        for (int s = 0; s < (BK * BN) / THREADS; ++s) {
            const int i = tid + s * THREADS;
            const int kk = i / BN, c = i % BN, gk = k0 + kk, gc = col0 + c;
            Bs[kk][c] = (gk < d && gc < f) ? to_f32(we[(size_t)gk * f + gc]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[8], b[8];
            const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
            a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
            a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
            b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
            b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
        if (r >= C) continue;
        const bool live = r < g;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
            if (c < f) o[(size_t)r * f + c] = from_f32<T>(live ? acc[i][j] : 0.f);
        }
    }
}

template <typename T>
int launch(const void* x, const void* w, const void* group_sizes, void* out,
           int E, int C, int d, int f, void* stream) {
    const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
    gmm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const int32_t*>(group_sizes), static_cast<T*>(out), C, d, f);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int gmm_f32(const void* x, const void* w, const void* group_sizes,
                       void* out, int E, int C, int d, int f, void* stream) {
    return launch<float>(x, w, group_sizes, out, E, C, d, f, stream);
}

extern "C" int gmm_bf16(const void* x, const void* w, const void* group_sizes,
                        void* out, int E, int C, int d, int f, void* stream) {
    return launch<__nv_bfloat16>(x, w, group_sizes, out, E, C, d, f, stream);
}

extern "C" const char* gmm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
