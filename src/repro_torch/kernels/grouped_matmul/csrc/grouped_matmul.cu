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
// Numerics.  Each output is one fp32 accumulator that takes the products
// x[e, r, k] * w[e, k, c] for k = 0, 1, ..., d - 1 in that order, each as
// an fp32 FMA: no split over k, no tree, no TF32.  That is the order of a
// full-precision SIMT GEMM, so the f32 entry matches the fp32 reference
// (torch.bmm with TF32 off) bit for bit at the streaming payload's shape.
// bf16 inputs are widened to fp32 on load; the result is rounded to bf16
// once, on store.
//
// Design.  One block of 256 threads per (column tile, row tile, expert) of
// 128 x 256 outputs, one block to an SM (__launch_bounds__(256, 1)).  The
// TPU kernel's sequential contraction grid axis and its VMEM accumulator
// become a loop over d inside the block through 16-deep k tiles, double-
// buffered in shared memory, so that tile t + 1 is in flight while tile t
// is computed and each tile costs one __syncthreads:
//   - the w tile (16 x 256) is copied by 16-byte cp.async (f32), or loaded
//     as 16 bytes a thread and widened (bf16), into its row-major buffer;
//   - the x tile (128 x 16) is loaded as 16 bytes a thread into registers
//     at the top of the iteration and stored transposed (k-major) into the
//     other buffer after this tile's FMAs; a 256-column tile loads each x
//     tile once for twice the FMAs of a 128-column one;
//   - warps tile the block 2 x 4, 64 x 64 outputs each; a thread holds
//     16 x 8 accumulators (rows {0..3, 16..19, 32..35, 48..51} and columns
//     {0..3, 32..35} of its warp's tile, offset by its lane), so each k step
//     is four 16-byte reads of x and two of w from shared memory for 128
//     FMAs, and the eight lanes of each quarter-warp read one broadcast x
//     address and 128 contiguous bytes of w: no bank conflicts.
// Shapes the 16-byte loads cannot take (d or f not a multiple of 4 in f32
// or of 8 in bf16, or an input not 16-byte aligned) go through the same
// kernel with scalar loads (the VEC = false instance); ragged C and the
// rows past group_sizes[e] are masked in both.  The block reads
// group_sizes[e] itself in place of the TPU's scalar prefetch: a tile whose
// first row is at or past it writes zeros and returns, and in a partial
// tile the rows past it are neither loaded nor kept (they are written as
// exact zeros).
//
// Bound.  At the streaming payload's shape (E=128, C=128, d=f=2048, f32)
// the call does 2*E*C*d*f = 137 GFLOP on fp32 CUDA cores against 2.4 GB
// of traffic (w read once dominates): 2.05 ms of operations at the H100's
// 67 TFLOP/s fp32 peak against 0.7 ms of bytes at 3.35 TB/s, so it is
// bound by operations.  With C=128 a row tile spans the whole bin, so each
// w element is read from device memory once.  On an NVIDIA H100 80GB HBM3
// at 700 W the call takes about 2.9 ms, 0.7 of the bound (tools/kernel_ab.py;
// the SM clock holds 1980 MHz), a few percent over torch.bmm.  Variants of
// this source (tools/kernel_variants.py, PERF.md): the loop with no loads
// at all is about 9% faster, so the FMA loop itself sets most of the time;
// 128 x 128 tiles (128 threads of 16 x 8, or 256 of 8 x 8) and 8-deep k
// tiles are slower.  ptxas (-Xptxas -v, CUDA 12.9): 235 registers with
// 16-byte loads, 253 on the scalar edge path, no spills.  wgmma/TMA (tensor
// cores) would turn the f32 entry into TF32; the bf16 entry may take them
// once the MoE layer gives it a shape to be measured at.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // output rows per block
constexpr int BN = 256;     // output columns per block
constexpr int BK = 16;      // contraction depth per shared-memory tile
constexpr int THREADS = 256;
// warps tile the block WARPS_M x WARPS_N; a lane of a 4 x 8 grid holds
// RG groups of 4 rows (16 apart) by 2 groups of 4 columns (32 apart)
constexpr int WARPS_N = 4;
constexpr int WARPS_M = THREADS / 32 / WARPS_N;
constexpr int WTM = BM / WARPS_M;          // warp tile rows
constexpr int WTN = BN / WARPS_N;          // warp tile columns: 64
constexpr int RG = WTM / 16;               // row groups a lane holds
constexpr int TM = 4 * RG, TN = 8;         // accumulators a thread holds
static_assert(WTN == 64 && WTM % 16 == 0, "lane grid 4 x 8, 4 x 4 fragments");
constexpr int LDA = BM + 4; // row stride of the transposed x tile
constexpr int XE = BM * BK / THREADS;  // x tile elements a thread loads
constexpr int WE = BK * BN / THREADS;  // w tile elements a thread loads
// shared memory: two x tiles (transposed) and two w tiles
constexpr size_t SMEM_BYTES = 2 * (size_t)BK * (LDA + BN) * sizeof(float);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

// 16 bytes of device memory as fp32 values: 4 f32 or 8 bf16
__device__ __forceinline__ void widen16(const uint4& u, float* out, float) {
    out[0] = __uint_as_float(u.x); out[1] = __uint_as_float(u.y);
    out[2] = __uint_as_float(u.z); out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen16(const uint4& u, float* out, __nv_bfloat16) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, int src_bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Loads of one k tile.  VEC: 16 bytes a thread (d and f multiples of 16
// bytes' worth of elements, aligned inputs); else one element at a time.
// Each thread stages XE x elements (and, unless w goes by cp.async, WE w
// elements) in registers between the global load and the shared store.
template <typename T, bool VEC>
struct Tiles {
    static constexpr int V = 16 / sizeof(T);          // elements per 16 bytes
    static constexpr bool W_ASYNC = VEC && sizeof(T) == 4;
    float xa[XE];  // x tile elements, widened
    float wb[WE];  // w tile elements, widened (unless cp.async)

    // x rows [row0, row0 + rows_live), columns [k0, k0 + BK)
    __device__ __forceinline__ void load_x(const T* xe, int d, int row0, int rows_live,
                                           int k0, int tid) {
        if constexpr (VEC) {
#pragma unroll
            for (int s = 0; s < XE / V; ++s) {
                const int i = tid + s * THREADS;
                const int r = i / (BK / V), kc = (i % (BK / V)) * V;
                uint4 u = make_uint4(0, 0, 0, 0);
                if (r < rows_live && k0 + kc < d)
                    u = __ldg(reinterpret_cast<const uint4*>(
                        xe + (size_t)(row0 + r) * d + k0 + kc));
                widen16(u, xa + s * V, T());
            }
        } else {
#pragma unroll
            for (int s = 0; s < XE; ++s) {
                const int i = tid + s * THREADS;
                const int r = i / BK, k = i % BK;
                xa[s] = (r < rows_live && k0 + k < d)
                            ? to_f32(xe[(size_t)(row0 + r) * d + k0 + k]) : 0.f;
            }
        }
    }

    __device__ __forceinline__ void store_x(float (*As)[LDA], int tid) const {
        if constexpr (VEC) {
#pragma unroll
            for (int s = 0; s < XE / V; ++s) {
                const int i = tid + s * THREADS;
                const int r = i / (BK / V), kc = (i % (BK / V)) * V;
#pragma unroll
                for (int j = 0; j < V; ++j) As[kc + j][r] = xa[s * V + j];
            }
        } else {
#pragma unroll
            for (int s = 0; s < XE; ++s) {
                const int i = tid + s * THREADS;
                As[i % BK][i / BK] = xa[s];
            }
        }
    }

    // w rows [k0, k0 + BK), columns [col0, col0 + BN); by cp.async straight
    // into Bs when W_ASYNC, else into registers
    __device__ __forceinline__ void load_w(const T* we, int d, int f, int k0, int col0,
                                           int tid, float (*Bs)[BN]) {
        if constexpr (W_ASYNC) {
#pragma unroll
            for (int s = 0; s < WE / 4; ++s) {
                const int i = tid + s * THREADS;
                const int kk = i / (BN / 4), c = (i % (BN / 4)) * 4;
                const bool in = k0 + kk < d && col0 + c < f;
                const T* src = in ? we + (size_t)(k0 + kk) * f + col0 + c : we;
                cp_async16(&Bs[kk][c], src, in ? 16 : 0);
            }
        } else if constexpr (VEC) {  // bf16, 8 elements a load
#pragma unroll
            for (int s = 0; s < WE / V; ++s) {
                const int i = tid + s * THREADS;
                const int kk = i / (BN / V), c = (i % (BN / V)) * V;
                uint4 u = make_uint4(0, 0, 0, 0);
                if (k0 + kk < d && col0 + c < f)
                    u = __ldg(reinterpret_cast<const uint4*>(
                        we + (size_t)(k0 + kk) * f + col0 + c));
                widen16(u, wb + s * V, T());
            }
        } else {
#pragma unroll
            for (int s = 0; s < WE; ++s) {
                const int i = tid + s * THREADS;
                const int kk = i / BN, c = i % BN;
                wb[s] = (k0 + kk < d && col0 + c < f)
                            ? to_f32(we[(size_t)(k0 + kk) * f + col0 + c]) : 0.f;
            }
        }
    }

    __device__ __forceinline__ void store_w(float (*Bs)[BN], int tid) const {
        if constexpr (W_ASYNC) {
            return;
        } else if constexpr (VEC) {
#pragma unroll
            for (int s = 0; s < WE / V; ++s) {
                const int i = tid + s * THREADS;
                const int kk = i / (BN / V), c = (i % (BN / V)) * V;
                const float* v = wb + s * V;
                *reinterpret_cast<float4*>(&Bs[kk][c]) = make_float4(v[0], v[1], v[2], v[3]);
                *reinterpret_cast<float4*>(&Bs[kk][c + 4]) = make_float4(v[4], v[5], v[6], v[7]);
            }
        } else {
#pragma unroll
            for (int s = 0; s < WE; ++s) {
                const int i = tid + s * THREADS;
                Bs[i / BN][i % BN] = wb[s];
            }
        }
    }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
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

    extern __shared__ __align__(16) float smem[];
    float (*As)[BK][LDA] = reinterpret_cast<float (*)[BK][LDA]>(smem);  // x, transposed
    float (*Bs)[BK][BN] = reinterpret_cast<float (*)[BK][BN]>(smem + 2 * BK * LDA);

    // warp (wr, wc) owns rows wr*WTM + [0, WTM) and columns wc*64 + [0, 64);
    // lane (ly, lx) of 4 x 8 owns rows {ly*4 + 16*g + i} (g < RG) and columns
    // {lx*4 + 32*h + j} (h < 2) of those, i, j < 4
    const int warp = tid >> 5, lane = tid & 31;
    const int ar = (warp / WARPS_N) * WTM + (lane >> 3) * 4;
    const int bc = (warp % WARPS_N) * WTN + (lane & 7) * 4;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    Tiles<T, VEC> tiles;
    const int n_tiles = (d + BK - 1) / BK;
    tiles.load_x(xe, d, row0, rows_live, 0, tid);
    tiles.load_w(we, d, f, 0, col0, tid, Bs[0]);
    cp_async_commit();
    tiles.store_x(As[0], tid);
    tiles.store_w(Bs[0], tid);
    cp_async_wait_all();
    __syncthreads();

    for (int t = 0; t < n_tiles; ++t) {
        const int cur = t & 1;
        const bool more = t + 1 < n_tiles;
        if (more) {  // the next tile, in flight under this one's FMAs
            tiles.load_x(xe, d, row0, rows_live, (t + 1) * BK, tid);
            tiles.load_w(we, d, f, (t + 1) * BK, col0, tid, Bs[cur ^ 1]);
            cp_async_commit();
        }
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], b[TN];
#pragma unroll
            for (int q = 0; q < RG; ++q) {
                const float4 v = *reinterpret_cast<const float4*>(&As[cur][kk][ar + 16 * q]);
                a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z; a[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float4 v = *reinterpret_cast<const float4*>(&Bs[cur][kk][bc + 32 * h]);
                b[4 * h] = v.x; b[4 * h + 1] = v.y; b[4 * h + 2] = v.z; b[4 * h + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (more) {
            tiles.store_x(As[cur ^ 1], tid);
            tiles.store_w(Bs[cur ^ 1], tid);
            cp_async_wait_all();
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ar + 16 * (i / 4) + i % 4;
        if (r >= C) continue;
        const bool live = r < g;
        T* orow = o + (size_t)r * f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int c = col0 + bc + 32 * h;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = live ? acc[i][4 * h + j] : 0.f;
            if (VEC && c + 4 <= f) {
                if constexpr (sizeof(T) == 4) {
                    *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
                } else {
                    __nv_bfloat162 p[2] = {__floats2bfloat162_rn(v[0], v[1]),
                                           __floats2bfloat162_rn(v[2], v[3])};
                    *reinterpret_cast<uint2*>(orow + c) = *reinterpret_cast<uint2*>(p);
                }
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    if (c + j < f) orow[c + j] = from_f32<T>(v[j]);
            }
        }
    }
}

template <typename T>
int launch(const void* x, const void* w, const void* group_sizes, void* out,
           int E, int C, int d, int f, void* stream) {
    constexpr int V = 16 / sizeof(T);
    const bool vec = d % V == 0 && f % V == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0
        && reinterpret_cast<uintptr_t>(w) % 16 == 0
        && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
    auto kernel = vec ? gmm_kernel<T, true> : gmm_kernel<T, false>;
    if (SMEM_BYTES > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
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
