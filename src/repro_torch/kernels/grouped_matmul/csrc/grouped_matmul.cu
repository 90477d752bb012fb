// Expert-blocked grouped matmul for Hopper (sm_90a): bf16 on the tensor
// cores (TMA + wgmma), f32 and the bf16 edge cases on a SIMT fp32 FMA GEMM.
//
// Replaces repro/kernels/grouped_matmul/kernel.py:_gmm_kernel (the Pallas
// TPU kernel).  It computes the same function, not the same blocks:
//   out[e, r, :] = x[e, r, :] @ w[e]   for r <  group_sizes[e]
//   out[e, r, :] = 0                   for r >= group_sizes[e]
// with x (E, C, d), w (E, d, f), out (E, C, f) in f32 or bf16, products
// accumulated in fp32 and the result rounded once to x's type.  Any C, d, f.
//
// Two paths; kernel.py's path() picks one on the host from the dtype, the
// shapes and the pointers, never from group_sizes, and neither falls back
// to the other:
//   - bf16 with d and f multiples of 8 and x, w, out 16-byte aligned (every
//     call of the MoE layer): the tensor-core kernel, gmm_tc_kernel below;
//   - f32, and bf16 that TMA cannot take (a row that is no whole number of
//     16-byte units, an unaligned input): the SIMT kernel, gmm_kernel.
//
// Tensor-core path.  One block of 288 threads per (column tile, row tile,
// expert) of 128 x 256 outputs, the expert slowest in the raster, so that an
// expert's tiles run side by side and re-read its x and w from L2.  Warp 8
// is the producer: one lane keeps TMA copies of 64-deep k boxes in flight
// into a ring of 4 stages in shared memory (x as two boxes of 64 rows, w as
// four boxes of 64 k rows by 64 columns, 128-byte swizzled, straight from
// the row-major arrays: w is the MN-major B operand, no copy or transpose),
// each stage with a "full" barrier the copies complete and an "empty" one
// the consumers release.  Warps 0-3 and 4-7 are two consumer warpgroups,
// each owning a 64-row half of the tile and running wgmma m64n256k16 (bf16
// in, fp32 accumulators in registers) on each stage.  TMA's zero fill past
// the ends of C, d and f replaces the masking of ragged edges on loads.
// The tile goes out by TMA too: each warpgroup rounds its accumulators to
// bf16 into the swizzled boxes its half of x occupied and stores them as
// bulk copies, which clip rows past C and columns past f and run on while
// the next block on the SM starts its loads.
//   Occupancy skip (the TPU kernel's pl.when(occupied), made finer).  A
// block reads group_sizes[e] itself (no host sync): a tile wholly at or
// past it writes zeros and loads nothing; a 64-row half with no live row
// is neither copied nor multiplied (its warpgroup writes zeros); rows past
// it in a computed half are stored as exact zeros, selected, never
// multiplied by a mask.  A decode step's bins of 1-3 rows thus cost one
// m64 strip and one pass over each occupied expert's weights.
//   Determinism.  No split over k and no atomics: each output is one
// accumulator chain over the k boxes in order, so a second launch gives the
// same bits.  The tensor cores sum each k16 step's products in their own
// order, so the result is not bitwise torch.bmm's in fp32; the two differ by
// rounding (relative l2 about 1e-4 in bf16 at the MoE bins).
//
// SIMT path.  Each output is one fp32 accumulator that takes the products
// x[e, r, k] * w[e, k, c] for k = 0, 1, ..., d - 1 in that order, each as an
// fp32 FMA: no split over k, no tree, no TF32 (wgmma would make the f32
// entry TF32; the streaming payload is held to fp32).  The f32 entry
// matches the fp32 reference (torch.bmm with TF32 off) bit for bit at the
// streaming payload's shape; bf16 inputs are widened to fp32 on load.  One
// block of 256 threads per (column tile, row tile, expert) of 128 x 256
// outputs, one block to an SM (__launch_bounds__(256, 1)); a loop over d
// through 16-deep k tiles, double-buffered in shared memory, so that tile
// t + 1 is in flight while tile t is computed and each tile costs one
// __syncthreads:
//   - the w tile (16 x 256) is copied by 16-byte cp.async (f32), or loaded
//     as 16 bytes a thread and widened (bf16), into its row-major buffer;
//   - the x tile (128 x 16) is loaded as 16 bytes a thread into registers
//     at the top of the iteration and stored transposed (k-major) into the
//     other buffer after this tile's FMAs;
//   - warps tile the block 2 x 4, 64 x 64 outputs each; a thread holds
//     16 x 8 accumulators (rows {0..3, 16..19, 32..35, 48..51} and columns
//     {0..3, 32..35} of its warp's tile, offset by its lane), so each k step
//     is four 16-byte reads of x and two of w from shared memory for 128
//     FMAs, with no bank conflicts.
// Shapes the 16-byte loads cannot take (d or f not a multiple of 4 in f32
// or of 8 in bf16, or an input not 16-byte aligned) go through the same
// kernel with scalar loads (the VEC = false instance).  A tile whose first
// row is at or past group_sizes[e] writes zeros and returns; in a partial
// tile the rows past it are neither loaded nor kept.
//
// Bounds (NVIDIA H100 SXM: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
// fp32 on the CUDA cores, 3.35 TB/s), counting each live row's work once:
//   - the MoE decode bins (E = 128, C = 128, d = 2048, f = 768; 8 tokens'
//     top-8, ~64 live rows in ~50 bins) are bound by bytes: ~50 occupied
//     experts' w, 3.1 MB each, and the output: 0.054 ms;
//   - the MoE prefill bins (C = 640, 8 x 1024 tokens' top-8: ~512 live rows
//     a bin; gate/up d = 2048 -> f = 768, down 768 -> 2048) do 2 x 65,536
//     rows x 2048 x 768 = 206 GFLOP, 0.208 ms on the tensor cores, beside
//     0.24-0.25 ms for x's live rows, w and the whole output: bound by
//     bytes, with the operations close behind;
//   - the streaming payload (f32, E = C = 128, d = f = 2048, SIMT) by
//     operations: 137 GFLOP on the CUDA cores, 2.05 ms.
// Readings on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py and
// chip_smoke.py phase 4, CUDA-event medians with the L2 flushed): the
// decode bins 0.083 ms (0.65 of the bound; the SIMT instance took 0.83 ms,
// torch.bmm + row mask takes 0.22), prefill gate/up 0.37 ms (0.64; SIMT
// 5.87, bmm 0.57), prefill down 0.42 ms (0.60; SIMT 5.43, bmm 0.86).
// Stores straight from the accumulators (16 bytes a row per four lanes)
// took 0.42 and 0.54 ms at the prefill bins.  What holds the rest back is
// moving tiles, not the tensor cores: with those stores, the calls took
// about as long without the wgmma (tools/kernel_variants.py gmm-bf16).  A
// block reads 1.5 MB (gate/up) or 0.59 MB (down) from L2 for its tile,
// 2.6 GB a call, 6-7 TB/s out of L2: sharing w between an expert's row
// tiles (TMA multicast in a cluster) is what is left.  Variants: 128-column
// tiles (6 stages, or 3 stages at 2 blocks an SM) were 5% faster at the
// decode bins and 8-18% slower at the prefill's; one more wgmma group in
// flight no faster.
// ptxas (-Xptxas -v, CUDA 12.9): the tensor-core instances 168 registers,
// the SIMT instances 235-237 with 16-byte loads and 253 on the scalar edge
// path, no spills.
//
// Tile census.  gmm_tile_census turns on the CENSUS instances of the
// tensor-core kernel, which count the tiles written as zeros and the 64-row
// halves computed and skipped (atomics into a device array apart from every
// output), and counts the bf16 calls that took the SIMT path.  The timed
// path is the instance compiled without the counters.

#include <cuda.h>
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA into an mbarrier ring, wgmma
// ---------------------------------------------------------------------------

constexpr int TMA_BN = 256;       // output columns per block
constexpr int TMA_STAGES = 4;     // k boxes in flight
constexpr int TMA_MIN_BLOCKS = 1; // blocks an SM holds at once
constexpr int HALF = 64;          // rows of a consumer warpgroup: one wgmma's m
constexpr int TBM = 2 * HALF;     // output rows per block
constexpr int TBK = 64;           // k per box: 128 bytes of bf16, the swizzle span
constexpr int WG = 128;           // threads of a warpgroup
constexpr int TC_THREADS = 2 * WG + 32;  // two consumer warpgroups, then the producer warp
constexpr int BOX_BYTES = 64 * TBK * 2;  // one (64, 64) bf16 box, 128-byte rows
constexpr int ERR_TENSOR_MAP = -1, ERR_NOT_TMA = -2;

// The tile census (the CENSUS instances count into it): tiles written as
// zeros, 64-row halves computed, 64-row halves skipped.
constexpr int ZERO_TILES = 0, HALVES_COMPUTED = 1, HALVES_SKIPPED = 2;
__device__ unsigned long long g_census[3];
bool census_on = false;                  // host: launch the CENSUS instances
unsigned long long simt_bf16_calls = 0;  // host: bf16 calls on the SIMT path while on

// Shared memory of one block, from a 1024-aligned base: per stage the x
// tile (two 64-row halves, one box each) and the w tile (BN / 64 boxes of
// 64 k rows by 64 columns), then the full and empty barriers.
template <int BN, int ST>
struct TcLayout {
    static constexpr int A_STAGE = 2 * BOX_BYTES;
    static constexpr int B_STAGE = BN / 64 * BOX_BYTES;
    static constexpr int A = 0;
    static constexpr int B = A + ST * A_STAGE;
    static constexpr int BARS = B + ST * B_STAGE;
    static constexpr size_t BYTES = BARS + 2 * ST * sizeof(uint64_t) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                            ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and add `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t a = smem_u32(bar);
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(a), "r"(parity)
            : "memory");
    } while (!done);
}

// One box of a 3-d tensor map into shared memory at coordinates (c0, c1,
// c2), innermost first; the copy completes its bytes on `bar`.  Coordinates
// past the end read as 0.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, uint64_t* bar,
                                         int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// One box from shared memory to a 3-d tensor map at (c0, c1, c2); elements
// past the end are not written.  Completes as a bulk async group.
__device__ __forceinline__ void tma_store(const void* src, const CUtensorMap& map, int c0,
                                          int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(&map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}

// Commit the bulk stores issued so far, and wait until they have read their
// shared memory (their writes to device memory may still be in flight).
__device__ __forceinline__ void bulk_commit_and_wait_read() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's writes to shared memory visible to TMA.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1 or more: 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers that an asynchronous wgmma writes stay where they are until its
// wait: the compiler may not move their uses across this point.
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A wgmma shared-memory matrix descriptor, 128-byte swizzle: 8-row groups
// 1024 bytes apart; `lbo` is the distance between the 64-column boxes along
// N of an MN-major operand (not read for a K-major one).
__device__ __forceinline__ uint64_t sw128_desc(const unsigned char* p, uint32_t lbo) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
           (1ull << 62);
}

// d (64 x N) (+)= A . B on the tensor cores: A (64 x 16) K-major and B
// (16 x N) MN-major (transposed), both in shared memory.  The accumulator
// of a thread (warp w of the warpgroup, lane = 4 g + t) holds rows 16 w + g
// and 16 w + g + 8, columns 8 j + 2 t + {0, 1}: d[4 j + 2 hr + e] is row
// 16 w + g + 8 hr, column 8 j + 2 t + e.
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_tn<128>(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tn<256>(float (&d)[128], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
}

// Rows [r_begin, r_end) of columns [col0, col0 + BN) written as bf16 zeros,
// 16 bytes a store (f % 8 == 0 and an aligned output on this path).
template <int BN>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* o, int r_begin, int r_end, int col0,
                                          int f, int tid, int threads) {
    constexpr int CHUNKS = BN / 8;
    const int n = (r_end - r_begin) * CHUNKS;
    for (int i = tid; i < n; i += threads) {
        const int r = r_begin + i / CHUNKS, c = col0 + (i % CHUNKS) * 8;
        if (c < f) *reinterpret_cast<uint4*>(o + (size_t)r * f + c) = make_uint4(0, 0, 0, 0);
    }
}

// One block per (column tile, row tile, expert) of 128 x BN outputs, the
// expert slowest, so that one expert's tiles run side by side and re-read
// its x and w from L2.  Warps 0-3 and 4-7 are the consumer warpgroups, one
// per 64-row half; warp 8 is the producer.
template <int BN, int ST, bool CENSUS>
__global__ void __launch_bounds__(TC_THREADS, TMA_MIN_BLOCKS)
gmm_tc_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tout, const int32_t* __restrict__ group_sizes,
              __nv_bfloat16* __restrict__ out, int C, int d, int f) {
    using L = TcLayout<BN, ST>;
    const int e = blockIdx.z;
    const int row0 = blockIdx.y * TBM;
    const int col0 = blockIdx.x * BN;
    const int g = min(max(group_sizes[e], 0), C);
    __nv_bfloat16* o = out + (size_t)e * C * f;

    if (row0 >= g) {  // tile wholly past the bin's occupancy: zeros, no loads
        if constexpr (CENSUS)
            if (threadIdx.x == 0) atomicAdd(&g_census[ZERO_TILES], 1ull);
        zero_rows<BN>(o, row0, min(row0 + TBM, C), col0, f, threadIdx.x, TC_THREADS);
        return;
    }
    const int halves = g - row0 > HALF ? 2 : 1;  // 64-row halves with a live row
    if constexpr (CENSUS)
        if (threadIdx.x == 0) {
            atomicAdd(&g_census[HALVES_COMPUTED], (unsigned long long)halves);
            atomicAdd(&g_census[HALVES_SKIPPED], (unsigned long long)(2 - halves));
        }

    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + L::BARS);
    uint64_t* empty = full + ST;
    if (threadIdx.x == 0) {
        for (int s = 0; s < ST; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * halves);  // a lane of each consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int nk = (d + TBK - 1) / TBK;
    const int warp = threadIdx.x >> 5;
    if (warp == 2 * WG / 32) {
        // ---- producer: one lane keeps the ring full ----
        if ((threadIdx.x & 31) != 0) return;
        // w boxes wholly past f are not copied: their columns are never stored
        const int boxes = min(BN / 64, (f - col0 + 63) / 64);
        const uint32_t bytes = (uint32_t)((halves + boxes) * BOX_BYTES);
        int stage = 0;
        uint32_t phase = 0;
        for (int t = 0; t < nk; ++t) {
            const int k0 = t * TBK;
            unsigned char* a = sm + L::A + stage * L::A_STAGE;
            unsigned char* b = sm + L::B + stage * L::B_STAGE;
            mbar_wait(&empty[stage], phase ^ 1u);
            mbar_expect_tx(&full[stage], bytes);
            for (int h = 0; h < halves; ++h)  // a half with no live row is not copied
                tma_load(a + h * BOX_BYTES, tx, &full[stage], k0, row0 + h * HALF, e);
            for (int j = 0; j < boxes; ++j)
                tma_load(b + j * BOX_BYTES, tw, &full[stage], col0 + 64 * j, k0, e);
            if (++stage == ST) {
                stage = 0;
                phase ^= 1u;
            }
        }
        return;
    }

    // ---- consumers: warpgroup c owns rows r0 .. r0 + 63 ----
    const int c = warp / 4, tid = threadIdx.x % WG;
    const int r0 = row0 + c * HALF;
    if (c >= halves) {  // no live row in this half: zeros, no wgmma
        zero_rows<BN>(o, r0, min(r0 + HALF, C), col0, f, tid, WG);
        return;
    }
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < nk; ++t) {
        const unsigned char* a = sm + L::A + stage * L::A_STAGE + c * BOX_BYTES;
        const unsigned char* b = sm + L::B + stage * L::B_STAGE;
        mbar_wait(&full[stage], phase);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < TBK / 16; ++kk)
            wgmma_tn<BN>(acc, sw128_desc(a + kk * 32, 0),
                         sw128_desc(b + kk * 16 * 128, BOX_BYTES), 1);
        wg_commit();
        wg_wait<0>();
        keep(acc);
        if ((tid & 31) == 0) mbar_arrive(&empty[stage]);
        if (++stage == ST) {
            stage = 0;
            phase ^= 1u;
        }
    }

    // The tile goes out through shared memory by TMA: output box j (64 rows
    // by 64 columns) is staged where this warpgroup's half of x stage j was,
    // which no other warpgroup reads and no copy writes any more, 128-byte
    // swizzled as the map reads it (conflict-free: a warp's 8 rows land in 8
    // different 16-byte chunks).  Rows past g are exact zeros, selected,
    // never multiplied by a mask; TMA leaves out rows past C and columns
    // past f.
    static_assert(ST * 64 >= BN, "an x half-box of its own for each output box");
    const int w4 = tid >> 5, gq = (tid & 31) >> 2, t4 = tid & 3;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int row = 16 * w4 + gq + 8 * hr;
        const bool live = r0 + row < g;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
            unsigned char* box = sm + L::A + (j / 8) * L::A_STAGE + c * BOX_BYTES;
            const int chunk = (j % 8) ^ (row & 7);
            *reinterpret_cast<__nv_bfloat162*>(box + row * 128 + chunk * 16 + t4 * 4) =
                __floats2bfloat162_rn(live ? acc[4 * j + 2 * hr] : 0.f,
                                      live ? acc[4 * j + 2 * hr + 1] : 0.f);
        }
    }
    fence_proxy_async();
    named_sync(1 + c, WG);
    if (tid == 0) {
        const int boxes = min(BN / 64, (f - col0 + 63) / 64);
        for (int j = 0; j < boxes; ++j)
            tma_store(sm + L::A + j * L::A_STAGE + c * BOX_BYTES, tout, col0 + 64 * j, r0, e);
        bulk_commit_and_wait_read();
    }
}

// The TMA tensor maps, encoded on the host per call by the driver's
// cuTensorMapEncodeTiled (found through the runtime, so the library links
// nothing but the runtime).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static const EncodeTiled fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
                cudaSuccess ||
            found != cudaDriverEntryPointSuccess)
            p = nullptr;
        return reinterpret_cast<EncodeTiled>(p);
    }();
    return fn;
}

// A contiguous (outer, mid, inner) bf16 array, read or written in boxes of
// 64 inner elements (128 bytes, swizzled by 128 bytes) by 64 mid rows of one
// outer index; coordinates (inner, mid, outer).  x and out are (E, C, d)
// and (E, C, f), w (E, d, f).
bool make_map(CUtensorMap* map, const void* base, int inner, int mid, int outer) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid, (cuuint64_t)outer};
    const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * mid * 2};
    const cuuint32_t box[3] = {64, 64, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What TMA can take: rows of whole 16-byte units (d, f multiples of 8) and
// 16-byte aligned arrays.  kernel.py's path() is the same rule.
bool tma_takes(int d, int f, const void* x, const void* w, const void* out) {
    return d > 0 && f > 0 && d % 8 == 0 && f % 8 == 0 && aligned16(x) && aligned16(w) &&
           aligned16(out);
}

template <bool CENSUS>
int launch_tc(const void* x, const void* w, const void* group_sizes, void* out, int E, int C,
              int d, int f, cudaStream_t st) {
    using L = TcLayout<TMA_BN, TMA_STAGES>;
    CUtensorMap tx, tw, tout;
    if (!make_map(&tx, x, d, C, E) || !make_map(&tw, w, f, d, E) ||
        !make_map(&tout, out, f, C, E))
        return ERR_TENSOR_MAP;
    auto kernel = gmm_tc_kernel<TMA_BN, TMA_STAGES, CENSUS>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((f + TMA_BN - 1) / TMA_BN, (C + TBM - 1) / TBM, E);
    kernel<<<grid, TC_THREADS, L::BYTES, st>>>(tx, tw, tout,
                                               static_cast<const int32_t*>(group_sizes),
                                               static_cast<__nv_bfloat16*>(out), C, d, f);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch, or
// a negative code of its own (gmm_error_string).
extern "C" int gmm_f32(const void* x, const void* w, const void* group_sizes,
                       void* out, int E, int C, int d, int f, void* stream) {
    return launch<float>(x, w, group_sizes, out, E, C, d, f, stream);
}

// bf16 on the SIMT kernel: the edge path, for what TMA cannot take.
extern "C" int gmm_bf16(const void* x, const void* w, const void* group_sizes,
                        void* out, int E, int C, int d, int f, void* stream) {
    if (census_on) ++simt_bf16_calls;
    return launch<__nv_bfloat16>(x, w, group_sizes, out, E, C, d, f, stream);
}

// bf16 on the tensor cores; refuses (ERR_NOT_TMA) what TMA cannot take.
extern "C" int gmm_bf16_tma(const void* x, const void* w, const void* group_sizes,
                            void* out, int E, int C, int d, int f, void* stream) {
    if (!tma_takes(d, f, x, w, out)) return ERR_NOT_TMA;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return census_on ? launch_tc<true>(x, w, group_sizes, out, E, C, d, f, st)
                     : launch_tc<false>(x, w, group_sizes, out, E, C, d, f, st);
}

// The tile census: copies the counts taken since the last call into
// counts[0..3] (tiles written as zeros, 64-row halves computed, halves
// skipped, bf16 calls on the SIMT path), zeroes them and turns counting on
// or off.  Synchronises with the device.
extern "C" int gmm_tile_census(int on, unsigned long long* counts) {
    cudaError_t err = cudaDeviceSynchronize();
    if (err == cudaSuccess) err = cudaMemcpyFromSymbol(counts, g_census, sizeof(g_census));
    static const unsigned long long zero[3] = {};
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_census, zero, sizeof(zero));
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    if (err != cudaSuccess) return static_cast<int>(err);
    counts[3] = simt_bf16_calls;
    simt_bf16_calls = 0;
    census_on = on != 0;
    return 0;
}

extern "C" const char* gmm_error_string(int code) {
    switch (code) {
        case ERR_TENSOR_MAP: return "TMA tensor map encoding failed";
        case ERR_NOT_TMA:
            return "shapes or pointers the TMA path cannot take (d, f multiples of 8, "
                   "16-byte aligned)";
        default: return cudaGetErrorString(static_cast<cudaError_t>(code));
    }
}
