// Decode attention over the First-Fit paged KV cache, for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention/kernel.py:_paged_attn_kernel, the
// Pallas TPU kernel behind paged_decode_attention.  It computes the same
// function as ref.paged_attention_ref, not the same blocks:
//   out[b, h*G + g, :] = softmax_t(q[b, h*G + g] . k[t] / sqrt(D)) @ v[t]
// over the tokens t < seq_lens[b] of sequence b, where token t lives in
// slot t % page_size of page page_table[b, t / page_size] of the pools
// (num_pages, page_size, KVH, D), and G = H / KVH query heads share KV head
// h.  q, the pools and out are f32 or bf16; everything is computed in fp32
// and the result is rounded to the input type once, on store.
//
// Semantics the tests pin:
//   - a sequence of length 0 gives exactly 0 (l stays 0, acc stays 0, and
//     the final division is by max(l, 1e-30));
//   - pages at or past ceil(seq_len / page_size) are never read, so what
//     unreferenced pages hold (stale values, NaN) cannot reach the output;
//   - a table entry of -1 inside the live range reads page 0, as the JAX
//     package does (entries are also clamped below num_pages, so no table
//     can make the kernel read outside the pools);
//   - tokens at or past seq_len in the last live page are masked.
//
// Design.  One block per (KV head, sequence).  The block copies its own
// page-table row and reads its length, in place of the TPU's scalar
// prefetch, and a loop over the live pages takes the place of the TPU
// kernel's sequential grid axis.  The loop takes a stage of whole pages at a
// time (64 tokens: four 16-token pages), whose K and V rows for this KV head
// (4 KB per page each in bf16 at D = 128) are copied into shared memory with
// 16-byte cp.async copies, double-buffered so that the next stage is in
// flight while this one is computed.  Rows are padded by 16 bytes so that
// the 16-byte reads of eight neighbouring rows fall on distinct banks.  Per
// stage: each thread scores one (head, token) pair over D with 16-byte
// reads; the online-softmax state (m, l) is updated in fp32, one warp per
// head with the stage's tokens across its lanes; and the G x D output
// accumulator, in registers (at most 16 per thread, as column pairs), takes
// p @ V.  p stays fp32 in the PV product: the TPU kernel rounds p to the
// value type there, the reference does not, and this kernel follows the
// reference.
//
// Bound.  The work is 4*H*D flops per live token against 2*KVH*D elements
// of K and V per live token: about 2 flops per byte in bf16, far below the
// H100's ~295, so the kernel is bound by the bytes of K and V of the live
// tokens.  At the serving run's decode shape (B = 8 sequences, KVH = 8)
// there are only B*KVH = 64 blocks for 132 SMs, each walking its stages one
// after another, so most of the card idles; splitting each sequence's pages
// across blocks with a combine pass (flash-decoding) is later work.
//
// Limits, checked by the Python wrapper: G <= 16, D <= 256, D % 8 == 0,
// and the shared memory of two stages of K and V pages and the page-table
// row within 227 KB.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 16;
constexpr int MAX_D = 256;
constexpr int ACC = MAX_G * MAX_D / THREADS;  // output elements per thread, at most
constexpr int STAGE_TOKENS = 64;              // tokens per stage, at most
constexpr size_t STAGE_BUDGET = 128 * 1024;   // shared bytes of both stages' K and V
constexpr float NEG_INF = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// 16 bytes of shared memory as fp32 values
__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    out[0] = u.x; out[1] = u.y; out[2] = u.z; out[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&out)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

// two neighbouring elements as fp32, and back
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// row stride in shared memory: D plus 16 bytes
int row_stride(int elem_bytes, int D) { return D + 16 / elem_bytes; }

// whole pages per stage: up to STAGE_TOKENS tokens, within STAGE_BUDGET
int pages_per_stage(int elem_bytes, int D, int page_size) {
    int tokens = (int)(STAGE_BUDGET / (4 * (size_t)row_stride(elem_bytes, D) * elem_bytes));
    if (tokens > STAGE_TOKENS) tokens = STAGE_TOKENS;
    const int pages = tokens / page_size;
    return pages > 0 ? pages : 1;
}

size_t shared_bytes(int elem_bytes, int G, int D, int page_size, int max_pages) {
    const size_t ts = (size_t)pages_per_stage(elem_bytes, D, page_size) * page_size;
    // two stages of (K, V); q, p, m, l, alpha in fp32; the page-table row
    return 4 * ts * row_stride(elem_bytes, D) * elem_bytes
         + ((size_t)G * D + (size_t)G * ts + 3 * (size_t)G) * 4 + (size_t)max_pages * 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int32_t* __restrict__ page_table,
                  const int32_t* __restrict__ seq_lens, T* __restrict__ out,
                  int H, int KVH, int D, int num_pages, int page_size,
                  int max_pages, int pps, float scale) {
    constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
    const int h = blockIdx.x;            // KV head
    const int b = blockIdx.y;            // sequence
    const int G = H / KVH;
    const int TS = pps * page_size;      // tokens per stage
    const int RS = D + VEC;              // padded row stride in shared memory
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    extern __shared__ __align__(16) unsigned char smem[];
    const int stage_elems = TS * RS;
    T* kv_s = reinterpret_cast<T*>(smem);  // [stage][K | V][TS][RS]
    float* q_s = reinterpret_cast<float*>(smem + 4 * (size_t)stage_elems * sizeof(T));
    float* p_s = q_s + G * D;           // [G][TS] scores, then weights
    float* m_s = p_s + G * TS;          // [G] running max
    float* l_s = m_s + G;               // [G] running denominator
    float* a_s = l_s + G;               // [G] rescale of the accumulator
    int* pages_s = reinterpret_cast<int*>(a_s + G);  // [n_live] page indices

    const int len = max(seq_lens[b], 0);
    const int n_live = min((len + page_size - 1) / page_size, max_pages);
    const int n_stages = (n_live + pps - 1) / pps;
    const int live = min(len, n_live * page_size);  // tokens of the live pages
    const T* qb = q + ((size_t)b * H + (size_t)h * G) * D;
    for (int e = tid; e < G * D; e += THREADS) q_s[e] = to_f32(qb[e]);
    for (int g = tid; g < G; g += THREADS) {
        m_s[g] = NEG_INF;
        l_s[g] = 0.f;
    }
    const int32_t* table = page_table + (size_t)b * max_pages;
    for (int i = tid; i < n_live; i += THREADS) {
        const int pg = table[i];
        pages_s[i] = pg < 0 ? 0 : (pg >= num_pages ? num_pages - 1 : pg);
    }
    __syncthreads();

    const size_t tok_stride = (size_t)KVH * D;  // elements between a page's tokens
    const size_t page_stride = (size_t)page_size * tok_stride;
    const int row_chunks = D / VEC;

    // start the copy of stage s (pages s*pps ...) into buffer `buf`; pages
    // past the live range are never read
    auto issue = [&](int s, int buf) {
        T* ks = kv_s + (size_t)(2 * buf) * stage_elems;
        T* vs = ks + stage_elems;
        const int t_end = min(TS, (n_live - s * pps) * page_size);
        for (int c = tid; c < t_end * row_chunks; c += THREADS) {
            const int t = c / row_chunks, col = (c - t * row_chunks) * VEC;
            const int i = s * pps + t / page_size;
            const size_t src = (size_t)pages_s[i] * page_stride
                             + (size_t)(t - (t / page_size) * page_size) * tok_stride
                             + (size_t)h * D + col;
            __pipeline_memcpy_async(ks + t * RS + col, k_pool + src, 16);
            __pipeline_memcpy_async(vs + t * RS + col, v_pool + src, 16);
        }
        __pipeline_commit();
    };

    float acc[ACC];
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

    if (n_stages > 0) issue(0, 0);
    for (int s = 0; s < n_stages; ++s) {
        const int buf = s & 1;
        if (s + 1 < n_stages) {
            issue(s + 1, buf ^ 1);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncthreads();
        const T* ks = kv_s + (size_t)(2 * buf) * stage_elems;
        const T* vs = ks + stage_elems;
        const int valid = min(TS, live - s * TS);  // >= 1; the rest is masked

        // scores: one (head, token) pair per thread, 16-byte reads across D
        for (int e = tid; e < G * TS; e += THREADS) {
            const int g = e / TS, t = e - g * TS;
            float sc = NEG_INF;
            if (t < valid) {
                const float* qg = q_s + g * D;
                const T* kt = ks + t * RS;
                float dot = 0.f;
                for (int c = 0; c < D; c += VEC) {
                    float kv[VEC];
                    load16(kt + c, kv);
#pragma unroll
                    for (int i = 0; i < VEC; ++i) dot = fmaf(qg[c + i], kv[i], dot);
                }
                sc = dot * scale;
            }
            p_s[e] = sc;
        }
        __syncthreads();

        // online softmax: one warp per head, tokens across lanes; masked
        // tokens weigh exactly 0
        for (int g = warp; g < G; g += WARPS) {
            float* pg = p_s + g * TS;
            const float m_old = m_s[g];
            float mx = NEG_INF;
            for (int t = lane; t < valid; t += 32) mx = fmaxf(mx, pg[t]);
            const float m_new = fmaxf(m_old, warp_max(mx));
            float sum = 0.f;
            for (int t = lane; t < TS; t += 32) {
                const float p = t < valid ? expf(pg[t] - m_new) : 0.f;
                pg[t] = p;
                sum += p;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                l_s[g] = alpha * l_s[g] + sum;
                m_s[g] = m_new;
                a_s[g] = alpha;
            }
        }
        __syncthreads();

        // acc = alpha * acc + p @ V over the stage's valid tokens, each
        // thread on (head, column pair)s
#pragma unroll
        for (int j = 0; j < ACC / 2; ++j) {
            const int e = tid + j * THREADS;
            if (e < G * D / 2) {
                const int g = e / (D / 2), d = 2 * (e - g * (D / 2));
                const float* pg = p_s + g * TS;
                const T* vd = vs + d;
                float x0 = 0.f, y0 = 0.f, x1 = 0.f, y1 = 0.f;
                float x2 = 0.f, y2 = 0.f, x3 = 0.f, y3 = 0.f;
                int t = 0;
                for (; t + 4 <= valid; t += 4) {
                    const float2 v0 = load2(vd + t * RS), v1 = load2(vd + (t + 1) * RS);
                    const float2 v2 = load2(vd + (t + 2) * RS), v3 = load2(vd + (t + 3) * RS);
                    x0 = fmaf(pg[t], v0.x, x0);     y0 = fmaf(pg[t], v0.y, y0);
                    x1 = fmaf(pg[t + 1], v1.x, x1); y1 = fmaf(pg[t + 1], v1.y, y1);
                    x2 = fmaf(pg[t + 2], v2.x, x2); y2 = fmaf(pg[t + 2], v2.y, y2);
                    x3 = fmaf(pg[t + 3], v3.x, x3); y3 = fmaf(pg[t + 3], v3.y, y3);
                }
                for (; t < valid; ++t) {
                    const float2 v = load2(vd + t * RS);
                    x0 = fmaf(pg[t], v.x, x0);
                    y0 = fmaf(pg[t], v.y, y0);
                }
                const float alpha = a_s[g];
                acc[2 * j] = fmaf(acc[2 * j], alpha, (x0 + x1) + (x2 + x3));
                acc[2 * j + 1] = fmaf(acc[2 * j + 1], alpha, (y0 + y1) + (y2 + y3));
            }
        }
        __syncthreads();  // the buffer is refilled on the next iteration
    }

    T* ob = out + ((size_t)b * H + (size_t)h * G) * D;
#pragma unroll
    for (int j = 0; j < ACC / 2; ++j) {
        const int e = tid + j * THREADS;
        if (e < G * D / 2) {
            const int g = e / (D / 2);
            const float inv_l = 1.f / fmaxf(l_s[g], 1e-30f);
            store2(ob + 2 * e, acc[2 * j] * inv_l, acc[2 * j + 1] * inv_l);
        }
    }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* seq_lens, void* out, int B,
           int H, int KVH, int D, int num_pages, int page_size, int max_pages,
           float scale, void* stream) {
    const int pps = pages_per_stage(sizeof(T), D, page_size);
    const size_t smem = shared_bytes(sizeof(T), H / KVH, D, page_size, max_pages);
    auto kernel = paged_attn_kernel<T>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(KVH, B);
    kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_table),
        static_cast<const int32_t*>(seq_lens), static_cast<T*>(out), H, KVH, D,
        num_pages, page_size, max_pages, pps, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int paged_attn_f32(const void* q, const void* k_pool, const void* v_pool,
                              const void* page_table, const void* seq_lens, void* out,
                              int B, int H, int KVH, int D, int num_pages,
                              int page_size, int max_pages, float scale, void* stream) {
    return launch<float>(q, k_pool, v_pool, page_table, seq_lens, out, B, H, KVH, D,
                         num_pages, page_size, max_pages, scale, stream);
}

extern "C" int paged_attn_bf16(const void* q, const void* k_pool, const void* v_pool,
                               const void* page_table, const void* seq_lens, void* out,
                               int B, int H, int KVH, int D, int num_pages,
                               int page_size, int max_pages, float scale, void* stream) {
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, seq_lens, out, B, H,
                                 KVH, D, num_pages, page_size, max_pages, scale, stream);
}

extern "C" size_t paged_attn_shared_bytes(int elem_bytes, int G, int D, int page_size,
                                          int max_pages) {
    return shared_bytes(elem_bytes, G, D, page_size, max_pages);
}

extern "C" const char* paged_attn_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
