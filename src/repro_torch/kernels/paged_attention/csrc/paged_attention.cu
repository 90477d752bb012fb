// Decode attention over the First-Fit paged KV cache, for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attention/kernel.py:_paged_attn_kernel, the
// Pallas TPU kernel behind paged_decode_attention.  It computes the same
// function as ref.paged_attention_ref, not the same blocks:
//   out[b, h*G + g, :] = softmax_t(q[b, h*G + g] . k[t] / sqrt(D)) @ v[t]
// over the tokens t < seq_lens[b] of sequence b (and t >= seq_lens[b] -
// window when window > 0: the sliding window of the JAX package's decode,
// layers.py:_decode_attention_local), where token t lives in
// slot t % page_size of page page_table[b, t / page_size] of the pools
// (num_pages, page_size, KVH, D), and G = H / KVH query heads share KV head
// h.  q, the pools and out are f32 or bf16; everything is computed in fp32
// and the result is rounded to the input type once, on store.
//
// Semantics the tests pin:
//   - a sequence of length 0 gives exactly 0 (its one split has l = 0 and
//     acc = 0, and the final division is by max(l, 1e-30));
//   - pages at or past ceil(seq_len / page_size) are never read, so what
//     unreferenced pages hold (stale values, NaN) cannot reach the output;
//   - a table entry of -1 inside the live range reads page 0, as the JAX
//     package does (entries are also clamped below num_pages, so no table
//     can make the kernel read outside the pools);
//   - tokens at or past seq_len in the last live page are masked (never
//     copied, never read);
//   - with a window, pages wholly before seq_len - window are never read;
//     the tokens before it on the window's first page are copied (they lie
//     under seq_len) and masked: their scores are -inf, their weights 0.
//
// Design: split-KV (flash-decoding) with the combine inside the kernel.
// The grid is (KV head, sequence, slot).  The host picks the chunk (whole
// pages whose K and V rows fit 36 KB) and the slots per (sequence, KV
// head) from the shapes alone (kernel.py:split_plan; it never reads
// seq_lens, so a decode step takes no host sync): four blocks planned per
// SM over all B*KVH pairs, of which three fit at once.  Each block reads
// its sequence's length itself, in place of the TPU's scalar prefetch,
// and takes its split: the sequence's live chunks dealt to the slots in
// contiguous runs of ceil(chunks / slots).  With a window the chunks start
// at the window's first page, max(len - window, 0) / page_size, and the
// host plans over the pages a window can touch, (window + page_size - 2) /
// page_size + 1, rather than the whole table.
//   - A slot past the sequence's splits returns at once and reads nothing;
//     slot 0 always runs, so a sequence of length 0 still writes its
//     (zero) output.
//   - A split walks its chunks in a two-buffer cp.async pipeline: the K and
//     V rows of a chunk's tokens under seq_len for this KV head, 16 bytes a
//     copy, the next chunk in flight while this one is computed (the loop
//     over chunks takes the place of the TPU kernel's sequential grid
//     axis).  Rows are padded by 16 bytes so that the 16-byte reads of
//     eight neighbouring rows fall on distinct banks.  Per chunk: each
//     thread scores a (head, token) pair over D with 16-byte reads; one
//     warp per head updates the online softmax (m, l) in fp32; each thread
//     accumulates p @ V for (head, column pair)s in registers.  The G query
//     heads that share the KV head read each K and V row from shared
//     memory, never again from device memory.  p stays fp32 in the PV
//     product: the TPU kernel rounds p to the value type there, the
//     reference does not, and this kernel follows the reference.
//   - A sequence with one split writes acc / l directly.  Otherwise each
//     split writes its fp32 partials (m, l, acc[G][D]) to the workspace,
//     then (after __threadfence) takes a ticket from an atomic counter of
//     its (sequence, KV head); the block that draws the last ticket resets
//     the counter to 0 and combines the partials in split order:
//     M = max m_s, out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s.
//     The order is fixed, so the result is the same bits whichever block
//     finishes last, and a call is one launch (no combine kernel).
//
// Bound.  The work is 4*H*D flops per live token against 2*KVH*D elements
// of K and V per live token: about 2 flops per byte in bf16, far below the
// H100's ~295, so the bound is the bytes of K and V of the live tokens.
// At the serving run's decode shape (B = 8, KVH = 8, 128-slot tables of
// 16-token pages, chip_smoke's lengths) the plan gives 4-page chunks and 8
// slots: 512 blocks, 74 KB of shared memory each.  On an NVIDIA H100 80GB
// HBM3 at 700 W the call takes about 0.031 ms (tools/kernel_ab.py) against
// a 0.0062 ms bound.  The time follows the longest sequence more than the
// bytes (tools/kernel_variants.py, device time: 27 us at phase 6's lengths,
// 35 us with every length at 1024, 61% more bytes, 3.3 us with every length
// at 0): a block walks up to three chunks, and loading and computing them
// barely overlap (PERF.md), so the next step is a shorter chain per block,
// not more bandwidth.
//
// Limits, checked by the Python wrapper: G <= 16, D <= 256, D % 8 == 0,
// and the shared memory of two chunks (their K and V rows, q, p, m, l)
// within 227 KB; a chunk holds at least one page.  ptxas (-Xptxas -v,
// CUDA 12.9): 80 registers in bf16, 74 in f32 (78 and 64 before the window), no
// spills.

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

// kernel.py:shared_bytes computes the same
size_t shared_bytes(int elem_bytes, int G, int D, int page_size, int chunk_pages) {
    const size_t ts = (size_t)chunk_pages * page_size;
    // two chunks of (K, V) rows; q, p, m, l, alpha in fp32; a flag
    return 4 * ts * row_stride(elem_bytes, D) * elem_bytes
         + ((size_t)G * D + (size_t)G * ts + 3 * (size_t)G) * 4 + 4;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int32_t* __restrict__ page_table,
                  const int32_t* __restrict__ seq_lens, T* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ counters,
                  int H, int KVH, int D, int num_pages, int page_size,
                  int max_pages, int chunk_pages, int window, float scale) {
    constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
    const int h = blockIdx.x;            // KV head
    const int b = blockIdx.y;            // sequence
    const int slot = blockIdx.z;         // split slot
    const int slots = gridDim.z;
    const int G = H / KVH;
    const int TS = chunk_pages * page_size;  // token slots of a chunk
    const int RS = D + VEC;                  // padded row stride in shared memory
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // this sequence's split: its live chunks, from the window's first page,
    // dealt to the slots in contiguous runs of `per`; split 0 always runs
    const int len = max(seq_lens[b], 0);
    const int n_live = min((len + page_size - 1) / page_size, max_pages);
    const int live = min(len, n_live * page_size);  // tokens of the live pages
    const int first = window > 0 ? max(len - window, 0) : 0;  // the window's first token
    const int p0 = min(first / page_size, n_live);            // ... and its page
    const int n_chunks = (n_live - p0 + chunk_pages - 1) / chunk_pages;
    const int per = (n_chunks + slots - 1) / slots;
    const int n_splits = per > 0 ? (n_chunks + per - 1) / per : 1;
    if (slot >= n_splits) return;  // past the live pages: nothing to read
    const int c0 = slot * per;
    const int n_stages = min(per, n_chunks - c0);  // this split's chunks

    extern __shared__ __align__(16) unsigned char smem[];
    const int stage_elems = TS * RS;
    T* kv_s = reinterpret_cast<T*>(smem);  // [stage][K | V][TS][RS]
    float* q_s = reinterpret_cast<float*>(smem + 4 * (size_t)stage_elems * sizeof(T));
    float* p_s = q_s + G * D;           // [G][TS] scores, then weights
    float* m_s = p_s + G * TS;          // [G] running max
    float* l_s = m_s + G;               // [G] running sum of weights
    float* a_s = l_s + G;               // [G] rescale of the accumulator
    int* last_s = reinterpret_cast<int*>(a_s + G);  // this block combines

    const int32_t* table = page_table + (size_t)b * max_pages;
    const size_t tok_stride = (size_t)KVH * D;  // elements between a page's tokens
    const size_t page_stride = (size_t)page_size * tok_stride;
    const int row_chunks = D / VEC;

    const int tok_p0 = p0 * page_size;  // chunk c0 + s starts at tok_p0 + (c0 + s) TS

    // start the copy of chunk c0 + s into buffer `buf`: the K and V rows of
    // its tokens under seq_len, 16 bytes a copy
    auto issue = [&](int s, int buf) {
        T* ks = kv_s + (size_t)(2 * buf) * stage_elems;
        T* vs = ks + stage_elems;
        const int tok0 = tok_p0 + (c0 + s) * TS;
        const int nt = min(TS, live - tok0);
        for (int c = tid; c < nt * row_chunks; c += THREADS) {
            const int t = c / row_chunks, col = (c - t * row_chunks) * VEC;
            const int i = (tok0 + t) / page_size;
            const int pg = min(max(__ldg(table + i), 0), num_pages - 1);
            const size_t src = (size_t)pg * page_stride
                             + (size_t)(tok0 + t - i * page_size) * tok_stride
                             + (size_t)h * D + col;
            __pipeline_memcpy_async(ks + t * RS + col, k_pool + src, 16);
            __pipeline_memcpy_async(vs + t * RS + col, v_pool + src, 16);
        }
        __pipeline_commit();
    };

    if (n_stages > 0) issue(0, 0);
    if (n_stages > 1) issue(1, 1);
    const T* qb = q + ((size_t)b * H + (size_t)h * G) * D;
    for (int e = tid; e < G * D; e += THREADS) q_s[e] = to_f32(qb[e]);
    for (int g = tid; g < G; g += THREADS) {
        m_s[g] = NEG_INF;
        l_s[g] = 0.f;
    }

    float acc[ACC];
#pragma unroll
    for (int j = 0; j < ACC; ++j) acc[j] = 0.f;

    for (int s = 0; s < n_stages; ++s) {
        const int buf = s & 1;
        if (s + 1 < n_stages) __pipeline_wait_prior(1);
        else __pipeline_wait_prior(0);
        __syncthreads();
        const T* ks = kv_s + (size_t)(2 * buf) * stage_elems;
        const T* vs = ks + stage_elems;
        const int tok0 = tok_p0 + (c0 + s) * TS;
        const int nt = min(TS, live - tok0);  // >= 1, one at least in the window

        // scores: one (head, token) pair per thread, 16-byte reads across D
        for (int e = tid; e < G * nt; e += THREADS) {
            const int g = e / nt, t = e - g * nt;
            const float* qg = q_s + g * D;
            const T* kt = ks + t * RS;
            float dot = 0.f;
            for (int c = 0; c < D; c += VEC) {
                float kv[VEC];
                load16(kt + c, kv);
#pragma unroll
                for (int i = 0; i < VEC; ++i) dot = fmaf(qg[c + i], kv[i], dot);
            }
            p_s[g * TS + t] = tok0 + t >= first ? dot * scale : NEG_INF;
        }
        __syncthreads();

        // online softmax: one warp per head, tokens across lanes
        for (int g = warp; g < G; g += WARPS) {
            float* pg = p_s + g * TS;
            const float m_old = m_s[g];
            float mx = NEG_INF;
            for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, pg[t]);
            const float m_new = fmaxf(m_old, warp_max(mx));
            float sum = 0.f;
            for (int t = lane; t < nt; t += 32) {
                const float p = expf(pg[t] - m_new);
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

        // acc = alpha * acc + p @ V over the chunk's tokens, each thread on
        // (head, column pair)s
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
                for (; t + 4 <= nt; t += 4) {
                    const float2 v0 = load2(vd + t * RS), v1 = load2(vd + (t + 1) * RS);
                    const float2 v2 = load2(vd + (t + 2) * RS), v3 = load2(vd + (t + 3) * RS);
                    x0 = fmaf(pg[t], v0.x, x0);     y0 = fmaf(pg[t], v0.y, y0);
                    x1 = fmaf(pg[t + 1], v1.x, x1); y1 = fmaf(pg[t + 1], v1.y, y1);
                    x2 = fmaf(pg[t + 2], v2.x, x2); y2 = fmaf(pg[t + 2], v2.y, y2);
                    x3 = fmaf(pg[t + 3], v3.x, x3); y3 = fmaf(pg[t + 3], v3.y, y3);
                }
                for (; t < nt; ++t) {
                    const float2 v = load2(vd + t * RS);
                    x0 = fmaf(pg[t], v.x, x0);
                    y0 = fmaf(pg[t], v.y, y0);
                }
                const float alpha = a_s[g];
                acc[2 * j] = fmaf(acc[2 * j], alpha, (x0 + x1) + (x2 + x3));
                acc[2 * j + 1] = fmaf(acc[2 * j + 1], alpha, (y0 + y1) + (y2 + y3));
            }
        }
        __syncthreads();  // the buffer is refilled next
        if (s + 2 < n_stages) issue(s + 2, buf);
    }

    T* ob = out + ((size_t)b * H + (size_t)h * G) * D;
    if (n_splits == 1) {  // the whole sequence in this block
#pragma unroll
        for (int j = 0; j < ACC / 2; ++j) {
            const int e = tid + j * THREADS;
            if (e < G * D / 2) {
                const float inv_l = 1.f / fmaxf(l_s[e / (D / 2)], 1e-30f);
                store2(ob + 2 * e, acc[2 * j] * inv_l, acc[2 * j + 1] * inv_l);
            }
        }
        return;
    }

    // partials of (sequence, KV head, split): acc [G][D], then (m, l) [G]
    const size_t bh = (size_t)b * KVH + h;
    float* ws_acc = ws + bh * slots * G * D;
    float* ws_ml = ws + (size_t)gridDim.y * KVH * slots * G * D + bh * slots * G * 2;
#pragma unroll
    for (int j = 0; j < ACC / 2; ++j) {
        const int e = tid + j * THREADS;
        if (e < G * D / 2)
            *reinterpret_cast<float2*>(ws_acc + (size_t)slot * G * D + 2 * e) =
                make_float2(acc[2 * j], acc[2 * j + 1]);
    }
    for (int g = tid; g < G; g += THREADS)
        *reinterpret_cast<float2*>(ws_ml + ((size_t)slot * G + g) * 2) =
            make_float2(m_s[g], l_s[g]);
    __threadfence();  // the partials are visible before the ticket is
    __syncthreads();
    if (tid == 0) *last_s = atomicAdd(counters + bh, 1) == n_splits - 1;
    __syncthreads();
    if (!*last_s) return;
    __threadfence();
    if (tid == 0) counters[bh] = 0;  // ready for the next call on this stream

    // the last block combines the splits' partials, in split order
#pragma unroll
    for (int j = 0; j < ACC / 2; ++j) {
        const int e = tid + j * THREADS;
        if (e < G * D / 2) {
            const int g = e / (D / 2);
            float M = NEG_INF;
#pragma unroll 4
            for (int s = 0; s < n_splits; ++s)
                M = fmaxf(M, __ldcg(ws_ml + ((size_t)s * G + g) * 2));
            float L = 0.f, x = 0.f, y = 0.f;
#pragma unroll 4
            for (int s = 0; s < n_splits; ++s) {
                const float2 ml = __ldcg(reinterpret_cast<const float2*>(
                    ws_ml + ((size_t)s * G + g) * 2));
                const float2 a = __ldcg(reinterpret_cast<const float2*>(
                    ws_acc + (size_t)s * G * D + 2 * e));
                const float wgt = expf(ml.x - M);
                L = fmaf(wgt, ml.y, L);
                x = fmaf(wgt, a.x, x);
                y = fmaf(wgt, a.y, y);
            }
            const float inv_l = 1.f / fmaxf(L, 1e-30f);
            store2(ob + 2 * e, x * inv_l, y * inv_l);
        }
    }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* page_table, const void* seq_lens, void* out, int B,
           int H, int KVH, int D, int num_pages, int page_size, int max_pages,
           float scale, int chunk_pages, int slots, int window, void* workspace,
           void* counters, void* stream) {
    const size_t smem = shared_bytes(sizeof(T), H / KVH, D, page_size, chunk_pages);
    auto kernel = paged_attn_kernel<T>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(KVH, B, slots);
    kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_table),
        static_cast<const int32_t*>(seq_lens), static_cast<T*>(out),
        static_cast<float*>(workspace), static_cast<int*>(counters), H, KVH, D,
        num_pages, page_size, max_pages, chunk_pages, window, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() after the launch.
// `workspace` holds B*KVH*slots*G*(D + 2) floats of partials and
// `counters` B*KVH ints that are 0 on entry and 0 again when the kernel
// ends; both may be null when slots == 1.  `window` > 0 attends to the
// last `window` tokens of each sequence only; 0 to all.
extern "C" int paged_attn_f32(const void* q, const void* k_pool, const void* v_pool,
                              const void* page_table, const void* seq_lens, void* out,
                              int B, int H, int KVH, int D, int num_pages,
                              int page_size, int max_pages, float scale,
                              int chunk_pages, int slots, int window, void* workspace,
                              void* counters, void* stream) {
    return launch<float>(q, k_pool, v_pool, page_table, seq_lens, out, B, H, KVH, D,
                         num_pages, page_size, max_pages, scale, chunk_pages,
                         slots, window, workspace, counters, stream);
}

extern "C" int paged_attn_bf16(const void* q, const void* k_pool, const void* v_pool,
                               const void* page_table, const void* seq_lens, void* out,
                               int B, int H, int KVH, int D, int num_pages,
                               int page_size, int max_pages, float scale,
                               int chunk_pages, int slots, int window, void* workspace,
                               void* counters, void* stream) {
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, seq_lens, out, B, H,
                                 KVH, D, num_pages, page_size, max_pages, scale,
                                 chunk_pages, slots, window, workspace, counters, stream);
}

extern "C" size_t paged_attn_shared_bytes(int elem_bytes, int G, int D, int page_size,
                                          int chunk_pages) {
    return shared_bytes(elem_bytes, G, D, page_size, chunk_pages);
}

extern "C" const char* paged_attn_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
