// Packed flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces repro/kernels/packed_attention/kernel.py:_attn_kernel, the Pallas
// TPU kernel behind packed_flash_attention, and computes the gradient that
// jax.grad takes of the JAX package's chunked flash path
// (repro/models/layers.py:_flash_q_chunk), which the Pallas kernel lacks.
// The function is ref.packed_attention_ref's, in the model's layout:
//   out[b, i, h, :] = sum_j P[i, j] v[b, j, h / G, :],
//   P[i, :] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(D)) over the keys j
// with seg_q[b, i] == seg_kv[b, j] != 0, j <= i (causal) and i - j < window
// (window > 0), where G = H / KVH query heads share a KV head.  q, out, dq
// are (B, Sq, H, D); k, v, dk, dv are (B, Skv, KVH, D); the segment ids are
// (B, S) int32.  Inputs and outputs are bf16 (the training and serving
// dtype); softmax statistics, masks and every sum are fp32.
//
// Semantics the tests pin (those of the Pallas kernel and of jax.grad):
//   - a query row with no visible key (segment 0, or alone in a window that
//     holds nothing) gives exactly 0, and its dq is 0;
//   - keys of segment 0 get dk = dv = 0; no key is seen across segments;
//   - p is rounded to the value type before P.V (kernel.py:105), and the
//     row sum l takes the unrounded p; the scale is 1/sqrt(D) and masked
//     scores are -0.7 x FLT_MAX, as in the Pallas kernel;
//   - ragged lengths need no padding: rows past Sq or Skv read as zeros of
//     segment 0 and are never written.
//
// Design.  Tiles of 64 query rows by 64 key rows, 128 threads a block, the
// products on the tensor cores (mma.sync, bf16 operands, fp32 sums).
//   - Forward: one block per (query tile, head, row of the batch), a loop
//     over the key tiles that can matter: from the window's first tile to
//     the causal diagonal.  A tile whose nonzero segment ids do not overlap
//     the query tile's is skipped before it is loaded: it would leave
//     (m, l, acc) exactly as they are.  Packed rows hold their documents in
//     order, so this skips most of the causal triangle.  (m, l, acc) stay in
//     registers; each row's logsumexp m + log(l) is written for the
//     backward, +inf for a row with no visible key.
//   - Backward (FlashAttention-2's recomputation, deterministic, no
//     atomics): a small kernel takes delta = rowsum(dO * O) in fp32; one
//     block per (key tile, KV head, row) loops over the query tiles that can
//     see it and over the G query heads of its KV head, recomputes
//     P = exp(S - lse) under the same mask and accumulates dV += P^T dO and
//     dK += dS^T Q with dS = P * (dO V^T - delta), all in registers; one
//     block per (query tile, head, row) accumulates dQ = dS K the same way.
//     Both skip tiles as the forward does.  P and dS are rounded to bf16 as
//     the operands of dV, dK and dQ's products.
//
// Bound.  The work is 4 D flops per visible (query, key) pair and head
// forward, and 10 D backward (S recomputed, dP, dV, dK, dQ),
// against 2 (H + 2 KVH) D elements of q, k, v and out per token.  With
// documents of hundreds of tokens that is hundreds of flops per byte, at or
// above the H100's bf16 ridge of 295: the kernels are bound by operations.
// mma.sync reaches only part of the tensor cores' 989 TFLOP/s; wgmma with
// TMA-fed, warp-specialised pipelines is the next step.
//
// Limits, checked by the Python wrapper: bf16 only; D in {16, 32, 64, 128};
// the pointers 16-byte aligned; segment ids >= 0 (the tile skip compares
// their ranges).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // key rows per tile
constexpr int MMA_THREADS = 128;
constexpr int DELTA_THREADS = 256;
constexpr float NEG_INF = -0.7f * FLT_MAX;

// 64 values of a per-row vector (segment ids, lse, delta); past n: fill.
template <typename V>
__device__ __forceinline__ void load_row(V* dst, const V* src, int row0, int n, V fill) {
    if (threadIdx.x < 64)
        dst[threadIdx.x] = row0 + (int)threadIdx.x < n ? src[row0 + threadIdx.x] : fill;
}

// The range [lo, hi] of the nonzero ids among 64 (hi = 0 if there is none).
// Every warp computes it, so no barrier is needed after.
__device__ __forceinline__ void seg_range(const int* seg, int& lo, int& hi) {
    const int lane = threadIdx.x & 31;
    const int a = seg[lane], b = seg[lane + 32];
    lo = min(a ? a : INT_MAX, b ? b : INT_MAX);
    hi = max(a, b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
}

__device__ __forceinline__ bool disjoint(int alo, int ahi, int blo, int bhi) {
    return ahi == 0 || bhi == 0 || ahi < blo || bhi < alo;
}

__device__ __forceinline__ bool visible(int qi, int kj, int sq, int sk, int causal,
                                        int window) {
    return sk != 0 && sk == sq && (!causal || qi >= kj) && (window <= 0 || qi - kj < window);
}

// The key tiles a query tile starting at q0 can see.
__device__ __forceinline__ void key_tiles(int q0, int Skv, int causal, int window,
                                          int& begin, int& end) {
    end = (Skv + BK - 1) / BK;
    if (causal) end = min(end, (q0 + BQ - 1) / BK + 1);
    const int lo = q0 - window + 1;  // first key the tile's first query sees
    begin = (window > 0 && lo > 0) ? lo / BK : 0;
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks: mma.sync m16n8k16, bf16 operands, fp32 sums
// ---------------------------------------------------------------------------
//
// Each warp owns 16 rows of the 64-row tile (queries in the forward and in
// dQ, keys in dK/dV).  Tiles stay bf16 in shared memory, rows padded by 16
// bytes; an mma accumulator holds, per thread, rows g = lane / 4 and g + 8
// and columns 2 (lane % 4) + {0, 1} of an 8-column tile, so a row's
// statistics reduce over the 4 lanes of a quad.  Score tiles turn into the
// A operand of the next product in registers (the m16n8 accumulators of two
// neighbouring column tiles are one m16k16 A fragment), rounded to bf16 on
// the way: p for P.V as the Pallas kernel does, and P and dS for the
// backward's products.

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of two neighbouring 8-column tiles of M^T, where M is a
// (rows, LD) bf16 tile and the product runs over its rows k0 .. k0 + 15:
// (b0, b1) for columns col0 .. col0 + 7 and (b2, b3) for the next 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& b0, uint32_t& b1, uint32_t& b2,
                                              uint32_t& b3, const __nv_bfloat16* M,
                                              int LD, int k0, int col0) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
    const __nv_bfloat16* p = M + (k0 + (mi & 1) * 8 + r) * LD + col0 + (mi >> 1) * 8;
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3) : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment (rows r0 .. r0 + 15, columns c0 .. c0 + 15) of a row-major
// (rows, LD) bf16 tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* T, int LD,
                                       int r0, int c0) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    a[0] = ld32(T + (r0 + g) * LD + c0 + 2 * t);
    a[1] = ld32(T + (r0 + g + 8) * LD + c0 + 2 * t);
    a[2] = ld32(T + (r0 + g) * LD + c0 + 8 + 2 * t);
    a[3] = ld32(T + (r0 + g + 8) * LD + c0 + 8 + 2 * t);
}

// acc[j] (16 x 8, j < 8) += A[r0 .. r0+15, :] . B[8j .. 8j+7, :]^T over D,
// for row-major (64, LD) bf16 tiles A and B: a 16 x 64 score tile.
template <int D>
__device__ __forceinline__ void score_tile(float (&acc)[8][4], const __nv_bfloat16* A,
                                           const __nv_bfloat16* B, int r0) {
    constexpr int LD = D + 8;
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[4];
        load_a(a, A, LD, r0, kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const __nv_bfloat16* b = B + (8 * j + g) * LD + kk + 2 * t;
            mma_bf16(acc[j], a, ld32(b), ld32(b + 8));
        }
    }
}

// out[n] (16 x 8, n < D/8) += P . M over the 64 rows of M, where P is a
// 16 x 64 tile held as accumulators p[8][4] and M a row-major (64, LD)
// bf16 tile.
template <int D>
__device__ __forceinline__ void mix_mma(float (&out)[D / 8][4], const float (&p)[8][4],
                                        const __nv_bfloat16* M) {
    constexpr int LD = D + 8;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // rows 16k .. 16k + 15 of M
        const uint32_t a[4] = {
            pack_bf16(p[2 * k][0], p[2 * k][1]), pack_bf16(p[2 * k][2], p[2 * k][3]),
            pack_bf16(p[2 * k + 1][0], p[2 * k + 1][1]),
            pack_bf16(p[2 * k + 1][2], p[2 * k + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 8; n += 2) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_trans(b0, b1, b2, b3, M, LD, 16 * k, 8 * n);
            mma_bf16(out[n], a, b0, b1);
            mma_bf16(out[n + 1], a, b2, b3);
        }
    }
}

// Rows row0 .. row0 + 63 of one head into a (64, D + 8) bf16 tile; rows at
// or past n_rows are 0.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int n_rows, long row_stride) {
    constexpr int CHUNKS = D / 8;
    for (int i = threadIdx.x; i < 64 * CHUNKS; i += MMA_THREADS) {
        const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < n_rows)
            v = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * row_stride + c);
        *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
    }
}

template <int D> constexpr size_t mma_tile_bytes() { return sizeof(__nv_bfloat16) * 64 * (D + 8); }
template <int D> constexpr size_t fwd_mma_smem() {
    return 3 * mma_tile_bytes<D>() + 2 * 64 * sizeof(int);
}
template <int D> constexpr size_t bwd_mma_smem() {
    return 4 * mma_tile_bytes<D>() + 2 * 64 * sizeof(int) + 2 * 64 * sizeof(float);
}

// ---------------------------------------------------------------------------
// Forward
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
packed_attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                           __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                           int Sq, int Skv, int H, int KVH, int causal, int window,
                           float scale) {
    constexpr int LD = D + 8, NT = D / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Ks = Qs + 64 * LD;
    __nv_bfloat16* Vs = Ks + 64 * LD;
    int* segq_s = reinterpret_cast<int*>(Vs + 64 * LD);
    int* segk_s = segq_s + 64;

    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / (H / KVH);
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int r0 = 16 * warp;  // the warp's rows of the tile
    const long q_rs = (long)H * D, kv_rs = (long)KVH * D;
    const __nv_bfloat16* qb = q + (long)b * Sq * q_rs + (long)h * D;
    const __nv_bfloat16* kb = k + (long)b * Skv * kv_rs + (long)kh * D;
    const __nv_bfloat16* vb = v + (long)b * Skv * kv_rs + (long)kh * D;

    load_tile_bf16<D>(Qs, qb, q0, Sq, q_rs);
    load_row<int>(segq_s, seg_q + (long)b * Sq, q0, Sq, 0);
    __syncthreads();
    int qlo, qhi;
    seg_range(segq_s, qlo, qhi);
    const int segrow[2] = {segq_s[r0 + g], segq_s[r0 + g + 8]};
    const int qi[2] = {q0 + r0 + g, q0 + r0 + g + 8};

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    int kt_begin, kt_end;
    key_tiles(q0, Skv, causal, window, kt_begin, kt_end);
    if (qhi == 0) kt_end = kt_begin;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        load_row<int>(segk_s, seg_kv + (long)b * Skv, k0, Skv, 0);
        __syncthreads();
        int klo, khi;
        seg_range(segk_s, klo, khi);
        if (disjoint(qlo, qhi, klo, khi)) continue;
        load_tile_bf16<D>(Ks, kb, k0, Skv, kv_rs);
        load_tile_bf16<D>(Vs, vb, k0, Skv, kv_rs);
        __syncthreads();

        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        score_tile<D>(s, Qs, Ks, r0);
        float mx[2] = {NEG_INF, NEG_INF};
        uint32_t okbits = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j_col = 8 * j + 2 * t + (e & 1), hr = e >> 1;
                const bool ok = visible(qi[hr], k0 + j_col, segrow[hr], segk_s[j_col],
                                        causal, window);
                okbits |= (uint32_t)ok << (4 * j + e);
                s[j][e] = ok ? s[j][e] * scale : NEG_INF;
                mx[hr] = fmaxf(mx[hr], s[j][e]);
            }
        float alpha[2], sum[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float x = mx[hr];
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
            m_new[hr] = fmaxf(m[hr], x);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hr = e >> 1;
                const float p = (okbits >> (4 * j + e)) & 1u ? expf(s[j][e] - m_new[hr]) : 0.f;
                sum[hr] += p;
                s[j][e] = p;
            }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float x = sum[hr];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            alpha[hr] = expf(m[hr] - m_new[hr]);
            l[hr] = alpha[hr] * l[hr] + x;
            m[hr] = m_new[hr];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            acc[n][0] *= alpha[0];
            acc[n][1] *= alpha[0];
            acc[n][2] *= alpha[1];
            acc[n][3] *= alpha[1];
        }
        mix_mma<D>(acc, s, Vs);
    }

    __nv_bfloat16* ob = out + (long)b * Sq * q_rs + (long)h * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        if (qi[hr] >= Sq) continue;
        const float lm = fmaxf(l[hr], 1e-30f);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            *reinterpret_cast<uint32_t*>(ob + (long)qi[hr] * q_rs + 8 * n + 2 * t) =
                pack_bf16(acc[n][2 * hr] / lm, acc[n][2 * hr + 1] / lm);
        }
        if (t == 0)
            lse[((long)b * H + h) * Sq + qi[hr]] = l[hr] > 0.f ? m[hr] + logf(l[hr]) : INFINITY;
    }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32; a warp per row.
__global__ void __launch_bounds__(DELTA_THREADS)
packed_attn_delta_kernel(const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         float* __restrict__ delta, int B, int Sq, int H, int D) {
    const long row = (long)blockIdx.x * (DELTA_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= (long)B * Sq * H) return;
    const __nv_bfloat16* ob = o + row * D;
    const __nv_bfloat16* gb = dout + row * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
        s = fmaf(__bfloat162float(gb[d]), __bfloat162float(ob[d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
        const int h = (int)(row % H);
        const long bi = row / H;
        const int i = (int)(bi % Sq);
        const long b = bi / Sq;
        delta[(b * H + h) * Sq + i] = s;
    }
}

// P and dS of a 16 x 64 tile: rows are the warp's rows of the tile, where
// row_is_query says whether they are queries (dQ) or keys (dK/dV); columns
// the other side's 64.  s holds the scores, dp the dO . V products; on
// return s holds P and dp holds dS.
__device__ __forceinline__ void p_and_ds(float (&s)[8][4], float (&dp)[8][4],
                                         bool row_is_query, int row_abs0, int col_abs0,
                                         const int* seg_rows, const int* seg_cols,
                                         const float* lse_s, const float* delta_s,
                                         int r0, int causal, int window, float scale) {
    const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = r0 + g + 8 * (e >> 1), col = 8 * j + 2 * t + (e & 1);
            const int qrow = row_is_query ? row : col, krow = row_is_query ? col : row;
            const int qi = (row_is_query ? row_abs0 : col_abs0) + qrow;
            const int kj = (row_is_query ? col_abs0 : row_abs0) + krow;
            const int sq = row_is_query ? seg_rows[row] : seg_cols[col];
            const int sk = row_is_query ? seg_cols[col] : seg_rows[row];
            const bool ok = visible(qi, kj, sq, sk, causal, window);
            const float p = ok ? expf(s[j][e] * scale - lse_s[qrow]) : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta_s[qrow]);
        }
}

// One block per (key tile, KV head, row): dK and dV of its 64 keys.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
packed_attn_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                            int Sq, int Skv, int H, int KVH, int causal, int window,
                            float scale) {
    constexpr int LD = D + 8, NT = D / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* Vs = Ks + 64 * LD;
    __nv_bfloat16* Qs = Vs + 64 * LD;
    __nv_bfloat16* dOs = Qs + 64 * LD;
    int* segk_s = reinterpret_cast<int*>(dOs + 64 * LD);
    int* segq_s = segk_s + 64;
    float* lse_s = reinterpret_cast<float*>(segq_s + 64);
    float* delta_s = lse_s + 64;

    const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
    const int G = H / KVH;
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int r0 = 16 * warp;  // the warp's keys of the tile
    const long q_rs = (long)H * D, kv_rs = (long)KVH * D;
    const long kv_off = (long)b * Skv * kv_rs + (long)kh * D;

    load_tile_bf16<D>(Ks, k + kv_off, k0, Skv, kv_rs);
    load_tile_bf16<D>(Vs, v + kv_off, k0, Skv, kv_rs);
    load_row<int>(segk_s, seg_kv + (long)b * Skv, k0, Skv, 0);
    __syncthreads();
    int klo, khi;
    seg_range(segk_s, klo, khi);

    float gk[NT][4], gv[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;

    int qt_begin = causal ? k0 / BQ : 0;
    int qt_end = (Sq + BQ - 1) / BQ;
    if (window > 0) qt_end = min(qt_end, (k0 + BK - 1 + window - 1) / BQ + 1);
    if (khi == 0) qt_end = qt_begin;

    for (int qt = qt_begin; qt < qt_end; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();
        load_row<int>(segq_s, seg_q + (long)b * Sq, q0, Sq, 0);
        __syncthreads();
        int qlo, qhi;
        seg_range(segq_s, qlo, qhi);
        if (disjoint(qlo, qhi, klo, khi)) continue;
        for (int hg = 0; hg < G; ++hg) {
            const int h = kh * G + hg;
            const long q_off = (long)b * Sq * q_rs + (long)h * D;
            const long r_off = ((long)b * H + h) * Sq;
            __syncthreads();
            load_tile_bf16<D>(Qs, q + q_off, q0, Sq, q_rs);
            load_tile_bf16<D>(dOs, dout + q_off, q0, Sq, q_rs);
            load_row<float>(lse_s, lse + r_off, q0, Sq, INFINITY);
            load_row<float>(delta_s, delta + r_off, q0, Sq, 0.f);
            __syncthreads();
            // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys
            float s[8][4], dp[8][4];
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
            score_tile<D>(s, Ks, Qs, r0);
            score_tile<D>(dp, Vs, dOs, r0);
            p_and_ds(s, dp, false, k0, q0, segk_s, segq_s, lse_s, delta_s, r0, causal,
                     window, scale);
            mix_mma<D>(gv, s, dOs);   // dV += P^T dO
            mix_mma<D>(gk, dp, Qs);   // dK += dS^T Q
        }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int kj = k0 + r0 + g + 8 * hr;
        if (kj >= Skv) continue;
        const long off = kv_off + (long)kj * kv_rs;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
            *reinterpret_cast<uint32_t*>(dk + off + 8 * n + 2 * t) =
                pack_bf16(gk[n][2 * hr] * scale, gk[n][2 * hr + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + off + 8 * n + 2 * t) =
                pack_bf16(gv[n][2 * hr], gv[n][2 * hr + 1]);
        }
    }
}

// One block per (query tile, head, row): dQ of its 64 queries.
template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
packed_attn_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KVH,
                          int causal, int window, float scale) {
    constexpr int LD = D + 8, NT = D / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* dOs = Qs + 64 * LD;
    __nv_bfloat16* Ks = dOs + 64 * LD;
    __nv_bfloat16* Vs = Ks + 64 * LD;
    int* segq_s = reinterpret_cast<int*>(Vs + 64 * LD);
    int* segk_s = segq_s + 64;
    float* lse_s = reinterpret_cast<float*>(segk_s + 64);
    float* delta_s = lse_s + 64;

    const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / (H / KVH);
    const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
    const int r0 = 16 * warp;
    const long q_rs = (long)H * D, kv_rs = (long)KVH * D;
    const long q_off = (long)b * Sq * q_rs + (long)h * D;
    const long kv_off = (long)b * Skv * kv_rs + (long)kh * D;
    const long r_off = ((long)b * H + h) * Sq;

    load_tile_bf16<D>(Qs, q + q_off, q0, Sq, q_rs);
    load_tile_bf16<D>(dOs, dout + q_off, q0, Sq, q_rs);
    load_row<int>(segq_s, seg_q + (long)b * Sq, q0, Sq, 0);
    load_row<float>(lse_s, lse + r_off, q0, Sq, INFINITY);
    load_row<float>(delta_s, delta + r_off, q0, Sq, 0.f);
    __syncthreads();
    int qlo, qhi;
    seg_range(segq_s, qlo, qhi);

    float gq[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) gq[n][0] = gq[n][1] = gq[n][2] = gq[n][3] = 0.f;

    int kt_begin, kt_end;
    key_tiles(q0, Skv, causal, window, kt_begin, kt_end);
    if (qhi == 0) kt_end = kt_begin;

    for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        load_row<int>(segk_s, seg_kv + (long)b * Skv, k0, Skv, 0);
        __syncthreads();
        int klo, khi;
        seg_range(segk_s, klo, khi);
        if (disjoint(qlo, qhi, klo, khi)) continue;
        load_tile_bf16<D>(Ks, k + kv_off, k0, Skv, kv_rs);
        load_tile_bf16<D>(Vs, v + kv_off, k0, Skv, kv_rs);
        __syncthreads();
        float s[8][4], dp[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        score_tile<D>(s, Qs, Ks, r0);
        score_tile<D>(dp, dOs, Vs, r0);
        p_and_ds(s, dp, true, q0, k0, segq_s, segk_s, lse_s, delta_s, r0, causal, window,
                 scale);
        mix_mma<D>(gq, dp, Ks);  // dQ += dS K
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int qi = q0 + r0 + g + 8 * hr;
        if (qi >= Sq) continue;
#pragma unroll
        for (int n = 0; n < NT; ++n)
            *reinterpret_cast<uint32_t*>(dq + q_off + (long)qi * q_rs + 8 * n + 2 * t) =
                pack_bf16(gq[n][2 * hr] * scale, gq[n][2 * hr + 1] * scale);
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* seg_q,
               const void* seg_kv, void* out, void* lse, int B, int Sq, int Skv,
               int H, int KVH, int causal, int window, float scale, cudaStream_t st) {
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    auto kernel = packed_attn_fwd_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, fwd_mma_smem<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, MMA_THREADS, fwd_mma_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(seg_q),
        static_cast<const int*>(seg_kv), static_cast<bf16*>(out),
        static_cast<float*>(lse), Sq, Skv, H, KVH, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* seg_q,
               const void* seg_kv, const void* out, const void* dout, const void* lse,
               void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
               int H, int KVH, int causal, int window, float scale, cudaStream_t st) {
    const long rows = (long)B * Sq * H;
    const int warps = DELTA_THREADS / 32;
    packed_attn_delta_kernel<<<(unsigned)((rows + warps - 1) / warps), DELTA_THREADS, 0,
                               st>>>(static_cast<const bf16*>(out),
                                     static_cast<const bf16*>(dout),
                                     static_cast<float*>(delta), B, Sq, H, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const dim3 kv_grid((Skv + BK - 1) / BK, KVH, B), q_grid((Sq + BQ - 1) / BQ, H, B);
    auto dkdv = packed_attn_dkdv_mma_kernel<D>;
    if ((err = allow_smem(dkdv, bwd_mma_smem<D>())) != cudaSuccess)
        return static_cast<int>(err);
    dkdv<<<kv_grid, MMA_THREADS, bwd_mma_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(seg_q),
        static_cast<const int*>(seg_kv), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv, H, KVH, causal, window,
        scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

    auto dqk = packed_attn_dq_mma_kernel<D>;
    if ((err = allow_smem(dqk, bwd_mma_smem<D>())) != cudaSuccess)
        return static_cast<int>(err);
    dqk<<<q_grid, MMA_THREADS, bwd_mma_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(seg_q),
        static_cast<const int*>(seg_kv), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), Sq, Skv, H, KVH, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

constexpr int ERR_UNSUPPORTED = -1;

}  // namespace

// Plain C entry points (bound with ctypes), bf16 tensors.  Each launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after its
// launches (-1 for a head dim it does not take).
extern "C" int packed_attn_fwd(const void* q, const void* k, const void* v,
                               const void* seg_q, const void* seg_kv, void* out,
                               void* lse, int B, int Sq, int Skv, int H, int KVH, int D,
                               int causal, int window, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return launch_fwd<16>(q, k, v, seg_q, seg_kv, out, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 32: return launch_fwd<32>(q, k, v, seg_q, seg_kv, out, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 64: return launch_fwd<64>(q, k, v, seg_q, seg_kv, out, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 128: return launch_fwd<128>(q, k, v, seg_q, seg_kv, out, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        default: return ERR_UNSUPPORTED;
    }
}

extern "C" int packed_attn_bwd(const void* q, const void* k, const void* v,
                               const void* seg_q, const void* seg_kv, const void* out,
                               const void* dout, const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                               int D, int causal, int window, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return launch_bwd<16>(q, k, v, seg_q, seg_kv, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 32: return launch_bwd<32>(q, k, v, seg_q, seg_kv, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 64: return launch_bwd<64>(q, k, v, seg_q, seg_kv, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 128: return launch_bwd<128>(q, k, v, seg_q, seg_kv, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        default: return ERR_UNSUPPORTED;
    }
}

extern "C" const char* packed_attn_error_string(int code) {
    if (code == ERR_UNSUPPORTED) return "unsupported head dim (want 16, 32, 64 or 128)";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
