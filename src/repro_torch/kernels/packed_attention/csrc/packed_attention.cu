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
// dtype) or, in the float32 kernels at the end (every head dim, 3xTF32 on
// the tensor cores), fp32; softmax statistics, masks and every sum are fp32.
//
// Semantics the tests pin (those of the Pallas kernel and of jax.grad):
//   - a query row with no visible key (segment 0, or alone in a window that
//     holds nothing) gives exactly 0, and its dq is 0; its lse is +inf;
//   - keys of segment 0 get dk = dv = 0; no key is seen across segments;
//   - p is rounded to the value type before P.V (kernel.py:105), and the
//     row sum l takes the unrounded p; the scale is 1/sqrt(D) and masked
//     scores are -0.7 x FLT_MAX, as in the Pallas kernel;
//   - ragged lengths need no padding: rows past Sq or Skv read as zeros of
//     segment 0 and are never written;
//   - in fp32 nothing is rounded and no residual is written: delta =
//     rowsum(dO * out), out being the fp32 output jax.grad takes delta from;
//   - the bf16 output is rounded once; when a backward will follow, the
//     forward also writes out_lo = bf16(o' - float(out)), o' = (sum_j
//     bf16(p_j) v_j) / (sum_j bf16(p_j)), and the backward takes delta =
//     rowsum(dO * (out + out_lo)).  A row of dS sums to (exact delta -
//     delta used), which dQ carries times the keys' mean: where keys share
//     most of their energy, delta from the bf16 output alone parts dQ far
//     from the exact gradient (jax.grad takes delta from its fp32 output).
//     o' is that fp32 output but with the weights P.V used (P rounded)
//     summing to one: rounding P moves the fp32 output by (the values'
//     mean) x (the sum of P's rounding errors), and o' moves by the values'
//     spread about their mean only.  Where P is not rounded (the plain
//     twin, ref.packed_attention_bwd_ref, in fp32) o' is the fp32 output;
//   - the backward is deterministic: no atomics in any sum, a fixed order
//     of sums (the tile census below counts tiles apart from them).
//
// Bound.  The work is 4 D flops per visible (query, key) pair and head
// forward, and 10 D backward (S recomputed, dP, dV, dK, dQ), against
// 2 (H + 2 KVH) D elements of q, k, v and out per token.  With documents of
// hundreds of tokens that is hundreds of flops per byte, at or above the
// H100's bf16 ridge of 295: the kernels are bound by operations, so the
// design is about keeping the tensor cores fed.
//
// Design for D = 64 and 128 (every full-width config with attention):
// warp-specialised blocks of three warpgroups (384 threads).  Warpgroup 0
// is the producer: its first thread keeps TMA copies of the streamed tiles
// in flight into a ring of stages signalled by mbarriers (a "full" barrier
// per stage that the copies complete, an "empty" one the consumers release),
// and its second warp copies the per-row statistics (segment ids, lse,
// delta) of the same tiles into the stage; it gives its registers to the
// consumers (setmaxnreg).  Warpgroups 1 and 2 are consumers, each owning 64
// rows of the block's tile, and run every product as wgmma: scores from two
// shared-memory operands, the next product's A operand (P, dS) from
// registers, rounded to bf16 there.  In the forward the two consumers take
// turns to issue their products (named barriers), so that one's softmax
// overlaps the other's products.
//   - Tiles live in shared memory as the TMA writes them: D / 64 boxes of
//     (rows, 64) bf16 with the 128-byte swizzle, straight from the model
//     layout (B, S, H, D) by a 4-d tensor map with its strides (no copy, no
//     transpose, no repeat of KV heads); TMA's zero fill past the end
//     replaces the masking of ragged tails on loads.
//   - Tile schedule.  At block start every warp scans part of the tiles in
//     the causal/window range and classifies each (query tile, key tile)
//     pair by its segment ids: skipped (the nonzero ids of the two tiles do
//     not overlap: exactly a no-op for (m, l, acc) and for the gradients),
//     full (one nonzero segment across both tiles and the pair wholly inside
//     the causal and window limits: no mask is applied), or masked
//     (everything else: visible() per element).  Producer and consumers then
//     walk the same list with no barrier per tile.  ref.tile_schedule is the
//     same rule in PyTorch; the tile census holds the two to each other.
//   - Forward: one block per (128 queries, head, row), key tiles of 128;
//     the softmax runs on the accumulator fragments in base 2 (log2(e)
//     folded into the scale) while the previous tile's P.V is on the
//     tensor cores; each row's logsumexp is written for the backward.
//     Blocks take the query tiles last to first, so the longest causal
//     rows start first.
//   - Backward (FlashAttention-2's recomputation): a small kernel takes
//     delta = rowsum(dO * (O + O_lo)) in fp32; one block per (128 keys, KV
//     head, row)
//     keeps K and V in shared memory, streams Q and dO tiles of 64 queries
//     for every kept query tile and each of the G heads, and accumulates dV
//     += P^T dO and dK += dS^T Q in registers (S^T = K Q^T and dP^T = V dO^T
//     on wgmma); one block per (128 queries, head, row) streams K and V
//     tiles of 128 keys and accumulates dQ = dS K.  dQ stays a kernel of its
//     own (it recomputes S and dP: 14 D flops per pair against the bound's
//     10 D) so that no sum needs atomics.
// Head dims 16 and 32 occur only in the .smoke() configs and the card
// tests; they keep the previous design (mma.sync m16n8k16 on 64 x 64 tiles,
// loads through registers, four warps), dispatched by D in the launchers.
//
// Limits, checked by the Python wrapper: bf16 or fp32 (all three of q, k,
// v alike); D in {16, 32, 64, 128};
// the pointers 16-byte aligned; segment ids >= 0 (the tile skip compares
// their ranges).  Checked here, at D = 64 and 128: a block's tile schedule
// (a byte per tile in range) fits the card's shared memory beside its
// stages, which on an H100 holds rows of over 4 million keys and queries
// (the float32 kernels at D = 128, beside their hi/lo tiles: 229 thousand
// keys in the forward, 245 thousand in dQ, 106 thousand queries in dK/dV).
//
// Tile census.  packed_attn_tile_census turns on counting, per kernel
// (forward, dK/dV, dQ: the bf16 ones at D = 64 and 128, the float32 ones at
// every D), of the tiles each block's schedule
// classes skipped, masked and full; the counts are summed with atomics into
// a device array apart from every output.  Off (the default) it costs a
// load and a branch per warp and block.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile (head dims 16, 32)
constexpr int BK = 64;          // key rows per tile (head dims 16, 32)
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
// Head dims 16 and 32: mma.sync m16n8k16, bf16 operands, fp32 sums
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

// The output's epilogue: (a, b) rounded to a bf16 pair at out[at], and,
// where out_lo is not null, (a2, b2) less that pair (in bf16) at
// out_lo[at]: a2, b2 are the entries of o' (the header's semantics).
__device__ __forceinline__ void store_out(__nv_bfloat16* out, __nv_bfloat16* out_lo, long at,
                                          float a, float b, float a2, float b2) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
    *reinterpret_cast<__nv_bfloat162*>(out + at) = hi;
    if (out_lo != nullptr) {
        const float2 back = __bfloat1622float2(hi);
        *reinterpret_cast<uint32_t*>(out_lo + at) = pack_bf16(a2 - back.x, b2 - back.y);
    }
}

// A float rounded to bf16, back in a float.
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
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

// Forward, head dims 16 and 32

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
packed_attn_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                           __nv_bfloat16* __restrict__ out,
                           __nv_bfloat16* __restrict__ out_lo, float* __restrict__ lse,
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

    // l: the row sums of p; lt: of p as P.V takes it, rounded to bf16
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, lt[2] = {0.f, 0.f};
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
        float alpha[2], sum[2] = {0.f, 0.f}, sum_r[2] = {0.f, 0.f}, m_new[2];
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
                s[j][e] = round_bf16(p);  // as mix_mma takes it
                sum_r[hr] += s[j][e];
            }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float x = sum[hr], xr = sum_r[hr];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            xr += __shfl_xor_sync(0xffffffffu, xr, 1);
            xr += __shfl_xor_sync(0xffffffffu, xr, 2);
            alpha[hr] = expf(m[hr] - m_new[hr]);
            l[hr] = alpha[hr] * l[hr] + x;
            lt[hr] = alpha[hr] * lt[hr] + xr;
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

    const long o0 = (long)b * Sq * q_rs + (long)h * D;
    __nv_bfloat16* ob = out + o0;
    __nv_bfloat16* ob_lo = out_lo == nullptr ? nullptr : out_lo + o0;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        if (qi[hr] >= Sq) continue;
        const float lm = fmaxf(l[hr], 1e-30f), ltm = fmaxf(lt[hr], 1e-30f);
#pragma unroll
        for (int n = 0; n < NT; ++n)
            store_out(ob, ob_lo, (long)qi[hr] * q_rs + 8 * n + 2 * t, acc[n][2 * hr] / lm,
                      acc[n][2 * hr + 1] / lm, acc[n][2 * hr] / ltm, acc[n][2 * hr + 1] / ltm);
        if (t == 0)
            lse[((long)b * H + h) * Sq + qi[hr]] = l[hr] > 0.f ? m[hr] + logf(l[hr]) : INFINITY;
    }
}

// Backward: delta for every head dim; dK/dV and dQ for head dims 16 and 32

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta[b, h, i] = sum_d dO[b, i, h, d] * (O + O_lo)[b, i, h, d] in fp32, O_lo
// the forward's out_lo (bf16), or nothing (fp32: o_lo is null); a warp per
// row.
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
packed_attn_delta_kernel(const T* __restrict__ o, const T* __restrict__ o_lo,
                         const T* __restrict__ dout, float* __restrict__ delta, int B, int Sq,
                         int H, int D) {
    const long row = (long)blockIdx.x * (DELTA_THREADS / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= (long)B * Sq * H) return;
    const T* ob = o + row * D;
    const T* lb = o_lo == nullptr ? nullptr : o_lo + row * D;
    const T* gb = dout + row * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) {
        float x = to_f32(ob[d]);
        if (lb != nullptr) x += to_f32(lb[d]);
        s = fmaf(to_f32(gb[d]), x, s);
    }
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
// Head dims 64 and 128: Hopper building blocks (mbarrier, TMA, wgmma)
// ---------------------------------------------------------------------------

constexpr int WG = 128;                  // threads of a warpgroup
constexpr int HOP_THREADS = 3 * WG;      // producer + two consumers
constexpr int HOP_WARPS = HOP_THREADS / 32;
constexpr int CONSUMER_WARPS = 8;        // the arrivals that release a stage
constexpr int STAT_LANES = 32;           // the statistics warp's arrivals
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint8_t SKIP = 0, MASKED = 1, FULL = 2;
constexpr int CENSUS_FWD = 0, CENSUS_DKDV = 1, CENSUS_DQ = 2;

// The tile census: [kernel][class] counts, and whether to take them.
__device__ unsigned long long g_census[3][3];
__device__ int g_census_on;

// 2^x on the special-function unit, subnormal results flushed to 0.
// exp2f without fast math wraps it to keep them, which cost the backward a
// quarter of its time; a p below 2^-126 is nothing beside a row sum of 1.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

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

// One box of a (d, head, row, batch) tensor map into shared memory; the
// copy completes its bytes on `bar`.  Coordinates past the end read as 0.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, uint64_t* bar,
                                         int d, int h, int row, int b) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(d), "r"(h), "r"(row),
        "r"(b)
        : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
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

// Registers that an asynchronous wgmma reads or writes stay where they are
// until its wait: the compiler may not move their uses across this point.
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void keep(uint32_t (&a)[R][4]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// A wgmma shared-memory matrix descriptor, 128-byte swizzle: 8-row groups
// 1024 bytes apart; `lbo` is the distance between the 64-column boxes along
// N of an MN-major operand (not read for a K-major one).
__device__ __forceinline__ uint64_t sw128_desc(const unsigned char* p, uint32_t lbo) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
           (1ull << 62);
}

// A (ROWS, D) bf16 tile is D / 64 boxes of (ROWS, 64), each ROWS x 128
// bytes.  As a K-major operand: rows row0 .. row0 + 63 (A) or all its rows
// (B), columns 16 kk .. 16 kk + 15.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int row0, int kk) {
    return sw128_desc(tile + (kk >> 2) * ROWS * 128 + row0 * 128 + (kk & 3) * 32, 0);
}

// As the MN-major B operand of a product over its rows: rows 16 kk ..
// 16 kk + 15, all D columns.
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int kk) {
    return sw128_desc(tile + kk * 16 * 128, ROWS * 128);
}

// d (64 x N) (+)= A . B^T on the tensor cores, A and B K-major in shared
// memory; and d (64 x N) += A . B with A (64 x 16) bf16 fragments in
// registers and B (16 x N) MN-major in shared memory.  The accumulator of a
// thread (warp w of the warpgroup, lane = 4 g + t) holds rows 16 w + g and
// 16 w + g + 8, columns 8 j + 2 t + {0, 1}: d[4 j + 2 hr + e] is row
// 16 w + g + 8 hr, column 8 j + 2 t + e.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b,
                                              int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x N) = A[a_row0 ..] . B^T over D, A an (AR, D) tile, B an (N, D) tile.
template <int D, int N, int AR>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], const unsigned char* A, int a_row0,
                                        const unsigned char* B) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<N>(d, kmajor<AR>(A, a_row0, kk), kmajor<N>(B, 0, kk), kk > 0);
}

// d (64 x D) += P . M, P (64 x 16 KS) as bf16 fragments, M a (16 KS, D) tile.
template <int D, int KS>
__device__ __forceinline__ void gemm_rs(float (&d)[D / 2], const uint32_t (&p)[KS][4],
                                        const unsigned char* M) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) wgmma_rs<D>(d, p[kk], mnmajor<16 * KS>(M, kk));
}

// The bf16 A fragments of a 64 x N accumulator tile (a score tile turned
// into the next product's left operand): k-step kk takes columns
// 16 kk .. 16 kk + 15, the accumulators of n8 tiles 2 kk and 2 kk + 1.
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&a)[N / 16][4], const float (&s)[N / 2]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        a[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
}

// The sums over a thread's columns of each of its two rows (hr) of the bf16
// values to_frags packed: a[kk][e] holds row e & 1.
template <int N>
__device__ __forceinline__ void frag_row_sums(const uint32_t (&a)[N / 16][4], float (&rs)[2]) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            rs[e & 1] += __uint_as_float(a[kk][e] << 16) + __uint_as_float(a[kk][e] & 0xffff0000u);
}

// ---------------------------------------------------------------------------
// The tile schedule
// ---------------------------------------------------------------------------

// The nonzero ids of T rows from row0 (rows at or past n read as 0): their
// range [lo, hi] (hi = 0 if there is none), and whether all T ids are one
// nonzero id.  One warp, every lane gets the result.
struct SegSummary {
    int lo, hi;
    bool uniform;
};

template <int T>
__device__ __forceinline__ SegSummary seg_summary(const int* seg, int row0, int n) {
    const int lane = threadIdx.x & 31;
    int lo = INT_MAX, hi = 0;
    unsigned zero = 0;
#pragma unroll
    for (int e = 0; e < T / 32; ++e) {
        const int r = row0 + lane + 32 * e;
        const int s = r < n ? __ldg(seg + r) : 0;
        if (s) {
            lo = min(lo, s);
            hi = max(hi, s);
        } else {
            zero = 1u;
        }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    zero = __reduce_or_sync(0xffffffffu, zero);
    return {lo, hi, zero == 0u && lo == hi};
}

// A (query tile, key tile) pair: SKIP if no key of the one can be visible
// to a query of the other by segment; FULL if every pair is visible (one
// nonzero segment across both, wholly inside the causal and window
// limits); MASKED otherwise.
__device__ __forceinline__ uint8_t pair_class(SegSummary q, SegSummary k, int q0, int bq,
                                              int k0, int bk, int causal, int window) {
    if (disjoint(q.lo, q.hi, k.lo, k.hi)) return SKIP;
    const bool inside =
        (!causal || k0 + bk - 1 <= q0) && (window <= 0 || q0 + bq - 1 - k0 < window);
    return q.uniform && k.uniform && q.lo == k.lo && inside ? FULL : MASKED;
}

// The key tiles of size bk a query tile [q0, q0 + bq) can see: from the
// window's first to the causal diagonal.
__device__ __forceinline__ void key_range(int q0, int bq, int bk, int Skv, int causal,
                                          int window, int& begin, int& n) {
    int end = (Skv + bk - 1) / bk;
    if (causal) end = min(end, (q0 + bq - 1) / bk + 1);
    const int lo = q0 - window + 1;  // the first key the tile's first query sees
    begin = (window > 0 && lo > 0) ? lo / bk : 0;
    n = max(end - begin, 0);
}

// The query tiles of size bq that can see a key tile [k0, k0 + bk).
__device__ __forceinline__ void query_range(int k0, int bk, int bq, int Sq, int causal,
                                            int window, int& begin, int& n) {
    begin = causal ? k0 / bq : 0;
    int end = (Sq + bq - 1) / bq;
    if (window > 0) end = min(end, (k0 + bk - 1 + window - 1) / bq + 1);
    n = max(end - begin, 0);
}

// Every warp of the block (WARPS of them) classifies its share of the n
// tiles that the fixed tile (`fixed`, at row f0) meets; cls[i] is tile
// begin + i's class.  With the census on, each warp adds its classes to
// g_census[CENSUS] (where `count`: of the blocks that share a fixed tile,
// one counts it).
template <int TF, int TV, bool FIXED_IS_QUERY, int CENSUS, int WARPS = HOP_WARPS>
__device__ __forceinline__ void build_schedule(const int* seg_f, int f0, int nf,
                                               const int* seg_v, int nv, int begin, int n,
                                               int causal, int window, uint8_t* cls,
                                               bool count = true) {
    const int warp = threadIdx.x >> 5;
    const SegSummary fixed = seg_summary<TF>(seg_f, f0, nf);
    unsigned masked = 0, full = 0, all = 0;
    for (int i = warp; i < n; i += WARPS) {
        const int v0 = (begin + i) * TV;
        const SegSummary other = seg_summary<TV>(seg_v, v0, nv);
        const uint8_t c = FIXED_IS_QUERY
                              ? pair_class(fixed, other, f0, TF, v0, TV, causal, window)
                              : pair_class(other, fixed, v0, TV, f0, TF, causal, window);
        if ((threadIdx.x & 31) == 0) cls[i] = c;
        masked += c == MASKED;
        full += c == FULL;
        ++all;
    }
    if ((threadIdx.x & 31) == 0 && all > 0 && count && g_census_on) {
        atomicAdd(&g_census[CENSUS][SKIP], (unsigned long long)(all - masked - full));
        atomicAdd(&g_census[CENSUS][MASKED], (unsigned long long)masked);
        atomicAdd(&g_census[CENSUS][FULL], (unsigned long long)full);
    }
}

// The producer's and the consumers' walk over the ring of stages.
struct Ring {
    int stage = 0;
    uint32_t phase = 0;
    template <int STAGES>
    __device__ __forceinline__ void next() {
        if (++stage == STAGES) {
            stage = 0;
            phase ^= 1u;
        }
    }
};

// The forward's two consumer warpgroups take turns to issue their products
// (named barriers 1 and 2, one per consumer, each counting both
// warpgroups), so that one's softmax runs while the other's products are on
// the tensor cores, instead of both at once; the backward kernels gained
// nothing from it.  Consumer 1 passes the first turn to consumer 0
// (turns_start); consumer 0 takes the last pass back at the end
// (turns_end), so every arrival is matched.
__device__ __forceinline__ void turn_wait(int c) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(2 * WG) : "memory");
}
__device__ __forceinline__ void turn_pass(int c) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - c), "n"(2 * WG) : "memory");
}
__device__ __forceinline__ void turns_start(int c) {
    if (c == 1) turn_pass(1);
}
__device__ __forceinline__ void turns_end(int c) {
    if (c == 0) turn_wait(0);
}

// ---------------------------------------------------------------------------
// Forward, head dims 64 and 128
// ---------------------------------------------------------------------------

// The next kept tile at or after i (n if none).
__device__ __forceinline__ int next_kept(const uint8_t* cls, int i, int n) {
    while (i < n && cls[i] == SKIP) ++i;
    return i;
}

// A thread's two query rows of a 64-row score tile: index and segment id.
struct TileRows {
    int qi0, qi1, sq0, sq1;
};

// The forward's online softmax on a 64 x BK score tile held as wgmma
// accumulators (a row's 4 lanes share its statistics): scores scaled to
// base 2 and masked where the tile is MASKED, (m, l) updated with this
// lane's part of l, s replaced by p, alpha the rescaling of the previous O.
// Accumulator index x is column 8 (x / 4) + 2 t + (x & 1) of row half
// (x / 2) & 1.
template <int BK>
__device__ __forceinline__ void fwd_softmax(float (&s)[BK / 2], uint8_t cl, const int* kseg,
                                            int k0, const TileRows& rows, int causal,
                                            int window, float scale2, float (&m)[2],
                                            float (&l)[2], float (&alpha)[2]) {
    const int t = threadIdx.x & 3;
    const int qi[2] = {rows.qi0, rows.qi1}, sq[2] = {rows.sq0, rows.sq1};
    // bit 2 j + e of ok[hr]: column 8 j + 2 t + e is visible to row hr.  Only
    // the bits depend on the class: the accumulators are written on one path.
    static_assert(BK == 128, "one bit per column of the thread's 32");
    uint32_t ok[2] = {~0u, ~0u};
    if (cl == MASKED) {
        ok[0] = ok[1] = 0u;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int col = 8 * j + 2 * t + e;
                const int sk = kseg[col];
#pragma unroll
                for (int hr = 0; hr < 2; ++hr)
                    ok[hr] |= (uint32_t)visible(qi[hr], k0 + col, sq[hr], sk, causal, window)
                              << (2 * j + e);
            }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
        const int hr = (x >> 1) & 1, bit = 2 * (x >> 2) + (x & 1);
        s[x] = (ok[hr] >> bit) & 1u ? s[x] * scale2 : NEG_INF;
        mx[hr] = fmaxf(mx[hr], s[x]);
    }
    float mu[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float x = mx[hr];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float m_new = fmaxf(m[hr], x);
        alpha[hr] = ex2(m[hr] - m_new);
        m[hr] = m_new;
        mu[hr] = m_new == NEG_INF ? 0.f : m_new;  // a row that sees nothing yet: p = 0
    }
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) {
        const int hr = (x >> 1) & 1;
        const float p = ex2(s[x] - mu[hr]);
        s[x] = p;
        rs[hr] += p;
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = alpha[hr] * l[hr] + rs[hr];
}

template <int D>
struct FwdLayout {
    static constexpr int BQ = 128, BK = 128, STAGES = 2;
    static constexpr int TILE = BK * D * 2;
    static constexpr int Q = 0;
    static constexpr int K = Q + BQ * D * 2;               // [STAGES] K tiles
    static constexpr int V = K + STAGES * TILE;            // [STAGES] V tiles
    static constexpr int KSEG = V + STAGES * TILE;         // int [STAGES][BK]
    // q, then per stage: K full, V full, K empty, V empty
    static constexpr int BARS = KSEG + STAGES * BK * 4;
    static constexpr int CLS = BARS + 8 * (1 + 4 * STAGES);
    // + a class a tile of the schedule, + the alignment to 1024
    static size_t bytes(int tiles) { return (size_t)CLS + tiles + 1024; }
};

// One block per (128 queries, head, row).  K and V tiles have barriers of
// their own: K_i is released once S_i = Q K_i^T is in, V_i once P_i V_i is,
// so that K_{i+1} streams in while P_{i-1} V_{i-1} still holds its V.  RES:
// out_lo is written (its row sums of the rounded P kept only then).
template <int D, bool RES>
__global__ void __launch_bounds__(HOP_THREADS, 1)
packed_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                             __nv_bfloat16* __restrict__ out,
                             __nv_bfloat16* __restrict__ out_lo, float* __restrict__ lse, int Sq,
                             int Skv, int H, int KVH, int causal, int window, float scale) {
    using L = FwdLayout<D>;
    constexpr int BQ_ = L::BQ, BK_ = L::BK, ST = L::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
    uint64_t* k_full = qbar + 1;
    uint64_t* v_full = k_full + ST;
    uint64_t* k_empty = v_full + ST;
    uint64_t* v_empty = k_empty + ST;
    int* kseg = reinterpret_cast<int*>(sm + L::KSEG);
    uint8_t* cls = sm + L::CLS;

    const int nq = (Sq + BQ_ - 1) / BQ_;
    const int q0 = (nq - 1 - (int)blockIdx.x) * BQ_, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / (H / KVH);
    const int* sq_row = seg_q + (long)b * Sq;
    const int* sk_row = seg_kv + (long)b * Skv;

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(&k_full[s], 1 + STAT_LANES);
            mbar_init(&v_full[s], 1);
            mbar_init(&k_empty[s], CONSUMER_WARPS);
            mbar_init(&v_empty[s], CONSUMER_WARPS);
        }
        mbar_fence_init();
        mbar_expect_tx(qbar, BQ_ * D * 2);
        for (int x = 0; x < D / 64; ++x)
            tma_load(sm + L::Q + x * BQ_ * 128, tq, qbar, 64 * x, h, q0, b);
    }
    int kt0, n;
    key_range(q0, BQ_, BK_, Skv, causal, window, kt0, n);
    build_schedule<BQ_, BK_, true, CENSUS_FWD>(sq_row, q0, Sq, sk_row, Skv, kt0, n, causal,
                                               window, cls);
    __syncthreads();

    if (threadIdx.x < WG) {
        // ---- producer ----
        regs_dec<PRODUCER_REGS>();
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        if (warp == 0 && lane == 0) {
            Ring r;
            for (int i = 0; i < n; ++i) {
                if (cls[i] == SKIP) continue;
                const int k0 = (kt0 + i) * BK_;
                unsigned char* ks = sm + L::K + r.stage * L::TILE;
                unsigned char* vs = sm + L::V + r.stage * L::TILE;
                mbar_wait(&k_empty[r.stage], r.phase ^ 1u);
                mbar_expect_tx(&k_full[r.stage], L::TILE);
                for (int x = 0; x < D / 64; ++x)
                    tma_load(ks + x * BK_ * 128, tk, &k_full[r.stage], 64 * x, kh, k0, b);
                mbar_wait(&v_empty[r.stage], r.phase ^ 1u);
                mbar_expect_tx(&v_full[r.stage], L::TILE);
                for (int x = 0; x < D / 64; ++x)
                    tma_load(vs + x * BK_ * 128, tv, &v_full[r.stage], 64 * x, kh, k0, b);
                r.next<ST>();
            }
        } else if (warp == 1) {
            // the key segment ids of each masked tile, beside its K
            Ring r;
            for (int i = 0; i < n; ++i) {
                const uint8_t c = cls[i];
                if (c == SKIP) continue;
                mbar_wait(&k_empty[r.stage], r.phase ^ 1u);
                if (c == MASKED) {
                    const int k0 = (kt0 + i) * BK_;
#pragma unroll
                    for (int e = 0; e < BK_ / 32; ++e) {
                        const int kj = k0 + lane + 32 * e;
                        kseg[r.stage * BK_ + lane + 32 * e] = kj < Skv ? __ldg(sk_row + kj) : 0;
                    }
                }
                mbar_arrive(&k_full[r.stage]);
                r.next<ST>();
            }
        }
    } else {
        // ---- consumers: 64 query rows each ----
        regs_inc<CONSUMER_REGS>();
        const int c = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
        const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
        const int row0 = 64 * c;  // the consumer's rows of the block's tile
        int qi[2], sq[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            qi[hr] = q0 + row0 + 16 * w + g + 8 * hr;
            sq[hr] = qi[hr] < Sq ? __ldg(sq_row + qi[hr]) : 0;
        }
        const float scale2 = scale * LOG2E;
        // l: the row sums of p; lt: of p as P.V takes it, rounded (RES)
        float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, lt[2] = {0.f, 0.f};
        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

        // Each tile's softmax overlaps the previous tile's P.V on the tensor
        // cores: S_i = Q K_i^T and O += P_{i-1} V_{i-1} are issued together,
        // the softmax of S_i runs once S_i is in, and O is rescaled once
        // P_{i-1} V_{i-1} is in too.  The first kept tile is taken before the
        // loop, so that no wgmma is issued on a branch.
        mbar_wait(qbar, 0);
        const TileRows rows{qi[0], qi[1], sq[0], sq[1]};
        turns_start(c);
        Ring r;
        int i = next_kept(cls, 0, n);
        if (i < n) {
            float s[BK_ / 2];
            mbar_wait(&k_full[r.stage], r.phase);
            turn_wait(c);
            wg_fence();
            gemm_ss<D, BK_, BQ_>(s, sm + L::Q, row0, sm + L::K + r.stage * L::TILE);
            wg_commit();
            turn_pass(c);
            wg_wait<0>();
            keep(s);
            float alpha[2];
            fwd_softmax<BK_>(s, cls[i], kseg + r.stage * BK_, (kt0 + i) * BK_, rows, causal,
                             window, scale2, m, l, alpha);
            if ((tid & 31) == 0) mbar_arrive(&k_empty[r.stage]);  // K_i and its ids are read
            uint32_t pf[BK_ / 16][4];  // P_{i-1}, bf16
            to_frags<BK_>(pf, s);
            if constexpr (RES) {
                float rs[2] = {0.f, 0.f};
                frag_row_sums<BK_>(pf, rs);
                lt[0] = alpha[0] * lt[0] + rs[0];
                lt[1] = alpha[1] * lt[1] + rs[1];
            }
            int prev = r.stage;  // the stage of V_{i-1}
            uint32_t prev_phase = r.phase;
            r.next<ST>();
            for (i = next_kept(cls, i + 1, n); i < n; i = next_kept(cls, i + 1, n)) {
                // no branch and no wait loop while a product is in flight
                mbar_wait(&k_full[r.stage], r.phase);
                mbar_wait(&v_full[prev], prev_phase);
                turn_wait(c);
                wg_fence();
                gemm_ss<D, BK_, BQ_>(s, sm + L::Q, row0, sm + L::K + r.stage * L::TILE);
                wg_commit();
                gemm_rs<D, BK_ / 16>(o, pf, sm + L::V + prev * L::TILE);
                wg_commit();
                turn_pass(c);
                wg_wait<1>();
                keep(s);
                fwd_softmax<BK_>(s, cls[i], kseg + r.stage * BK_, (kt0 + i) * BK_, rows, causal,
                                 window, scale2, m, l, alpha);
                wg_wait<0>();
                keep(o);
                keep(pf);
                if ((tid & 31) == 0) {
                    mbar_arrive(&k_empty[r.stage]);  // K_i and its ids are read
                    mbar_arrive(&v_empty[prev]);
                }
#pragma unroll
                for (int x = 0; x < D / 2; ++x) o[x] *= alpha[(x >> 1) & 1];
                to_frags<BK_>(pf, s);  // p rounded to bf16 for P.V
                if constexpr (RES) {
                    float rs[2] = {0.f, 0.f};
                    frag_row_sums<BK_>(pf, rs);
                    lt[0] = alpha[0] * lt[0] + rs[0];
                    lt[1] = alpha[1] * lt[1] + rs[1];
                }
                prev = r.stage;
                prev_phase = r.phase;
                r.next<ST>();
            }
            mbar_wait(&v_full[prev], prev_phase);
            turn_wait(c);
            wg_fence();
            gemm_rs<D, BK_ / 16>(o, pf, sm + L::V + prev * L::TILE);
            wg_commit();
            turn_pass(c);
            wg_wait<0>();
            keep(o);
            keep(pf);
            if ((tid & 31) == 0) mbar_arrive(&v_empty[prev]);
        }
        turns_end(c);

        const long q_rs = (long)H * D, o0 = (long)b * Sq * q_rs + (long)h * D;
        __nv_bfloat16* ob = out + o0;
        __nv_bfloat16* ob_lo = out_lo == nullptr ? nullptr : out_lo + o0;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float x = l[hr], xt = lt[hr];
            x += __shfl_xor_sync(0xffffffffu, x, 1);
            x += __shfl_xor_sync(0xffffffffu, x, 2);
            if constexpr (RES) {
                xt += __shfl_xor_sync(0xffffffffu, xt, 1);
                xt += __shfl_xor_sync(0xffffffffu, xt, 2);
            }
            if (qi[hr] >= Sq) continue;
            const float lm = fmaxf(x, 1e-30f), ltm = fmaxf(xt, 1e-30f);
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
                store_out(ob, RES ? ob_lo : nullptr, (long)qi[hr] * q_rs + 8 * j + 2 * t,
                          o[4 * j + 2 * hr] / lm, o[4 * j + 2 * hr + 1] / lm,
                          o[4 * j + 2 * hr] / ltm, o[4 * j + 2 * hr + 1] / ltm);
            if (t == 0)
                lse[((long)b * H + h) * Sq + qi[hr]] =
                    x > 0.f ? (m[hr] + log2f(x)) / LOG2E : INFINITY;
        }
    }
}

// ---------------------------------------------------------------------------
// Backward, head dims 64 and 128
// ---------------------------------------------------------------------------

constexpr int BWD_STAGES = 3;

// The per-row statistics of a streamed query tile (dK/dV): lse in base 2,
// delta and segment ids of its 64 queries.
struct QStats {
    float lse2[64];
    float delta[64];
    int seg[64];
};

template <int D>
struct DkdvLayout {
    static constexpr int BK = 128, BQ = 64, STAGES = BWD_STAGES;
    static constexpr int KV_TILE = BK * D * 2, Q_TILE = BQ * D * 2;
    static constexpr int K = 0, V = KV_TILE;
    static constexpr int Q = 2 * KV_TILE;                  // [STAGES] Q tiles
    static constexpr int DO = Q + STAGES * Q_TILE;         // [STAGES] dO tiles
    static constexpr int STATS = DO + STAGES * Q_TILE;     // QStats [STAGES]
    static constexpr int BARS = STATS + STAGES * (int)sizeof(QStats);  // kv, full[], empty[]
    static constexpr int CLS = BARS + 8 * (1 + 2 * STAGES);
    static size_t bytes(int tiles) { return (size_t)CLS + tiles + 1024; }
};

// One block per (128 keys, KV head, row): dK and dV of its keys.
template <int D>
__global__ void __launch_bounds__(HOP_THREADS, 1)
packed_attn_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int Sq, int Skv, int H, int KVH, int causal, int window,
                              float scale) {
    using L = DkdvLayout<D>;
    constexpr int BQ_ = L::BQ, BK_ = L::BK, ST = L::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
    uint64_t* full = kvbar + 1;
    uint64_t* empty = full + ST;
    QStats* stats = reinterpret_cast<QStats*>(sm + L::STATS);
    uint8_t* cls = sm + L::CLS;

    const int k0 = blockIdx.x * BK_, kh = blockIdx.y, b = blockIdx.z;
    const int G = H / KVH;
    const int* sq_row = seg_q + (long)b * Sq;
    const int* sk_row = seg_kv + (long)b * Skv;

    if (threadIdx.x == 0) {
        mbar_init(kvbar, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(&full[s], 1 + STAT_LANES);
            mbar_init(&empty[s], CONSUMER_WARPS);
        }
        mbar_fence_init();
        mbar_expect_tx(kvbar, 2 * L::KV_TILE);
        for (int x = 0; x < D / 64; ++x) {
            tma_load(sm + L::K + x * BK_ * 128, tk, kvbar, 64 * x, kh, k0, b);
            tma_load(sm + L::V + x * BK_ * 128, tv, kvbar, 64 * x, kh, k0, b);
        }
    }
    int qt0, n;
    query_range(k0, BK_, BQ_, Sq, causal, window, qt0, n);
    build_schedule<BK_, BQ_, false, CENSUS_DKDV>(sk_row, k0, Skv, sq_row, Sq, qt0, n, causal,
                                                 window, cls);
    __syncthreads();

    if (threadIdx.x < WG) {
        regs_dec<PRODUCER_REGS>();
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        if (warp == 0 && lane == 0) {
            Ring r;
            for (int i = 0; i < n; ++i) {
                if (cls[i] == SKIP) continue;
                const int q0 = (qt0 + i) * BQ_;
                for (int hg = 0; hg < G; ++hg) {
                    const int h = kh * G + hg;
                    mbar_wait(&empty[r.stage], r.phase ^ 1u);
                    mbar_expect_tx(&full[r.stage], 2 * L::Q_TILE);
                    unsigned char* qs = sm + L::Q + r.stage * L::Q_TILE;
                    unsigned char* dos = sm + L::DO + r.stage * L::Q_TILE;
                    for (int x = 0; x < D / 64; ++x) {
                        tma_load(qs + x * BQ_ * 128, tq, &full[r.stage], 64 * x, h, q0, b);
                        tma_load(dos + x * BQ_ * 128, tdo, &full[r.stage], 64 * x, h, q0, b);
                    }
                    r.next<ST>();
                }
            }
        } else if (warp == 1) {
            Ring r;
            for (int i = 0; i < n; ++i) {
                if (cls[i] == SKIP) continue;
                const int q0 = (qt0 + i) * BQ_;
                for (int hg = 0; hg < G; ++hg) {
                    const long ro = ((long)b * H + kh * G + hg) * Sq;
                    mbar_wait(&empty[r.stage], r.phase ^ 1u);
                    QStats& st = stats[r.stage];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int x = lane + 32 * e, qi = q0 + x;
                        const bool in = qi < Sq;
                        st.lse2[x] = in ? __ldg(lse + ro + qi) * LOG2E : INFINITY;
                        st.delta[x] = in ? __ldg(delta + ro + qi) : 0.f;
                        st.seg[x] = in ? __ldg(sq_row + qi) : 0;
                    }
                    mbar_arrive(&full[r.stage]);
                    r.next<ST>();
                }
            }
        }
    } else {
        // ---- consumers: 64 keys each ----
        regs_inc<CONSUMER_REGS>();
        const int c = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
        const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
        const int row0 = 64 * c;
        int kj[2], sk[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            kj[hr] = k0 + row0 + 16 * w + g + 8 * hr;
            sk[hr] = kj[hr] < Skv ? __ldg(sk_row + kj[hr]) : 0;
        }
        const float scale2 = scale * LOG2E;
        float gk[D / 2], gv[D / 2];
#pragma unroll
        for (int x = 0; x < D / 2; ++x) gk[x] = gv[x] = 0.f;

        mbar_wait(kvbar, 0);
        Ring r;
        for (int i = 0; i < n; ++i) {
            const uint8_t cl = cls[i];
            if (cl == SKIP) continue;
            const int q0 = (qt0 + i) * BQ_;
            for (int hg = 0; hg < G; ++hg) {
                const unsigned char* qs = sm + L::Q + r.stage * L::Q_TILE;
                const unsigned char* dos = sm + L::DO + r.stage * L::Q_TILE;
                const QStats& st = stats[r.stage];
                mbar_wait(&full[r.stage], r.phase);

                // S^T = K Q^T and dP^T = V dO^T for the consumer's 64 keys;
                // then P^T and dS^T = P^T (dP^T - delta) on the fragments
                // (columns are queries), rounded to bf16 for the products.
                float s[BQ_ / 2], dp[BQ_ / 2];
                wg_fence();
                gemm_ss<D, BQ_, BK_>(s, sm + L::K, row0, qs);
                gemm_ss<D, BQ_, BK_>(dp, sm + L::V, row0, dos);
                wg_commit();
                wg_wait<0>();
                keep(s);
                keep(dp);
#pragma unroll
                for (int j = 0; j < BQ_ / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = 8 * j + 2 * t + e;
                        const float lq = st.lse2[col], dl = st.delta[col];
                        const int sqc = st.seg[col];
#pragma unroll
                        for (int hr = 0; hr < 2; ++hr) {
                            const int x = 4 * j + 2 * hr + e;
                            const float p =
                                cl == MASKED &&
                                        !visible(q0 + col, kj[hr], sqc, sk[hr], causal, window)
                                    ? 0.f
                                    : ex2(s[x] * scale2 - lq);
                            s[x] = p;
                            dp[x] = p * (dp[x] - dl);
                        }
                    }
                uint32_t pf[BQ_ / 16][4], df[BQ_ / 16][4];
                to_frags<BQ_>(pf, s);
                to_frags<BQ_>(df, dp);
                wg_fence();
                gemm_rs<D, BQ_ / 16>(gv, pf, dos);  // dV += P^T dO
                gemm_rs<D, BQ_ / 16>(gk, df, qs);   // dK += dS^T Q
                wg_commit();
                wg_wait<0>();
                keep(gv);
                keep(gk);
                keep(pf);
                keep(df);
                if ((tid & 31) == 0) mbar_arrive(&empty[r.stage]);
                r.next<ST>();
            }
        }

        const long kv_rs = (long)KVH * D;
        const long kv_off = (long)b * Skv * kv_rs + (long)kh * D;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            if (kj[hr] >= Skv) continue;
            const long off = kv_off + (long)kj[hr] * kv_rs;
#pragma unroll
            for (int j = 0; j < D / 8; ++j) {
                *reinterpret_cast<uint32_t*>(dk + off + 8 * j + 2 * t) =
                    pack_bf16(gk[4 * j + 2 * hr] * scale, gk[4 * j + 2 * hr + 1] * scale);
                *reinterpret_cast<uint32_t*>(dv + off + 8 * j + 2 * t) =
                    pack_bf16(gv[4 * j + 2 * hr], gv[4 * j + 2 * hr + 1]);
            }
        }
    }
}

template <int D>
struct DqLayout {
    static constexpr int BQ = 128, BK = 128, STAGES = 2;
    static constexpr int Q_TILE = BQ * D * 2, KV_TILE = BK * D * 2;
    static constexpr int Q = 0, DO = Q_TILE;
    static constexpr int K = 2 * Q_TILE;                   // [STAGES] K tiles
    static constexpr int V = K + STAGES * KV_TILE;         // [STAGES] V tiles
    static constexpr int KSEG = V + STAGES * KV_TILE;      // int [STAGES][BK]
    static constexpr int BARS = KSEG + STAGES * BK * 4;    // q, full[], empty[]
    static constexpr int CLS = BARS + 8 * (1 + 2 * STAGES);
    static size_t bytes(int tiles) { return (size_t)CLS + tiles + 1024; }
};

// One block per (128 queries, head, row): dQ of its queries.
template <int D>
__global__ void __launch_bounds__(HOP_THREADS, 1)
packed_attn_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const int* __restrict__ seg_q, const int* __restrict__ seg_kv,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int KVH,
                            int causal, int window, float scale) {
    using L = DqLayout<D>;
    constexpr int BQ_ = L::BQ, BK_ = L::BK, ST = L::STAGES;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BARS);
    uint64_t* full = qbar + 1;
    uint64_t* empty = full + ST;
    int* kseg = reinterpret_cast<int*>(sm + L::KSEG);
    uint8_t* cls = sm + L::CLS;

    const int nq = (Sq + BQ_ - 1) / BQ_;
    const int q0 = (nq - 1 - (int)blockIdx.x) * BQ_, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / (H / KVH);
    const int* sq_row = seg_q + (long)b * Sq;
    const int* sk_row = seg_kv + (long)b * Skv;

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < ST; ++s) {
            mbar_init(&full[s], 1 + STAT_LANES);
            mbar_init(&empty[s], CONSUMER_WARPS);
        }
        mbar_fence_init();
        mbar_expect_tx(qbar, 2 * L::Q_TILE);
        for (int x = 0; x < D / 64; ++x) {
            tma_load(sm + L::Q + x * BQ_ * 128, tq, qbar, 64 * x, h, q0, b);
            tma_load(sm + L::DO + x * BQ_ * 128, tdo, qbar, 64 * x, h, q0, b);
        }
    }
    int kt0, n;
    key_range(q0, BQ_, BK_, Skv, causal, window, kt0, n);
    build_schedule<BQ_, BK_, true, CENSUS_DQ>(sq_row, q0, Sq, sk_row, Skv, kt0, n, causal,
                                              window, cls);
    __syncthreads();

    if (threadIdx.x < WG) {
        regs_dec<PRODUCER_REGS>();
        const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
        if (warp == 0 && lane == 0) {
            Ring r;
            for (int i = 0; i < n; ++i) {
                if (cls[i] == SKIP) continue;
                const int k0 = (kt0 + i) * BK_;
                mbar_wait(&empty[r.stage], r.phase ^ 1u);
                mbar_expect_tx(&full[r.stage], 2 * L::KV_TILE);
                unsigned char* ks = sm + L::K + r.stage * L::KV_TILE;
                unsigned char* vs = sm + L::V + r.stage * L::KV_TILE;
                for (int x = 0; x < D / 64; ++x) {
                    tma_load(ks + x * BK_ * 128, tk, &full[r.stage], 64 * x, kh, k0, b);
                    tma_load(vs + x * BK_ * 128, tv, &full[r.stage], 64 * x, kh, k0, b);
                }
                r.next<ST>();
            }
        } else if (warp == 1) {
            Ring r;
            for (int i = 0; i < n; ++i) {
                const uint8_t c = cls[i];
                if (c == SKIP) continue;
                mbar_wait(&empty[r.stage], r.phase ^ 1u);
                if (c == MASKED) {
                    const int k0 = (kt0 + i) * BK_;
#pragma unroll
                    for (int e = 0; e < BK_ / 32; ++e) {
                        const int kj = k0 + lane + 32 * e;
                        kseg[r.stage * BK_ + lane + 32 * e] = kj < Skv ? __ldg(sk_row + kj) : 0;
                    }
                }
                mbar_arrive(&full[r.stage]);
                r.next<ST>();
            }
        }
    } else {
        // ---- consumers: 64 queries each ----
        regs_inc<CONSUMER_REGS>();
        const int c = threadIdx.x / WG - 1, tid = threadIdx.x % WG;
        const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
        const int row0 = 64 * c;
        int qi[2], sq[2];
        float lq[2], dl[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            qi[hr] = q0 + row0 + 16 * w + g + 8 * hr;
            const bool in = qi[hr] < Sq;
            const long ro = ((long)b * H + h) * Sq + qi[hr];
            sq[hr] = in ? __ldg(sq_row + qi[hr]) : 0;
            lq[hr] = in ? __ldg(lse + ro) * LOG2E : INFINITY;
            dl[hr] = in ? __ldg(delta + ro) : 0.f;
        }
        const float scale2 = scale * LOG2E;
        float gq[D / 2];
#pragma unroll
        for (int x = 0; x < D / 2; ++x) gq[x] = 0.f;

        // P is taken while dP is on the tensor cores.
        mbar_wait(qbar, 0);
        Ring r;
        for (int i = 0; i < n; ++i) {
            const uint8_t cl = cls[i];
            if (cl == SKIP) continue;
            const int k0 = (kt0 + i) * BK_;
            const unsigned char* ks = sm + L::K + r.stage * L::KV_TILE;
            mbar_wait(&full[r.stage], r.phase);

            float s[BK_ / 2], dp[BK_ / 2];
            wg_fence();
            gemm_ss<D, BK_, BQ_>(s, sm + L::Q, row0, ks);
            wg_commit();
            gemm_ss<D, BK_, BQ_>(dp, sm + L::DO, row0, sm + L::V + r.stage * L::KV_TILE);
            wg_commit();
            wg_wait<1>();
            keep(s);

            const int* kseg_s = kseg + r.stage * BK_;
#pragma unroll
            for (int j = 0; j < BK_ / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = 8 * j + 2 * t + e;
                    const int skc = cl == MASKED ? kseg_s[col] : 0;
#pragma unroll
                    for (int hr = 0; hr < 2; ++hr) {
                        float& x = s[4 * j + 2 * hr + e];
                        x = cl == MASKED && !visible(qi[hr], k0 + col, sq[hr], skc, causal, window)
                                ? 0.f
                                : ex2(x * scale2 - lq[hr]);
                    }
                }
            wg_wait<0>();
            keep(dp);
#pragma unroll
            for (int x = 0; x < BK_ / 2; ++x) dp[x] = s[x] * (dp[x] - dl[(x >> 1) & 1]);
            uint32_t df[BK_ / 16][4];
            to_frags<BK_>(df, dp);
            wg_fence();
            gemm_rs<D, BK_ / 16>(gq, df, ks);  // dQ += dS K
            wg_commit();
            wg_wait<0>();
            keep(gq);
            keep(df);
            if ((tid & 31) == 0) mbar_arrive(&empty[r.stage]);
            r.next<ST>();
        }

        const long q_rs = (long)H * D;
        __nv_bfloat16* qb = dq + (long)b * Sq * q_rs + (long)h * D;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            if (qi[hr] >= Sq) continue;
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
                *reinterpret_cast<uint32_t*>(qb + (long)qi[hr] * q_rs + 8 * j + 2 * t) =
                    pack_bf16(gq[4 * j + 2 * hr] * scale, gq[4 * j + 2 * hr + 1] * scale);
        }
    }
}

// ---------------------------------------------------------------------------
// float32, every head dim: 3xTF32 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------
//
// The bf16 kernels' function, grids and tile schedule (the forward and dQ
// over 128 x 128 tile pairs, dK/dV over 64 queries by 128 keys, each pair
// classed by build_schedule and counted in the tile census), in fp32: P is
// not rounded for P.V (the Pallas kernel rounds p to the value type, which
// in fp32 leaves it as it is), and the forward writes no residual, since
// its fp32 output is the output jax.grad takes delta from: the backward's
// delta is rowsum(dO * out).
//
// Products.  Each runs on the tensor cores as 3xTF32: every operand x is
// split into x_hi = tf32(x), rounded to nearest with ties away from zero as
// cvt.rna.tf32.f32 rounds, and x_lo = tf32(x - x_hi), and a product A.B is
// A_lo.B_hi + A_hi.B_lo + A_hi.B_hi summed in fp32 (wgmma m64nNk8 .tf32,
// fp32 accumulators).  Each partial product of two TF32 values is exact in
// fp32 and only A_lo.B_lo (about 2^-22 of |A||B|) is dropped; one pass of
// plain TF32 would part the output from fp32 by about 1e-3
// (ref.packed_attention_tf32 models both; the tests hold the 3-pass model
// to the 2e-5 of test_kernels and see the 1-pass one miss it, and phase 7b
// plants it on the card).  The tensor core reads a .tf32 operand by
// dropping its low 13 bits, so both parts are rounded to TF32 before they
// are stored, and the dropped bits are zero.  The tensor core also adds
// into its fp32 accumulator by truncation, whose bias grows with the
// number of adds: each product of a chunk starts a fresh accumulator and
// is added to the running sum by an FADD (rounded to nearest).  Softmax
// statistics, masks and every sum stay fp32, with expf.
//
// Layout.  .tf32 wgmma reads its shared-memory operands K-major only (the
// contraction contiguous): a (rows, C) fp32 operand is C / 32 boxes of
// (rows, 32) with the 128-byte swizzle, head dims under 32 padded to 32.
// Every tile goes through registers on its way in and is split there, once
// per load.  A product over the sequence takes its score-tile operand from
// the accumulator: as an A operand in registers (P.V, dS K), split there,
// with the other operand stored transposed (V^T, K^T, the sequence
// contiguous) -- an accumulator thread holds columns 2t and 2t + 1 of each
// 8-column group where the TF32 A fragment takes columns t and t + 4, so
// those tiles store sequence position j of each group of 8 at 4 (j & 1) +
// j / 2 (f32_pos), which pairs each A column with its B row at no cost --
// or, in dK/dV, as a B tile stored from the accumulator (P^T, dS^T, keys
// by queries), with the A operand (dO^T, Q^T) read as fragments straight
// from the natural Q and dO tiles (t_frags): no transposed copy of them.
//
// Shared memory decides the cuts: a 64-row tile of D = 128 is 64 KB as a
// hi/lo pair, and the fixed tiles and one stage of the streamed ones fill
// the card's 227 KB (no second stage).  A block has two warpgroups (256
// threads); every thread helps fill the stage between two barriers, and
// both warpgroups issue every product alike, on operands picked by
// warpgroup (a wgmma on a branch is serialised by ptxas).
//   - Forward: each warpgroup owns 64 of the block's 128 queries (Q hi/lo
//     for all 128: 128 KB at D = 128) and takes the kept key tiles in
//     chunks of BK keys (32 at D = 128, else 64): S = Q K^T, the online
//     softmax, O += P V (in two halves of D's columns).  The next chunk's
//     K and V stream into staging by cp.async while this one's products
//     run: a load into registers would hold the products back, since
//     wgmma.fence waits for the warp's outstanding loads.
//   - dQ: one block per 64 of a 128-query tile (Q and dO hi/lo: 128 KB at
//     D = 128), key chunks of BK with K, V and K^T (loaded into registers
//     a chunk ahead: no room for staging); warpgroup 0 takes S = Q K^T and
//     P, warpgroup 1 dP = dO V^T, they swap them through shared memory, and
//     each forms dS = P (dP - delta) and takes half of dQ's columns.
//   - dK/dV: one block per 64 of a 128-key tile (K and V hi/lo), query
//     chunks of BQC (32 at D = 128, else 64) of each kept 64-query tile,
//     each of the G heads in turn; warpgroup 0 takes S^T = K Q^T, P^T and
//     dV^T += dO^T P^T, warpgroup 1 dP^T = V dO^T, dS^T and dK^T += Q^T
//     dS^T, P^T handed over in fp32 (named barriers).  The G heads of a KV
//     head sum into the same accumulators; no sum needs atomics.
//   The tile schedule is the 128-row tile's: both blocks of a tile build
//   it and one counts it in the census; a block passes over the chunks
//   wholly outside its 64 rows' causal or window range.
// The work is 4 D flops a visible pair forward and 14 D backward (S and dP
// are recomputed in both dK/dV and dQ), three times over on the tensor
// cores: 495 / 3 = 165 TFLOP/s of fp32 products on an H100, against 67 on
// its CUDA cores.  At D = 128 the score products are 32 wide, where an
// operand read from shared memory costs more than its product.

constexpr int F32_THREADS = 2 * WG;
constexpr int F32_WARPS = F32_THREADS / 32;

// x rounded to TF32 (10 explicit mantissa bits, to nearest, ties away from
// zero: the rounding cvt.rna.tf32.f32 does), as the fp32 pattern the tensor
// core reads unchanged.  In integer arithmetic, the sign-magnitude pattern
// plus half the dropped part, which carries into the exponent as rounding
// does: two integer operations in place of a conversion, which issues on
// the slower conversion pipe (two a value, with its remainder's).
__device__ __forceinline__ float tf32_rna(float x) {
    return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
    hi = tf32_rna(x);
    lo = tf32_rna(x - hi);
}

// Where a transposed B tile keeps sequence position j of its chunk (the
// header's pairing of accumulator and fragment columns).
__device__ __forceinline__ int f32_pos(int j) {
    return (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);
}

// The byte offset of columns 4 c4 .. 4 c4 + 3 of row r of an (R, *) fp32
// operand tile: boxes of (R, 32) with the 128-byte swizzle, as f32_desc and
// f32_kofs read them.
template <int R>
__device__ __forceinline__ int f32_chunk(int r, int c4) {
    return (c4 >> 3) * R * 128 + r * 128 + (((c4 & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copies into shared memory that write no register (cp.async): of 16 or 4
// bytes, zero-filled where !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS rows of one head (row stride rs; rows at or past n read as 0),
// D floats each, as float4s spread over the block: a warp takes 8 rows by
// 4 float4s, so that its stores into the swizzled tiles meet few bank
// conflicts.
template <int ROWS, int D>
struct F32Rows {
    static constexpr int N = ROWS * D / 4 / F32_THREADS;
    static_assert(N * 4 * F32_THREADS == ROWS * D && ROWS % 8 == 0, "whole warps of rows");
    float4 x[N];

    __device__ static void where(int it, int& r, int& c4) {
        const int e = threadIdx.x + F32_THREADS * it, lane = e & 31, bi = e >> 5;
        r = 8 * (bi / (D / 16)) + (lane & 7);
        c4 = 4 * (bi % (D / 16)) + (lane >> 3);
    }

    // The same rows copied into staging, each thread's float4s into slots
    // of its own (it * F32_THREADS + thread), which only it reads back.
    __device__ static __forceinline__ void stage(unsigned char* st, const float* src, int row0,
                                                 int n, long rs) {
#pragma unroll
        for (int it = 0; it < N; ++it) {
            int r, c4;
            where(it, r, c4);
            const bool in = row0 + r < n;
            cp_async16(st + (it * F32_THREADS + threadIdx.x) * 16,
                       in ? src + (long)(row0 + r) * rs + 4 * c4 : src, in);
        }
    }
    __device__ __forceinline__ void unstage(const unsigned char* st) {
#pragma unroll
        for (int it = 0; it < N; ++it)
            x[it] = *reinterpret_cast<const float4*>(st + (it * F32_THREADS + threadIdx.x) * 16);
    }

    __device__ __forceinline__ void load(const float* src, int row0, int n, long rs) {
#pragma unroll
        for (int it = 0; it < N; ++it) {
            int r, c4;
            where(it, r, c4);
            x[it] = row0 + r < n
                        ? __ldg(reinterpret_cast<const float4*>(src + (long)(row0 + r) * rs + 4 * c4))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }

    // Split into a (ROWS, D) hi/lo pair of K-major tiles.
    __device__ __forceinline__ void put(unsigned char* hi, unsigned char* lo) const {
#pragma unroll
        for (int it = 0; it < N; ++it) {
            int r, c4;
            where(it, r, c4);
            float4 h, l;
            tf32_split(x[it].x, h.x, l.x);
            tf32_split(x[it].y, h.y, l.y);
            tf32_split(x[it].z, h.z, l.z);
            tf32_split(x[it].w, h.w, l.w);
            *reinterpret_cast<float4*>(hi + f32_chunk<ROWS>(r, c4)) = h;
            *reinterpret_cast<float4*>(lo + f32_chunk<ROWS>(r, c4)) = l;
        }
    }

    // Split into a (D, *) hi/lo pair of transposed tiles: row r goes to
    // column f32_pos(r).
    __device__ __forceinline__ void put_t(unsigned char* hi, unsigned char* lo) const {
#pragma unroll
        for (int it = 0; it < N; ++it) {
            int r, c4;
            where(it, r, c4);
            const int col = f32_pos(r);
            const float v[4] = {x[it].x, x[it].y, x[it].z, x[it].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int off = f32_chunk<D>(4 * c4 + e, col >> 2) + (col & 3) * 4;
                float h, l;
                tf32_split(v[e], h, l);
                *reinterpret_cast<float*>(hi + off) = h;
                *reinterpret_cast<float*>(lo + off) = l;
            }
        }
    }
};

// d (64 x N) = A . B over K (3xTF32), on the tensor cores.  A is rows
// a_row0 .. a_row0 + 63 of an (AR, K) hi/lo pair, B an (N, K) pair, both
// K-major in shared memory (the boxes and swizzle of f32_chunk); or A is
// KS k-steps of hi/lo TF32 fragments in registers and B an (N, 8 KS) pair.
// Each starts a fresh sum: the tensor core adds into its fp32 accumulator
// by truncation, whose bias grows with the number of adds, so a product
// over a chunk is summed into the running total by an FADD (rounded to
// nearest) instead.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                              int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32_rs<8>(float (&d)[4], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<16>(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<32>(float (&d)[16], uint64_t a, uint64_t b,
                                                int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_ss<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// A K-major operand's descriptor (sw128_desc, lbo 0) at shared address
// addr, and the offset of k-step kk (8 columns) in an (R, *) tile.
__device__ __forceinline__ uint64_t f32_desc(uint32_t addr) {
    return (static_cast<uint64_t>((1024 >> 4) | (1u << 30)) << 32) | ((addr & 0x3FFFF) >> 4);
}
template <int R>
__device__ __forceinline__ uint32_t f32_kofs(int kk) {
    return (kk >> 2) * R * 128 + (kk & 3) * 32;
}

// Shared addresses made opaque where the products are issued, so that their
// descriptors are formed there (an add each) and not held across the loop
// around them (64 of them at D = 128 would take 128 registers).
__device__ __forceinline__ void opaque1(uint32_t& x) { asm volatile("" : "+r"(x)); }
template <typename... T>
__device__ __forceinline__ void opaque(T&... x) {
    (opaque1(x), ...);
}

template <int K, int N, int AR>
__device__ __forceinline__ void gemm3_ss(float (&d)[N / 2], const unsigned char* a_hi,
                                         const unsigned char* a_lo, int a_row0,
                                         const unsigned char* b_hi, const unsigned char* b_lo) {
    uint32_t ah = smem_u32(a_hi) + a_row0 * 128, al = smem_u32(a_lo) + a_row0 * 128;
    uint32_t bh = smem_u32(b_hi), bl = smem_u32(b_lo);
    opaque(ah, al, bh, bl);
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk)
        wgmma_tf32_ss<N>(d, f32_desc(al + f32_kofs<AR>(kk)), f32_desc(bh + f32_kofs<N>(kk)),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk)
        wgmma_tf32_ss<N>(d, f32_desc(ah + f32_kofs<AR>(kk)), f32_desc(bl + f32_kofs<N>(kk)), 1);
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk)
        wgmma_tf32_ss<N>(d, f32_desc(ah + f32_kofs<AR>(kk)), f32_desc(bh + f32_kofs<N>(kk)), 1);
}

// d = A . B, B rows b_row0 .. b_row0 + N - 1 of a (BR, 8 KS) pair.
template <int N, int KS, int BR = N>
__device__ __forceinline__ void gemm3_rs(float (&d)[N / 2], const uint32_t (&a_hi)[KS][4],
                                         const uint32_t (&a_lo)[KS][4],
                                         const unsigned char* b_hi, const unsigned char* b_lo,
                                         int b_row0 = 0) {
    uint32_t bh = smem_u32(b_hi) + b_row0 * 128, bl = smem_u32(b_lo) + b_row0 * 128;
    opaque(bh, bl);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
        wgmma_tf32_rs<N>(d, a_lo[kk], f32_desc(bh + f32_kofs<BR>(kk)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
        wgmma_tf32_rs<N>(d, a_hi[kk], f32_desc(bl + f32_kofs<BR>(kk)), 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
        wgmma_tf32_rs<N>(d, a_hi[kk], f32_desc(bh + f32_kofs<BR>(kk)), 1);
}

// The hi/lo TF32 A fragments of a 64 x N accumulator tile: k-step kk takes
// columns 8 kk .. 8 kk + 7, fragment column t from accumulator column 2 t
// and t + 4 from 2 t + 1 (f32_pos pairs the B rows with them).
template <int N>
__device__ __forceinline__ void split_frags(uint32_t (&hi)[N / 8][4], uint32_t (&lo)[N / 8][4],
                                            const float (&s)[N / 2]) {
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
        const float v[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float h, l;
            tf32_split(v[e], h, l);
            hi[kk][e] = __float_as_uint(h);
            lo[kk][e] = __float_as_uint(l);
        }
    }
}

// No pair of queries [q_first, q_last] and keys [k_first, k_last] lies
// inside the causal and window limits.
__device__ __forceinline__ bool f32_outside(int q_first, int q_last, int k_first, int k_last,
                                            int causal, int window) {
    return (causal && k_first > q_last) || (window > 0 && q_first - k_last >= window);
}

// The chunks of CH rows of the other side that a block walks: chunk kc of kept tile i of the schedule, TILE rows a tile, taken
// in order, passing over chunks past the end or outside the fixed rows'
// causal and window range.  seek moves (i, kc) to the next chunk at or
// after it and says whether there is one.
template <int TILE, int CH, bool FIXED_IS_QUERY>
struct F32Chunks {
    const uint8_t* cls;
    int n, t0, len, f_first, f_last, causal, window;

    __device__ __forceinline__ int row0(int i, int kc) const { return (t0 + i) * TILE + kc * CH; }

    __device__ __forceinline__ bool seek(int& i, int& kc) const {
        for (;; ++i, kc = 0) {
            if (i >= n) return false;
            if (cls[i] == SKIP) continue;
            for (; kc < TILE / CH; ++kc) {
                const int r0 = row0(i, kc);
                if (r0 >= len) break;
                const bool out = FIXED_IS_QUERY
                                     ? f32_outside(f_first, f_last, r0, r0 + CH - 1, causal, window)
                                     : f32_outside(r0, r0 + CH - 1, f_first, f_last, causal, window);
                if (!out) return true;
            }
        }
    }
};

// ---- forward ----

template <int D>
struct F32Fwd {
    static constexpr int DP = D < 32 ? 32 : D;   // the tiles' padded row
    static constexpr int BQ = 128, BK = D == 128 ? 32 : 64;
    static constexpr int QB = BQ * DP * 4, KB = BK * DP * 4, VB = D * BK * 4;
    static constexpr int Q_HI = 0, Q_LO = QB;
    static constexpr int K_HI = 2 * QB, K_LO = K_HI + KB;  // K: (BK, D)
    static constexpr int V_HI = K_LO + KB, V_LO = V_HI + VB;  // V^T: (D, BK)
    static constexpr int SK = V_LO + VB, SV = SK + BK * D * 4;  // the next chunk, raw
    static constexpr int KSEG = SV + BK * D * 4;               // int [BK], and staged
    static constexpr int CLS = KSEG + 2 * BK * 4;
    static size_t bytes(int tiles) { return (size_t)CLS + tiles + 1024; }
};

// One block per (128 queries, head, row), the query tiles last to first,
// as the bf16 forward takes them.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
packed_attn_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const int* __restrict__ seg_q,
                           const int* __restrict__ seg_kv, float* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Skv, int H, int KVH, int causal,
                           int window, float scale) {
    using L = F32Fwd<D>;
    constexpr int BT = L::BQ, BK = L::BK;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    int* kseg = reinterpret_cast<int*>(sm + L::KSEG);
    uint8_t* cls = sm + L::CLS;

    const int nq = (Sq + BT - 1) / BT;
    const int q0 = (nq - 1 - (int)blockIdx.x) * BT, h = blockIdx.y, b = blockIdx.z;
    const int kh = h / (H / KVH);
    const long q_rs = (long)H * D, kv_rs = (long)KVH * D;
    const int* sq_row = seg_q + (long)b * Sq;
    const int* sk_row = seg_kv + (long)b * Skv;
    const float* kb = k + (long)b * Skv * kv_rs + (long)kh * D;
    const float* vb = v + (long)b * Skv * kv_rs + (long)kh * D;

    int kt0, n;
    key_range(q0, BT, BT, Skv, causal, window, kt0, n);
    build_schedule<BT, BT, true, CENSUS_FWD, F32_WARPS>(sq_row, q0, Sq, sk_row, Skv, kt0, n,
                                                        causal, window, cls);
    {
        F32Rows<BT, D> rq;
        rq.load(q + (long)b * Sq * q_rs + (long)h * D, q0, Sq, q_rs);
        rq.put(sm + L::Q_HI, sm + L::Q_LO);
    }
    __syncthreads();  // the schedule is in

    const int c = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
    const int qw0 = q0 + 64 * c;  // the warpgroup's rows
    int qi[2], sq[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        qi[hr] = qw0 + 16 * w + g + 8 * hr;
        sq[hr] = qi[hr] < Sq ? __ldg(sq_row + qi[hr]) : 0;
    }
    // l: this thread's part of the row sums of p (its columns)
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float o[D / 2];
#pragma unroll
    for (int x = 0; x < D / 2; ++x) o[x] = 0.f;

    // The next chunk's K, V and key ids stream into staging by cp.async
    // while this one's products run (a load into registers would hold the
    // products back: wgmma.fence waits for the warp's outstanding loads);
    // each thread splits its own staged rows into the stage once every
    // product is done with it.
    const F32Chunks<BT, BK, true> chunks{cls, n, kt0, Skv, q0, q0 + BT - 1, causal, window};
    int* kseg_st = kseg + BK;
    auto fetch = [&](int k1) {
        F32Rows<BK, D>::stage(sm + L::SK, kb, k1, Skv, kv_rs);
        F32Rows<BK, D>::stage(sm + L::SV, vb, k1, Skv, kv_rs);
        if (threadIdx.x < BK) {
            const bool in = k1 + threadIdx.x < Skv;
            cp_async4(kseg_st + threadIdx.x, in ? sk_row + k1 + threadIdx.x : sk_row, in);
        }
        cp_async_commit();
    };
    int i = 0, kc = 0;
    bool have = chunks.seek(i, kc);
    if (have) fetch(chunks.row0(i, kc));
    while (have) {
        const int k0 = chunks.row0(i, kc);
        const uint8_t cl = cls[i];
        cp_async_wait<0>();
        F32Rows<BK, D> rk, rv;
        rk.unstage(sm + L::SK);
        rv.unstage(sm + L::SV);
        const int kseg_v = threadIdx.x < BK ? kseg_st[threadIdx.x] : 0;
        __syncthreads();  // every product of the last chunk is done with the stage
        rk.put(sm + L::K_HI, sm + L::K_LO);
        rv.put_t(sm + L::V_HI, sm + L::V_LO);
        if (threadIdx.x < BK) kseg[threadIdx.x] = kseg_v;
        fence_async_smem();
        __syncthreads();
        ++kc;
        have = chunks.seek(i, kc);
        if (have) fetch(chunks.row0(i, kc));

        float s[BK / 2];
        wg_fence();
        gemm3_ss<D, BK, BT>(s, sm + L::Q_HI, sm + L::Q_LO, 64 * c, sm + L::K_HI, sm + L::K_LO);
        wg_commit();
        wg_wait<0>();
        keep(s);
        // the online softmax; accumulator x is row half (x >> 1) & 1,
        // column 8 (x >> 2) + 2 t + (x & 1)
        uint32_t ok = ~0u;
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
            const int hr = (x >> 1) & 1, col = 8 * (x >> 2) + 2 * t + (x & 1);
            if (cl == MASKED && !visible(qi[hr], k0 + col, sq[hr], kseg[col], causal, window))
                ok &= ~(1u << x);
            s[x] = (ok >> x) & 1u ? s[x] * scale : NEG_INF;
            mx[hr] = fmaxf(mx[hr], s[x]);
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            float x = mx[hr];
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
            x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
            const float m_new = fmaxf(m[hr], x);
            alpha[hr] = expf(m[hr] - m_new);
            m[hr] = m_new;
        }
#pragma unroll
        for (int x = 0; x < BK / 2; ++x) {
            const int hr = (x >> 1) & 1;
            s[x] = (ok >> x) & 1u ? expf(s[x] - m[hr]) : 0.f;
            rs[hr] += s[x];
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) l[hr] = alpha[hr] * l[hr] + rs[hr];
        uint32_t ph[BK / 8][4], pl[BK / 8][4];
        split_frags<BK>(ph, pl, s);
#pragma unroll
        for (int part = 0; part < 2; ++part) {  // P V, half of D's columns at a time
            float pv[D / 4];
            wg_fence();
            gemm3_rs<D / 2, BK / 8, D>(pv, ph, pl, sm + L::V_HI, sm + L::V_LO, part * D / 2);
            wg_commit();
            wg_wait<0>();
            keep(pv);
            keep(ph);
            keep(pl);
#pragma unroll
            for (int x = 0; x < D / 4; ++x) {
                float& ox = o[part * D / 4 + x];
                ox = fmaf(ox, alpha[(x >> 1) & 1], pv[x]);
            }
        }
    }

    const long o0 = (long)b * Sq * q_rs + (long)h * D;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        float x = l[hr];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        x += __shfl_xor_sync(0xffffffffu, x, 2);
        if (qi[hr] >= Sq) continue;
        const float inv = 1.f / fmaxf(x, 1e-30f);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
            *reinterpret_cast<float2*>(out + o0 + (long)qi[hr] * q_rs + 8 * j + 2 * t) =
                make_float2(o[4 * j + 2 * hr] * inv, o[4 * j + 2 * hr + 1] * inv);
        if (t == 0) lse[((long)b * H + h) * Sq + qi[hr]] = x > 0.f ? m[hr] + logf(x) : INFINITY;
    }
}

// ---- dK/dV ----

// Named barriers among the block's two warpgroups (256 threads) or one
// (128, the warpgroup's own id).
constexpr int NB_HAND = 1, NB_WG1 = 2, NB_WG = 3;

__device__ __forceinline__ void nb_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void nb_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int D>
struct F32Dkdv {
    static constexpr int DP = D < 32 ? 32 : D;
    static constexpr int BQ = 64;                  // the schedule's query tiles
    static constexpr int BQC = D == 128 ? 32 : 64;  // a chunk of one
    static constexpr int MT = D > 64 ? D / 64 : 1;  // 64-row tiles of dK^T, dV^T
    static constexpr int KB = 64 * DP * 4, QB = BQC * DP * 4, PB = 64 * BQC * 4;
    static constexpr int K_HI = 0, K_LO = KB, V_HI = 2 * KB, V_LO = 3 * KB;  // the half's keys
    static constexpr int Q_HI = 4 * KB, Q_LO = Q_HI + QB, DO_HI = Q_LO + QB, DO_LO = DO_HI + QB;
    static constexpr int PT_HI = DO_LO + QB, PT_LO = PT_HI + PB;     // P^T: (64 keys, BQC)
    static constexpr int DST_HI = PT_LO + PB, DST_LO = DST_HI + PB;  // dS^T
    static constexpr int STATS = DST_LO + PB;      // lse, delta, seg: [BQC] each
    static constexpr int CLS = STATS + 3 * BQC * 4;
    static constexpr int EXCH = DST_HI;            // P^T in fp32, before dS^T is stored
    static size_t bytes(int tiles) { return (size_t)CLS + tiles + 1024; }
};

// The hi/lo TF32 A fragments of T^T's rows d0 + 16 w + g (+ 8), k-steps over
// the BQC rows of T: T a natural (BQC, D) pair (already split), read in
// place; rows d >= D of T^T read 0.  Fragment column t is T's row 8 kk + t.
template <int D, int BQC>
__device__ __forceinline__ void t_frags(uint32_t (&hi)[BQC / 8][4], uint32_t (&lo)[BQC / 8][4],
                                        const unsigned char* t_hi, const unsigned char* t_lo,
                                        int d0) {
    const int tid = threadIdx.x % WG, w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
    for (int kk = 0; kk < BQC / 8; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int d = d0 + 16 * w + g + 8 * (e & 1), r = 8 * kk + t + 4 * (e >> 1);
            const int off = f32_chunk<BQC>(r, d >> 2) + (d & 3) * 4;
            const bool in = D >= 64 || d < D;
            hi[kk][e] = in ? *reinterpret_cast<const uint32_t*>(t_hi + off) : 0u;
            lo[kk][e] = in ? *reinterpret_cast<const uint32_t*>(t_lo + off) : 0u;
        }
}

// One block per (64 of a tile's 128 keys, KV head, row); the G query heads
// of its KV head are summed in, each query chunk's heads one after the
// other.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
packed_attn_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const int* __restrict__ seg_q,
                            const int* __restrict__ seg_kv, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
                            int H, int KVH, int causal, int window, float scale) {
    using L = F32Dkdv<D>;
    constexpr int BT = 128, BQ = L::BQ, BQC = L::BQC, MT = L::MT;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    float* st_lse = reinterpret_cast<float*>(sm + L::STATS);
    float* st_delta = st_lse + BQC;
    int* st_seg = reinterpret_cast<int*>(st_delta + BQC);
    float* exch = reinterpret_cast<float*>(sm + L::EXCH);
    uint8_t* cls = sm + L::CLS;

    const int k0 = (blockIdx.x >> 1) * BT, kh = blockIdx.y, b = blockIdx.z;
    const int kh0 = k0 + 64 * (blockIdx.x & 1);  // the block's half of the 128 keys
    if (kh0 >= Skv) return;
    const int G = H / KVH;
    const long q_rs = (long)H * D, kv_rs = (long)KVH * D;
    const long kv_off = (long)b * Skv * kv_rs + (long)kh * D;
    const int* sq_row = seg_q + (long)b * Sq;
    const int* sk_row = seg_kv + (long)b * Skv;

    int qt0, n;
    query_range(k0, BT, BQ, Sq, causal, window, qt0, n);
    build_schedule<BT, BQ, false, CENSUS_DKDV, F32_WARPS>(sk_row, k0, Skv, sq_row, Sq, qt0, n,
                                                          causal, window, cls, kh0 == k0);
    const int c = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;

    {
        __syncthreads();  // the schedule is in
        {
            F32Rows<64, D> rk;
            rk.load(k + kv_off, kh0, Skv, kv_rs);
            rk.put(sm + L::K_HI, sm + L::K_LO);
            rk.load(v + kv_off, kh0, Skv, kv_rs);
            rk.put(sm + L::V_HI, sm + L::V_LO);
        }
        int kj[2], sk[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            kj[hr] = kh0 + 16 * w + g + 8 * hr;
            sk[hr] = kj[hr] < Skv ? __ldg(sk_row + kj[hr]) : 0;
        }
        float acc[MT][32];  // dV^T (warpgroup 0) or dK^T (warpgroup 1): rows d, columns keys
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int x = 0; x < 32; ++x) acc[mt][x] = 0.f;

        // chunks (i, qc) of kept tiles, each for every head hg in turn
        const F32Chunks<BQ, BQC, false> chunks{cls, n, qt0, Sq, kh0, kh0 + 63, causal, window};
        int i = 0, qc = 0, hg = 0;
        bool have = chunks.seek(i, qc);
        F32Rows<BQC, D> rq, rdo;
        float n_lse = 0.f, n_delta = 0.f;
        int n_seg = 0;
        auto fetch = [&](int i_, int qc_, int hg_) {
            const int q0c = chunks.row0(i_, qc_), hd = kh * G + hg_;
            const long q_off = (long)b * Sq * q_rs + (long)hd * D;
            rq.load(q + q_off, q0c, Sq, q_rs);
            rdo.load(dout + q_off, q0c, Sq, q_rs);
            if (threadIdx.x < BQC) {
                const int qi = q0c + threadIdx.x;
                const long ro = ((long)b * H + hd) * Sq + qi;
                const bool in = qi < Sq;
                n_lse = in ? __ldg(lse + ro) : INFINITY;
                n_delta = in ? __ldg(delta + ro) : 0.f;
                n_seg = in ? __ldg(sq_row + qi) : 0;
            }
        };
        if (have) fetch(i, qc, hg);
        while (have) {
            const int q0c = chunks.row0(i, qc);
            const uint8_t cl = cls[i];
            __syncthreads();  // every product of the last chunk is done with the stage
            rq.put(sm + L::Q_HI, sm + L::Q_LO);
            rdo.put(sm + L::DO_HI, sm + L::DO_LO);
            if (threadIdx.x < BQC) {
                st_lse[threadIdx.x] = n_lse;
                st_delta[threadIdx.x] = n_delta;
                st_seg[threadIdx.x] = n_seg;
            }
            fence_async_smem();
            __syncthreads();
            // the next chunk: the next head of this one, else the next chunk
            if (++hg == G) {
                hg = 0;
                ++qc;
                have = chunks.seek(i, qc);
            }

            // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), rows
            // keys; every product is issued by both warpgroups alike, on
            // operands picked by warpgroup (a wgmma on a branch is serialised)
            float s[BQC / 2];
            wg_fence();
            gemm3_ss<D, BQC, 64>(s, sm + (c ? L::V_HI : L::K_HI), sm + (c ? L::V_LO : L::K_LO), 0,
                                 sm + (c ? L::DO_HI : L::Q_HI), sm + (c ? L::DO_LO : L::Q_LO));
            wg_commit();
            // the next chunk's loads go out once the products are issued:
            // wgmma.fence waits for a warp's loads in flight, and the next
            // one is the second product's, after this one and the
            // elementwise work
            if (have) fetch(i, qc, hg);
            wg_wait<0>();
            keep(s);
            if (c == 0) {
                // P^T = exp(S^T scale - lse) on the visible pairs: to warpgroup 1
                // in fp32, and split as the B operand of dV^T = dO^T P^T
#pragma unroll
                for (int x = 0; x < BQC / 2; ++x) {
                    const int hr = (x >> 1) & 1, col = 8 * (x >> 2) + 2 * t + (x & 1);
                    const bool ok = cl == FULL || visible(q0c + col, kj[hr], st_seg[col], sk[hr],
                                                          causal, window);
                    s[x] = ok ? expf(s[x] * scale - st_lse[col]) : 0.f;
                    exch[x * WG + tid] = s[x];
                }
                nb_arrive(NB_HAND, 2 * WG);
            } else {
                nb_sync(NB_HAND, 2 * WG);
                // dS^T = P^T (dP^T - delta)
#pragma unroll
                for (int x = 0; x < BQC / 2; ++x) {
                    const int col = 8 * (x >> 2) + 2 * t + (x & 1);
                    s[x] = exch[x * WG + tid] * (s[x] - st_delta[col]);
                }
                nb_sync(NB_WG1, WG);  // warpgroup 1 has read P^T where dS^T goes
            }
            {
                unsigned char* th = sm + (c ? L::DST_HI : L::PT_HI);
                unsigned char* tl = sm + (c ? L::DST_LO : L::PT_LO);
#pragma unroll
                for (int x = 0; x < BQC / 2; x += 2) {
                    const int hr = (x >> 1) & 1, col = 8 * (x >> 2) + 2 * t;
                    const int off = f32_chunk<64>(16 * w + g + 8 * hr, col >> 2) + (col & 3) * 4;
                    float2 h, l;
                    tf32_split(s[x], h.x, l.x);
                    tf32_split(s[x + 1], h.y, l.y);
                    *reinterpret_cast<float2*>(th + off) = h;
                    *reinterpret_cast<float2*>(tl + off) = l;
                }
            }
            fence_async_smem();
            nb_sync(NB_WG + c, WG);  // the warpgroup's tile is in
            // dV^T += dO^T P^T (warpgroup 0), dK^T += Q^T dS^T (warpgroup 1): A
            // read from the natural tiles, B the (64 keys, BQC) tile
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
                uint32_t fh[BQC / 8][4], fl[BQC / 8][4];
                t_frags<D, BQC>(fh, fl, sm + (c ? L::Q_HI : L::DO_HI), sm + (c ? L::Q_LO : L::DO_LO),
                                64 * mt);
                float part[32];
                wg_fence();
                gemm3_rs<64, BQC / 8>(part, fh, fl, sm + (c ? L::DST_HI : L::PT_HI),
                                      sm + (c ? L::DST_LO : L::PT_LO));
                wg_commit();
                wg_wait<0>();
                keep(part);
                keep(fh);
                keep(fl);
#pragma unroll
                for (int x = 0; x < 32; ++x) acc[mt][x] += part[x];
            }
        }

        // acc[mt][4 j + 2 hr + e]: row d = 64 mt + 16 w + g + 8 hr, key kh0 + 8 j + 2 t + e
        float* dst = (c == 0 ? dv : dk) + kv_off;
        const float mul = c == 0 ? 1.f : scale;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int x = 0; x < 32; ++x) {
                const int d = 64 * mt + 16 * w + g + 8 * ((x >> 1) & 1);
                const int kj_ = kh0 + 8 * (x >> 2) + 2 * t + (x & 1);
                if ((D >= 64 || d < D) && kj_ < Skv) dst[(long)kj_ * kv_rs + d] = acc[mt][x] * mul;
            }
    }
}

// ---- dQ ----

template <int D>
struct F32Dq {
    static constexpr int DP = D < 32 ? 32 : D;
    static constexpr int BQ = 64;                  // the block's half of a query tile
    static constexpr int BK = D == 128 ? 32 : 64;  // a chunk of a key tile
    static constexpr int QB = BQ * DP * 4, KB = BK * DP * 4, TB = D * BK * 4;
    static constexpr int Q_HI = 0, Q_LO = QB, DO_HI = 2 * QB, DO_LO = 3 * QB;
    static constexpr int K_HI = 4 * QB, K_LO = K_HI + KB, V_HI = K_LO + KB, V_LO = V_HI + KB;
    static constexpr int KT_HI = V_LO + KB, KT_LO = KT_HI + TB;  // K^T: (D, BK)
    static constexpr int KSEG = KT_LO + TB;                       // int [BK]
    static constexpr int CLS = KSEG + BK * 4;
    // P and dP, (64, BK) fp32 each, go to the K and V pairs once S and dP are in
    static_assert(64 * BK <= 2 * BK * DP, "P and dP fit in the K and V pairs");
    static size_t bytes(int tiles) { return (size_t)CLS + tiles + 1024; }
};

// One block per (64 of a tile's 128 queries, head, row), the query tiles
// last to first.
template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
packed_attn_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const int* __restrict__ seg_q,
                          const int* __restrict__ seg_kv, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dq, int Sq, int Skv, int H, int KVH, int causal,
                          int window, float scale) {
    using L = F32Dq<D>;
    constexpr int BT = 128, BK = L::BK;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sm = align1024(smem_raw);
    int* kseg = reinterpret_cast<int*>(sm + L::KSEG);
    float* p_s = reinterpret_cast<float*>(sm + L::K_HI);  // P, once S is in
    float* dp_s = reinterpret_cast<float*>(sm + L::V_HI);  // dP, once it is in
    uint8_t* cls = sm + L::CLS;

    const int nq = (Sq + BT - 1) / BT;
    const int q0 = (nq - 1 - (int)(blockIdx.x >> 1)) * BT, h = blockIdx.y, b = blockIdx.z;
    const int qh = q0 + 64 * (blockIdx.x & 1);  // the block's half of the 128 queries
    if (qh >= Sq) return;
    const int kh = h / (H / KVH);
    const long q_rs = (long)H * D, kv_rs = (long)KVH * D;
    const long q_off = (long)b * Sq * q_rs + (long)h * D;
    const long kv_off = (long)b * Skv * kv_rs + (long)kh * D;
    const long r_off = ((long)b * H + h) * Sq;
    const int* sq_row = seg_q + (long)b * Sq;
    const int* sk_row = seg_kv + (long)b * Skv;

    int kt0, n;
    key_range(q0, BT, BT, Skv, causal, window, kt0, n);
    build_schedule<BT, BT, true, CENSUS_DQ, F32_WARPS>(sq_row, q0, Sq, sk_row, Skv, kt0, n,
                                                       causal, window, cls, qh == q0);
    const int c = threadIdx.x / WG, tid = threadIdx.x % WG;
    const int w = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;

    {
        __syncthreads();  // the schedule is in
        {
            F32Rows<64, D> rq;
            rq.load(q + q_off, qh, Sq, q_rs);
            rq.put(sm + L::Q_HI, sm + L::Q_LO);
            rq.load(dout + q_off, qh, Sq, q_rs);
            rq.put(sm + L::DO_HI, sm + L::DO_LO);
        }
        int qi[2], sq[2];
        float lq[2], dl[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            qi[hr] = qh + 16 * w + g + 8 * hr;
            const bool in = qi[hr] < Sq;
            sq[hr] = in ? __ldg(sq_row + qi[hr]) : 0;
            lq[hr] = in ? __ldg(lse + r_off + qi[hr]) : INFINITY;
            dl[hr] = in ? __ldg(delta + r_off + qi[hr]) : 0.f;
        }
        float gq[D / 4];  // the warpgroup's half of dQ's columns
#pragma unroll
        for (int x = 0; x < D / 4; ++x) gq[x] = 0.f;

        // The next chunk's K, V and key ids are loaded into registers while
        // this one's products run.
        const F32Chunks<BT, BK, true> chunks{cls, n, kt0, Skv, qh, qh + 63, causal, window};
        F32Rows<BK, D> rk, rv;
        int kseg_next = 0;
        auto fetch = [&](int k1) {
            rk.load(k + kv_off, k1, Skv, kv_rs);
            rv.load(v + kv_off, k1, Skv, kv_rs);
            if (threadIdx.x < BK)
                kseg_next = k1 + threadIdx.x < Skv ? __ldg(sk_row + k1 + threadIdx.x) : 0;
        };
        int i = 0, kc = 0;
        bool have = chunks.seek(i, kc);
        if (have) fetch(chunks.row0(i, kc));
        while (have) {
            const int k0 = chunks.row0(i, kc);
            const uint8_t cl = cls[i];
            __syncthreads();  // every product of the last chunk is done with the stage
            rk.put(sm + L::K_HI, sm + L::K_LO);
            rk.put_t(sm + L::KT_HI, sm + L::KT_LO);
            rv.put(sm + L::V_HI, sm + L::V_LO);
            if (threadIdx.x < BK) kseg[threadIdx.x] = kseg_next;
            fence_async_smem();
            __syncthreads();
            ++kc;
            have = chunks.seek(i, kc);

            // S = Q K^T (warpgroup 0) or dP = dO V^T (warpgroup 1), on operands
            // picked by warpgroup (a wgmma on a branch is serialised)
            float s[BK / 2];
            wg_fence();
            gemm3_ss<D, BK, 64>(s, sm + (c ? L::DO_HI : L::Q_HI), sm + (c ? L::DO_LO : L::Q_LO), 0,
                                sm + (c ? L::V_HI : L::K_HI), sm + (c ? L::V_LO : L::K_LO));
            wg_commit();
            // the next chunk's loads go out once the products are issued, as
            // in dK/dV
            if (have) fetch(chunks.row0(i, kc));
            wg_wait<0>();
            keep(s);
            if (c == 0) {
                // P = exp(S scale - lse) on the visible pairs, where K was
#pragma unroll
                for (int x = 0; x < BK / 2; ++x) {
                    const int hr = (x >> 1) & 1, col = 8 * (x >> 2) + 2 * t + (x & 1);
                    const bool ok = cl == FULL || visible(qi[hr], k0 + col, sq[hr], kseg[col],
                                                          causal, window);
                    p_s[x * WG + tid] = ok ? expf(s[x] * scale - lq[hr]) : 0.f;
                }
            } else {
#pragma unroll
                for (int x = 0; x < BK / 2; ++x) dp_s[x * WG + tid] = s[x];  // where V was
            }
            __syncthreads();  // P and dP are in
            // dS = P (dP - delta) in both; each warpgroup takes half of dQ's
            // columns: dQ[:, c D / 2 ..] += dS K[:, c D / 2 ..]
#pragma unroll
            for (int x = 0; x < BK / 2; ++x)
                s[x] = p_s[x * WG + tid] * (dp_s[x * WG + tid] - dl[(x >> 1) & 1]);
            uint32_t fh[BK / 8][4], fl[BK / 8][4];
            split_frags<BK>(fh, fl, s);
            float part[D / 4];
            wg_fence();
            gemm3_rs<D / 2, BK / 8, D>(part, fh, fl, sm + L::KT_HI, sm + L::KT_LO, c * D / 2);
            wg_commit();
            wg_wait<0>();
            keep(part);
            keep(fh);
            keep(fl);
#pragma unroll
            for (int x = 0; x < D / 4; ++x) gq[x] += part[x];
        }

#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            if (qi[hr] >= Sq) continue;
            float* row = dq + q_off + (long)qi[hr] * q_rs + c * D / 2;
#pragma unroll
            for (int j = 0; j < D / 16; ++j)
                *reinterpret_cast<float2*>(row + 8 * j + 2 * t) =
                    make_float2(gq[4 * j + 2 * hr] * scale, gq[4 * j + 2 * hr + 1] * scale);
        }
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int ERR_UNSUPPORTED = -1;
constexpr int ERR_TENSOR_MAP = -2;
constexpr int ERR_TOO_LONG = -3;

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// Head dims 16 and 32: the mma.sync kernels.
template <int D>
int launch_fwd_mma(const void* q, const void* k, const void* v, const void* seg_q,
                   const void* seg_kv, void* out, void* out_lo, void* lse, int B, int Sq,
                   int Skv, int H, int KVH, int causal, int window, float scale,
                   cudaStream_t st) {
    const dim3 grid((Sq + BQ - 1) / BQ, H, B);
    auto kernel = packed_attn_fwd_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, fwd_mma_smem<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, MMA_THREADS, fwd_mma_smem<D>(), st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const int*>(seg_q),
        static_cast<const int*>(seg_kv), static_cast<bf16*>(out), static_cast<bf16*>(out_lo),
        static_cast<float*>(lse), Sq, Skv, H, KVH, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_mma(const void* q, const void* k, const void* v, const void* seg_q,
                   const void* seg_kv, const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                   int causal, int window, float scale, cudaStream_t st) {
    const dim3 kv_grid((Skv + BK - 1) / BK, KVH, B), q_grid((Sq + BQ - 1) / BQ, H, B);
    auto dkdv = packed_attn_dkdv_mma_kernel<D>;
    cudaError_t err = allow_smem(dkdv, bwd_mma_smem<D>());
    if (err != cudaSuccess) return static_cast<int>(err);
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

// Head dims 64 and 128: TMA tensor maps, encoded on the host per call by the
// driver's cuTensorMapEncodeTiled (found through the runtime, so the library
// links nothing but the runtime).
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

// A (B, S, heads, D) bf16 tensor in the model layout, read in boxes of 64
// columns (128 bytes, swizzled by 128 bytes) by `rows` rows of one head of
// one batch row; coordinates (d, head, row, batch).  Rows past S read as 0.
bool make_map(CUtensorMap* map, const void* base, int B, int S, int heads, int D, int rows) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                   (cuuint64_t)S * heads * D * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                  strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of k or v; with no key at all, of q (the kernels then read nothing).
bool make_kv_map(CUtensorMap* map, const void* kv, const void* q, int B, int Sq, int Skv,
                 int H, int KVH, int D, int rows) {
    return Skv > 0 ? make_map(map, kv, B, Skv, KVH, D, rows)
                   : make_map(map, q, B, Sq, H, D, rows);
}

// The shared memory a block takes with a schedule of `tiles` tiles, or 0 if
// the card has less.
template <typename L>
size_t schedule_smem(int tiles) {
    int dev = 0, most = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
        return 0;
    const size_t bytes = L::bytes(tiles);
    return bytes <= (size_t)most ? bytes : 0;
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, const void* seg_q,
                     const void* seg_kv, void* out, void* out_lo, void* lse, int B, int Sq,
                     int Skv, int H, int KVH, int causal, int window, float scale,
                     cudaStream_t st) {
    using L = FwdLayout<D>;
    const size_t smem = schedule_smem<L>((Skv + L::BK - 1) / L::BK);
    if (smem == 0) return ERR_TOO_LONG;
    CUtensorMap tq, tk, tv;
    if (!make_map(&tq, q, B, Sq, H, D, L::BQ) ||
        !make_kv_map(&tk, k, q, B, Sq, Skv, H, KVH, D, L::BK) ||
        !make_kv_map(&tv, v, q, B, Sq, Skv, H, KVH, D, L::BK))
        return ERR_TENSOR_MAP;
    auto kernel = out_lo != nullptr ? packed_attn_fwd_wgmma_kernel<D, true>
                                    : packed_attn_fwd_wgmma_kernel<D, false>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Sq + L::BQ - 1) / L::BQ, H, B);
    kernel<<<grid, HOP_THREADS, smem, st>>>(
        tq, tk, tv, static_cast<const int*>(seg_q), static_cast<const int*>(seg_kv),
        static_cast<bf16*>(out), static_cast<bf16*>(out_lo), static_cast<float*>(lse), Sq, Skv,
        H, KVH, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* seg_q,
                     const void* seg_kv, const void* dout, const void* lse, const void* delta,
                     void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                     int causal, int window, float scale, cudaStream_t st) {
    using KL = DkdvLayout<D>;
    using QL = DqLayout<D>;
    const size_t kv_smem = schedule_smem<KL>((Sq + KL::BQ - 1) / KL::BQ);
    const size_t q_smem = schedule_smem<QL>((Skv + QL::BK - 1) / QL::BK);
    if (kv_smem == 0 || q_smem == 0) return ERR_TOO_LONG;
    static_assert(KL::BK == QL::BK, "one K and one V map serve both kernels");
    CUtensorMap tq_kv, tdo_kv, tq_q, tdo_q, tk, tv;  // Q and dO boxes of each kernel's rows
    if (!make_map(&tq_kv, q, B, Sq, H, D, KL::BQ) ||
        !make_map(&tdo_kv, dout, B, Sq, H, D, KL::BQ) ||
        !make_map(&tq_q, q, B, Sq, H, D, QL::BQ) ||
        !make_map(&tdo_q, dout, B, Sq, H, D, QL::BQ) ||
        !make_map(&tk, k, B, Skv, KVH, D, KL::BK) || !make_map(&tv, v, B, Skv, KVH, D, KL::BK))
        return ERR_TENSOR_MAP;
    const int* sq = static_cast<const int*>(seg_q);
    const int* sk = static_cast<const int*>(seg_kv);
    const float* ls = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);

    auto dkdv = packed_attn_dkdv_wgmma_kernel<D>;
    cudaError_t err = allow_smem(dkdv, kv_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv<<<dim3((Skv + KL::BK - 1) / KL::BK, KVH, B), HOP_THREADS, kv_smem, st>>>(
        tq_kv, tdo_kv, tk, tv, sq, sk, ls, dl, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Sq, Skv, H, KVH, causal, window, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    auto dqk = packed_attn_dq_wgmma_kernel<D>;
    if ((err = allow_smem(dqk, q_smem)) != cudaSuccess) return static_cast<int>(err);
    dqk<<<dim3((Sq + QL::BQ - 1) / QL::BQ, H, B), HOP_THREADS, q_smem, st>>>(
        tq_q, tdo_q, tk, tv, sq, sk, ls, dl, static_cast<bf16*>(dq), Sq, Skv, H, KVH,
        causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

// float32, every head dim: the 3xTF32 wgmma kernels, two warpgroups a block;
// dK/dV and dQ take a block for each 64-row half of their 128-row tiles.
template <int D>
int launch_fwd_f32(const void* q, const void* k, const void* v, const void* seg_q,
                   const void* seg_kv, void* out, void* lse, int B, int Sq, int Skv, int H,
                   int KVH, int causal, int window, float scale, cudaStream_t st) {
    const size_t smem = schedule_smem<F32Fwd<D>>((Skv + 127) / 128);
    if (smem == 0) return ERR_TOO_LONG;
    auto kernel = packed_attn_fwd_f32_kernel<D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3((Sq + 127) / 128, H, B), F32_THREADS, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const int*>(seg_q),
        static_cast<const int*>(seg_kv), static_cast<float*>(out), static_cast<float*>(lse),
        Sq, Skv, H, KVH, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_f32(const void* q, const void* k, const void* v, const void* seg_q,
                   const void* seg_kv, const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                   int causal, int window, float scale, cudaStream_t st) {
    const size_t kv_smem = schedule_smem<F32Dkdv<D>>((Sq + 63) / 64);
    const size_t q_smem = schedule_smem<F32Dq<D>>((Skv + 127) / 128);
    if (kv_smem == 0 || q_smem == 0) return ERR_TOO_LONG;
    const float* qf = static_cast<const float*>(q);
    const float* kf = static_cast<const float*>(k);
    const float* vf = static_cast<const float*>(v);
    const int* sq = static_cast<const int*>(seg_q);
    const int* sk = static_cast<const int*>(seg_kv);
    const float* go = static_cast<const float*>(dout);
    const float* ls = static_cast<const float*>(lse);
    const float* dl = static_cast<const float*>(delta);

    auto dkdv = packed_attn_dkdv_f32_kernel<D>;
    cudaError_t err = allow_smem(dkdv, kv_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkdv<<<dim3(2 * ((Skv + 127) / 128), KVH, B), F32_THREADS, kv_smem, st>>>(
        qf, kf, vf, sq, sk, go, ls, dl, static_cast<float*>(dk), static_cast<float*>(dv), Sq,
        Skv, H, KVH, causal, window, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    auto dqk = packed_attn_dq_f32_kernel<D>;
    if ((err = allow_smem(dqk, q_smem)) != cudaSuccess) return static_cast<int>(err);
    dqk<<<dim3(2 * ((Sq + 127) / 128), H, B), F32_THREADS, q_smem, st>>>(
        qf, kf, vf, sq, sk, go, ls, dl, static_cast<float*>(dq), Sq, Skv, H, KVH, causal,
        window, scale);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_delta(const void* out, const void* out_lo, const void* dout, void* delta, int B,
                 int Sq, int H, int D, cudaStream_t st) {
    const long rows = (long)B * Sq * H;
    const int warps = DELTA_THREADS / 32;
    packed_attn_delta_kernel<T><<<(unsigned)((rows + warps - 1) / warps), DELTA_THREADS, 0,
                                  st>>>(
        static_cast<const T*>(out), static_cast<const T*>(out_lo), static_cast<const T*>(dout),
        static_cast<float*>(delta), B, Sq, H, D);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes), bf16 tensors (the float32 ones
// below take fp32 tensors).  Each launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after its
// launches, or a negative code of its own (packed_attn_error_string).
// packed_attn_fwd writes out_lo (the header's semantics) when `residual` is
// set (out_lo is then a tensor of out's shape), and nothing more when it is
// not; packed_attn_bwd takes delta from out + out_lo.
extern "C" int packed_attn_fwd(const void* q, const void* k, const void* v,
                               const void* seg_q, const void* seg_kv, void* out,
                               void* out_lo, void* lse, int B, int Sq, int Skv, int H,
                               int KVH, int D, int causal, int window, int residual,
                               float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!residual) out_lo = nullptr;
    switch (D) {
        case 16: return launch_fwd_mma<16>(q, k, v, seg_q, seg_kv, out, out_lo, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 32: return launch_fwd_mma<32>(q, k, v, seg_q, seg_kv, out, out_lo, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 64: return launch_fwd_wgmma<64>(q, k, v, seg_q, seg_kv, out, out_lo, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 128: return launch_fwd_wgmma<128>(q, k, v, seg_q, seg_kv, out, out_lo, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        default: return ERR_UNSUPPORTED;
    }
}

extern "C" int packed_attn_bwd(const void* q, const void* k, const void* v,
                               const void* seg_q, const void* seg_kv, const void* out,
                               const void* out_lo, const void* dout, const void* lse,
                               void* delta, void* dq,
                               void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                               int D, int causal, int window, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D != 16 && D != 32 && D != 64 && D != 128) return ERR_UNSUPPORTED;
    const int err = launch_delta<bf16>(out, out_lo, dout, delta, B, Sq, H, D, st);
    if (err != 0) return err;
    switch (D) {
        case 16: return launch_bwd_mma<16>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 32: return launch_bwd_mma<32>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 64: return launch_bwd_wgmma<64>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        default: return launch_bwd_wgmma<128>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
    }
}

// The float32 entries: the same, with no residual (packed_attn_bwd_f32
// takes delta from out alone).
extern "C" int packed_attn_fwd_f32(const void* q, const void* k, const void* v,
                                   const void* seg_q, const void* seg_kv, void* out, void* lse,
                                   int B, int Sq, int Skv, int H, int KVH, int D, int causal,
                                   int window, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 16: return launch_fwd_f32<16>(q, k, v, seg_q, seg_kv, out, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 32: return launch_fwd_f32<32>(q, k, v, seg_q, seg_kv, out, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 64: return launch_fwd_f32<64>(q, k, v, seg_q, seg_kv, out, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 128: return launch_fwd_f32<128>(q, k, v, seg_q, seg_kv, out, lse, B, Sq, Skv, H, KVH, causal, window, scale, st);
        default: return ERR_UNSUPPORTED;
    }
}

extern "C" int packed_attn_bwd_f32(const void* q, const void* k, const void* v,
                                   const void* seg_q, const void* seg_kv, const void* out,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Skv, int H, int KVH,
                                   int D, int causal, int window, float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (D != 16 && D != 32 && D != 64 && D != 128) return ERR_UNSUPPORTED;
    const int err = launch_delta<float>(out, nullptr, dout, delta, B, Sq, H, D, st);
    if (err != 0) return err;
    switch (D) {
        case 16: return launch_bwd_f32<16>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 32: return launch_bwd_f32<32>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        case 64: return launch_bwd_f32<64>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
        default: return launch_bwd_f32<128>(q, k, v, seg_q, seg_kv, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, causal, window, scale, st);
    }
}

// The tile census of the current device: copies the counts taken since the
// last call into counts[kernel * 3 + class] (kernels forward, dK/dV, dQ;
// classes skipped, masked, full), zeroes them and turns counting on or off.
// Synchronises with the device.
extern "C" int packed_attn_tile_census(int on, unsigned long long* counts) {
    cudaError_t err = cudaDeviceSynchronize();
    if (err == cudaSuccess) err = cudaMemcpyFromSymbol(counts, g_census, sizeof(g_census));
    static const unsigned long long zero[3][3] = {};
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_census, zero, sizeof(zero));
    if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_census_on, &on, sizeof(on));
    if (err == cudaSuccess) err = cudaDeviceSynchronize();
    return static_cast<int>(err);
}

extern "C" const char* packed_attn_error_string(int code) {
    switch (code) {
        case ERR_UNSUPPORTED: return "unsupported head dim (want 16, 32, 64 or 128)";
        case ERR_TENSOR_MAP: return "TMA tensor map encoding failed";
        case ERR_TOO_LONG: return "a row too long for its tile schedule in shared memory";
        default: return cudaGetErrorString(static_cast<cudaError_t>(code));
    }
}
