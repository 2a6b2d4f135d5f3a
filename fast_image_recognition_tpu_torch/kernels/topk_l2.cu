// Exact L2 top-k (k <= 16) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_topk_kernel` with its `_merge_topk`
// carry (fast_image_recognition_tpu/ops/distance_kernel.py:92 and :57,
// launched by `_topk_l2_block` :988), in all its variants. Per query and
// gallery row
//
//     d = max(|q|^2 + |g|^2 - 2 q.g, 0)
//
// in fp32; rows >= n_valid never enter the result; ties go to the lowest
// global row index (the TPU kernel's masked argmin plus its carry-first
// merge); slots beyond the valid rows stay (BIG_DIST, -1). A feature window
// [start, end) zeroes the lanes outside it in q, in g and in |q|^2 (the
// wrapper divides by end - start instead of D).
//
// `topk_l2_launch`: bf16 queries and rows, bf16 x bf16 -> fp32 tensor-core
// products. An optional per-query mask skips the query blocks that hold no
// masked query (one launch serves an escalation that may be empty without
// a host sync). Bound: at B = 1024 against 1M x 1280 bf16 the work is
// 2*B*N*D = 2.6 TFLOP against 2.6 GB: operations bound (2.65 ms at 989
// TFLOP/s vs 0.78 ms at 3.35 TB/s).
//
// `topk_l2_precise_launch` (`precise=True`, the fp32 oracle): fp32 queries
// against rows stored in fp32 or in bf16 (upcast per tile, exact), an fp32
// contraction with fp32 accumulation on the CUDA cores (FFMA; no TF32 and
// no tensor cores, so every product and sum is an IEEE fp32 operation, as
// in the JAX package's HIGHEST-precision dot). Bound: 2.6-3.1 TFLOP at 67
// TFLOP/s of fp32 FMA, 39-47 ms, operations bound.
//
// Design, two passes:
//  1. grid (64-query block, 8192-row gallery segment). The block streams
//     its segment in 128-row sub-tiles, each in feature chunks through
//     shared memory (bf16: WMMA over 64-wide chunks; precise: a register-
//     blocked FFMA product of 8 rows x 4 queries per thread over 32-wide
//     chunks stored k-major); the squared norms of the same rows are summed
//     from the registers that load them. Each thread keeps a register top-K
//     of (distance, row) for one query over every fourth row; the four lists
//     of a query merge in shared memory and the segment's top-K goes to a
//     [B, n_seg, K] scratch.
//  2. one thread per query merges its n_seg lists into the final top-k.
// K is a compile-time power of two >= k so the lists stay in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float BIG_DIST = 3.4e38f;
constexpr int NO_ROW = INT32_MAX;  // empty slot; becomes -1 on output
constexpr int QB = 64;             // queries per block
constexpr int RB = 128;            // gallery rows per sub-tile
constexpr int KC = 64;             // feature chunk
constexpr int THREADS = 256;       // 8 warps
constexpr int PAD = 8;             // bf16 row padding in shared memory
constexpr int LDS = KC + PAD;      // bf16 elements per staged row
constexpr int ACC_LD = QB + 4;     // fp32 tile, [row][query]
constexpr int SEG_ROWS = 8192;     // gallery rows per pass-1 block
constexpr int PHASES = THREADS / QB;  // threads sharing one query

constexpr size_t SMEM_Q = (size_t)QB * LDS * 2;
constexpr size_t SMEM_G = (size_t)RB * LDS * 2;
constexpr size_t SMEM_ACC = (size_t)RB * ACC_LD * 4;
constexpr size_t SMEM_BYTES = SMEM_Q + SMEM_G + SMEM_ACC + (QB + RB) * 4;

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
    return d < bd || (d == bd && i < bi);
}

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int i) {
    if (!before(d, i, bd[K - 1], bi[K - 1])) return;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (before(d, i, bd[j], bi[j])) {
            const float td = bd[j];
            const int ti = bi[j];
            bd[j] = d; bi[j] = i;
            d = td; i = ti;
        }
    }
}

__device__ __forceinline__ float sq8(uint4 v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        s = fmaf(f.x, f.x, s);
        s = fmaf(f.y, f.y, s);
    }
    return s;
}

// Loads the 8 bf16 values [col, col + 8) of row `row` of a [rows, D]
// matrix as one 16-byte vector, zero past the last row and outside the
// feature window [start, end).
__device__ __forceinline__ uint4 load_vec(const __nv_bfloat16* m, long row, long rows, int D,
                                          int col, int start, int end) {
    if (row >= rows || col >= end || col + 8 <= start) return make_uint4(0u, 0u, 0u, 0u);
    uint4 v = *reinterpret_cast<const uint4*>(m + row * (long)D + col);
    if (col < start || col + 8 > end) {
        __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
            if (col + j < start || col + j >= end) h[j] = __float2bfloat16_rn(0.0f);
    }
    return v;
}

// Merges the PHASES lists of each query of the block through shared memory
// (which the caller no longer needs) and writes the segment's top-K.
template <int K>
__device__ __forceinline__ void emit_segment(unsigned char* smem, float (&bd)[K], int (&bi)[K],
                                             int eq, int ep, int q0, int B, int seg, int n_seg,
                                             float* __restrict__ part_d, int* __restrict__ part_i) {
    float* ld_s = reinterpret_cast<float*>(smem);  // [PHASES][QB][K]
    int* li_s = reinterpret_cast<int*>(ld_s + PHASES * QB * K);
#pragma unroll
    for (int j = 0; j < K; ++j) {
        ld_s[(ep * QB + eq) * K + j] = bd[j];
        li_s[(ep * QB + eq) * K + j] = bi[j];
    }
    __syncthreads();
    if (ep == 0) {
        for (int p = 1; p < PHASES; ++p)
#pragma unroll
            for (int j = 0; j < K; ++j)
                insert<K>(bd, bi, ld_s[(p * QB + eq) * K + j], li_s[(p * QB + eq) * K + j]);
        const int qi = q0 + eq;
        if (qi < B) {
            const size_t o = ((size_t)qi * n_seg + seg) * K;
#pragma unroll
            for (int j = 0; j < K; ++j) { part_d[o + j] = bd[j]; part_i[o + j] = bi[j]; }
        }
    }
}

// The epilogue of one sub-tile: distances of (every PHASES-th row, query
// eq) from the cross products in acc_s and the norms, into the top-K.
template <int K>
__device__ __forceinline__ void scan_subtile(const float* acc_s, const float* qsq_s,
                                             const float* gsq_s, long r0, long seg1, int eq,
                                             int ep, float (&bd)[K], int (&bi)[K]) {
    const float qsq = qsq_s[eq];
    for (int r = ep; r < RB; r += PHASES) {
        const long row = r0 + r;
        if (row >= seg1) break;
        const float cross = acc_s[r * ACC_LD + eq];
        const float d = fmaxf(__fsub_rn(__fadd_rn(qsq, gsq_s[r]), __fmul_rn(2.0f, cross)), 0.0f);
        insert<K>(bd, bi, d, (int)row);
    }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
topk_pass1(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ g,
           const uint8_t* __restrict__ row_mask, float* __restrict__ part_d,
           int* __restrict__ part_i, int B, int N, int n_valid, int D, int n_seg, int start,
           int end) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);               // [QB][LDS]
    __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(smem + SMEM_Q);      // [RB][LDS]
    float* acc_s = reinterpret_cast<float*>(smem + SMEM_Q + SMEM_G);           // [RB][ACC_LD]
    float* qsq_s = reinterpret_cast<float*>(smem + SMEM_Q + SMEM_G + SMEM_ACC);  // [QB]
    float* gsq_s = qsq_s + QB;                                                    // [RB]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int q0 = blockIdx.x * QB;
    const int seg = blockIdx.y;
    const long seg0 = (long)seg * SEG_ROWS;
    const long seg1 = min((long)n_valid, seg0 + SEG_ROWS);
    if (row_mask != nullptr) {
        const int qi = q0 + tid;
        // a block whose queries are all masked out has nothing to do
        if (!__syncthreads_or(tid < QB && qi < B && row_mask[qi])) return;
    }

    // loaders: q chunk = 64 rows x 8 vectors (4 threads a row, 2 vectors
    // each); g chunk = 128 rows x 8 vectors (2 threads a row, 4 each)
    const int qr = tid >> 2, qp = tid & 3;
    const int gr = tid >> 1, gp = tid & 1;
    // epilogue: one query per thread, every PHASES-th row of the sub-tile
    const int eq = tid % QB, ep = tid / QB;

    float bd[K];
    int bi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { bd[j] = BIG_DIST; bi[j] = NO_ROW; }

    for (long r0 = seg0; r0 < seg1; r0 += RB) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[QB / 16];
#pragma unroll
        for (int n = 0; n < QB / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
        float qpart = 0.0f, gpart = 0.0f;

        for (int k0 = start / KC * KC; k0 < end; k0 += KC) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int c = qp + 4 * j;
                const uint4 v = load_vec(q, q0 + qr, B, D, k0 + 8 * c, start, end);
                qpart += sq8(v);
                *reinterpret_cast<uint4*>(q_s + qr * LDS + 8 * c) = v;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = gp + 2 * j;
                const uint4 v = load_vec(g, r0 + gr, N, D, k0 + 8 * c, start, end);
                gpart += sq8(v);
                *reinterpret_cast<uint4*>(g_s + gr * LDS + 8 * c) = v;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < KC; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::load_matrix_sync(a, g_s + warp * 16 * LDS + kk, LDS);
#pragma unroll
                for (int n = 0; n < QB / 16; ++n) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
                    wmma::load_matrix_sync(b, q_s + n * 16 * LDS + kk, LDS);
                    wmma::mma_sync(acc[n], a, b, acc[n]);
                }
            }
            __syncthreads();  // staging buffers are rewritten next chunk
        }
        qpart += __shfl_xor_sync(0xffffffffu, qpart, 1);
        qpart += __shfl_xor_sync(0xffffffffu, qpart, 2);
        gpart += __shfl_xor_sync(0xffffffffu, gpart, 1);
        if (qp == 0) qsq_s[qr] = qpart;
        if (gp == 0) gsq_s[gr] = gpart;
#pragma unroll
        for (int n = 0; n < QB / 16; ++n)
            wmma::store_matrix_sync(acc_s + warp * 16 * ACC_LD + n * 16, acc[n], ACC_LD,
                                    wmma::mem_row_major);
        __syncthreads();

        scan_subtile<K>(acc_s, qsq_s, gsq_s, r0, seg1, eq, ep, bd, bi);
        __syncthreads();  // acc_s / norms are rewritten by the next sub-tile
    }
    emit_segment<K>(smem, bd, bi, eq, ep, q0, B, seg, n_seg, part_d, part_i);
}

// Loads the values [col, col + EPV) of row `row` of a [rows, D] matrix of
// fp32 or bf16 as fp32, zero past the last row and outside [start, end).
template <typename T>
__device__ __forceinline__ void load_f32(const T* m, long row, long rows, int D, int col,
                                         int start, int end, float* out) {
    constexpr int EPV = 16 / sizeof(T);
    if (row >= rows || col >= end || col + EPV <= start) {
#pragma unroll
        for (int j = 0; j < EPV; ++j) out[j] = 0.0f;
        return;
    }
    const uint4 v = *reinterpret_cast<const uint4*>(m + row * (long)D + col);
    if constexpr (sizeof(T) == 4) {
        const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
        for (int j = 0; j < EPV; ++j) out[j] = f[j];
    } else {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
        for (int j = 0; j < EPV; ++j) out[j] = __bfloat162float(h[j]);
    }
#pragma unroll
    for (int j = 0; j < EPV; ++j)
        if (col + j < start || col + j >= end) out[j] = 0.0f;
}

constexpr int KP = 32;           // feature chunk of the precise pass
constexpr int QLD = QB + 4;      // k-major staged queries, [KP][QLD]
constexpr int GLD = RB + 4;      // k-major staged rows, [KP][GLD]
constexpr size_t SMEM_P = (size_t)KP * (QLD + GLD) * 4 + SMEM_ACC + (QB + RB) * 4;

// Stages a [nrows x KP] chunk of fp32 or bf16 rows k-major into dst
// ([KP][ld] fp32) and adds each row's squared values to part[] (one
// entry per row this thread loads; the VPR threads of a row are
// consecutive lanes).
template <typename T, int NROWS>
__device__ __forceinline__ void stage_kmajor(const T* m, long row0, long rows, int D, int k0,
                                             int start, int end, float* dst, int ld,
                                             float* part) {
    constexpr int EPV = 16 / sizeof(T);
    constexpr int VPR = KP / EPV;
    constexpr int PER = NROWS * VPR / THREADS;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
        const int v = threadIdx.x + THREADS * j;
        const int r = v / VPR, c = v % VPR;
        float x[EPV];
        load_f32<T>(m, row0 + r, rows, D, k0 + c * EPV, start, end, x);
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
            part[j] = fmaf(x[e], x[e], part[j]);
            dst[(c * EPV + e) * ld + r] = x[e];
        }
    }
}

// Sums the VPR partial norms of each row (consecutive lanes) into out[row].
template <typename T, int NROWS>
__device__ __forceinline__ void reduce_norms(float* part, float* out) {
    constexpr int VPR = KP / (16 / sizeof(T));
    constexpr int PER = NROWS * VPR / THREADS;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
#pragma unroll
        for (int off = 1; off < VPR; off <<= 1) part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
        const int v = threadIdx.x + THREADS * j;
        if (v % VPR == 0) out[v / VPR] = part[j];
    }
}

template <int K, typename GT>
__global__ void __launch_bounds__(THREADS)
topk_pass1_precise(const float* __restrict__ q, const GT* __restrict__ g,
                   float* __restrict__ part_d, int* __restrict__ part_i, int B, int N,
                   int n_valid, int D, int n_seg, int start, int end) {
    extern __shared__ __align__(128) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);          // [KP][QLD]
    float* g_s = q_s + KP * QLD;                          // [KP][GLD]
    float* acc_s = g_s + KP * GLD;                        // [RB][ACC_LD]
    float* qsq_s = acc_s + RB * ACC_LD;                   // [QB]
    float* gsq_s = qsq_s + QB;                            // [RB]

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * QB;
    const int seg = blockIdx.y;
    const long seg0 = (long)seg * SEG_ROWS;
    const long seg1 = min((long)n_valid, seg0 + SEG_ROWS);
    // product: rows tr*8 .. +8 against queries tq*4 .. +4
    const int tr = tid / 16, tq = tid % 16;
    const int eq = tid % QB, ep = tid / QB;
    constexpr int QPER = QB * KP / 4 / THREADS;                  // q is always fp32
    constexpr int GPER = RB * (KP / (16 / sizeof(GT))) / THREADS;

    float bd[K];
    int bi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { bd[j] = BIG_DIST; bi[j] = NO_ROW; }

    for (long r0 = seg0; r0 < seg1; r0 += RB) {
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        float qpart[QPER], gpart[GPER];
#pragma unroll
        for (int j = 0; j < QPER; ++j) qpart[j] = 0.0f;
#pragma unroll
        for (int j = 0; j < GPER; ++j) gpart[j] = 0.0f;

        for (int k0 = start / KP * KP; k0 < end; k0 += KP) {
            stage_kmajor<float, QB>(q, q0, B, D, k0, start, end, q_s, QLD, qpart);
            stage_kmajor<GT, RB>(g, r0, N, D, k0, start, end, g_s, GLD, gpart);
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < KP; ++kk) {
                const float4 a0 = *reinterpret_cast<const float4*>(g_s + kk * GLD + tr * 8);
                const float4 a1 = *reinterpret_cast<const float4*>(g_s + kk * GLD + tr * 8 + 4);
                const float4 b = *reinterpret_cast<const float4*>(q_s + kk * QLD + tq * 4);
                const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
            }
            __syncthreads();  // staging buffers are rewritten next chunk
        }
        reduce_norms<float, QB>(qpart, qsq_s);
        reduce_norms<GT, RB>(gpart, gsq_s);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc_s[(tr * 8 + i) * ACC_LD + tq * 4 + j] = acc[i][j];
        __syncthreads();
        scan_subtile<K>(acc_s, qsq_s, gsq_s, r0, seg1, eq, ep, bd, bi);
        __syncthreads();  // acc_s / norms are rewritten by the next sub-tile
    }
    emit_segment<K>(smem, bd, bi, eq, ep, q0, B, seg, n_seg, part_d, part_i);
}

template <int K>
__global__ void topk_pass2(const float* __restrict__ part_d, const int* __restrict__ part_i,
                           const uint8_t* __restrict__ row_mask, float* __restrict__ out_d,
                           int32_t* __restrict__ out_i, int B, int n_seg, int k) {
    const int qi = blockIdx.x * blockDim.x + threadIdx.x;
    if (qi >= B) return;
    float bd[K];
    int bi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { bd[j] = BIG_DIST; bi[j] = NO_ROW; }
    if (row_mask == nullptr || row_mask[qi]) {
        const size_t base = (size_t)qi * n_seg * K;
        for (int s = 0; s < n_seg; ++s)
#pragma unroll
            for (int j = 0; j < K; ++j)
                insert<K>(bd, bi, part_d[base + (size_t)s * K + j], part_i[base + (size_t)s * K + j]);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (j < k) {
            out_d[(size_t)qi * k + j] = bd[j];
            out_i[(size_t)qi * k + j] = bi[j] == NO_ROW ? -1 : bi[j];
        }
    }
}

struct Args {
    const void* q;
    const void* g;
    const uint8_t* row_mask;
    void *part_d, *part_i, *out_d, *out_i;
    int B, N, n_valid, D, k, n_seg, start, end;
};

// PRECISE: fp32 queries against GT rows on the CUDA cores; otherwise bf16
// on the tensor cores (GT unused).
template <int K, bool PRECISE, typename GT>
int launch(const Args& a, cudaStream_t stream) {
    static_assert((size_t)PHASES * QB * K * 8 <= SMEM_Q + SMEM_G + SMEM_ACC,
                  "merge lists must fit the staging buffers");
    static_assert((size_t)PHASES * QB * K * 8 <= SMEM_P, "merge lists must fit the staging buffers");
    const dim3 grid1((a.B + QB - 1) / QB, a.n_seg);
    cudaError_t err;
    if constexpr (PRECISE) {
        err = cudaFuncSetAttribute(topk_pass1_precise<K, GT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_P);
        if (err != cudaSuccess) return (int)err;
        topk_pass1_precise<K, GT><<<grid1, THREADS, SMEM_P, stream>>>(
            (const float*)a.q, (const GT*)a.g, (float*)a.part_d, (int*)a.part_i, a.B, a.N,
            a.n_valid, a.D, a.n_seg, a.start, a.end);
    } else {
        err = cudaFuncSetAttribute(topk_pass1<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)SMEM_BYTES);
        if (err != cudaSuccess) return (int)err;
        topk_pass1<K><<<grid1, THREADS, SMEM_BYTES, stream>>>(
            (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.g, a.row_mask, (float*)a.part_d,
            (int*)a.part_i, a.B, a.N, a.n_valid, a.D, a.n_seg, a.start, a.end);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    topk_pass2<K><<<(a.B + 127) / 128, 128, 0, stream>>>(
        (const float*)a.part_d, (const int*)a.part_i, a.row_mask, (float*)a.out_d,
        (int32_t*)a.out_i, a.B, a.n_seg, a.k);
    return (int)cudaGetLastError();
}

int list_len(int k) { return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : 16; }

template <bool PRECISE, typename GT>
int dispatch(const Args& a, void* stream) {
    if (a.B <= 0 || a.N <= 0 || a.n_valid <= 0 || a.n_valid > a.N || a.D <= 0 || a.D % 8 != 0 ||
        a.k < 1 || a.k > 16 || a.n_seg != (a.n_valid + SEG_ROWS - 1) / SEG_ROWS ||
        a.n_seg > 65535 || a.start < 0 || a.start >= a.end || a.end > a.D)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (list_len(a.k)) {
        case 1: return launch<1, PRECISE, GT>(a, s);
        case 2: return launch<2, PRECISE, GT>(a, s);
        case 4: return launch<4, PRECISE, GT>(a, s);
        case 8: return launch<8, PRECISE, GT>(a, s);
        default: return launch<16, PRECISE, GT>(a, s);
    }
}

}  // namespace

extern "C" int topk_l2_segment_rows() { return SEG_ROWS; }

// Scratch size of K (the power of two >= k) the caller allocates per
// (query, segment) for pass 1.
extern "C" int topk_l2_list_len(int k) { return list_len(k); }

// q: [B, D] bf16, g: [N, D] bf16 (rows >= n_valid ignored; D % 8 == 0),
// row_mask: [B] uint8 or null (queries with 0 come back empty and blocks
// without a 1 skip the scan), part_d/part_i: [B, n_seg,
// topk_l2_list_len(k)] scratch, out_d: [B, k] fp32 raw squared distances
// over the window [start, end), out_i: [B, k] int32. Returns a cudaError_t.
extern "C" int topk_l2_launch(const void* q, const void* g, const void* row_mask, void* part_d,
                              void* part_i, void* out_d, void* out_i, int B, int N, int n_valid,
                              int D, int k, int n_seg, int start, int end, void* stream) {
    const Args a{q, g, (const uint8_t*)row_mask, part_d, part_i, out_d, out_i,
                 B, N, n_valid, D, k, n_seg, start, end};
    return dispatch<false, float>(a, stream);
}

// precise: q: [B, D] fp32, g: [N, D] fp32 (g_f32 = 1) or bf16 (0); the
// rest as for topk_l2_launch, without a mask.
extern "C" int topk_l2_precise_launch(const void* q, const void* g, int g_f32, void* part_d,
                                      void* part_i, void* out_d, void* out_i, int B, int N,
                                      int n_valid, int D, int k, int n_seg, int start, int end,
                                      void* stream) {
    const Args a{q, g, nullptr, part_d, part_i, out_d, out_i, B, N, n_valid, D, k, n_seg, start, end};
    return g_f32 ? dispatch<true, float>(a, stream) : dispatch<true, __nv_bfloat16>(a, stream);
}
