// Exact L2 top-k (k <= 16) over a bf16 gallery for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_topk_kernel` with its `_merge_topk`
// carry (fast_image_recognition_tpu/ops/distance_kernel.py:92 and :57,
// launched by `_topk_l2_block` :988), non-precise path without a feature
// window. Per query and gallery row
//
//     d = max(|q|^2 + |g|^2 - 2 q.g, 0)
//
// in fp32 from bf16 values (bf16 x bf16 -> fp32 tensor-core products);
// rows >= n_valid never enter the result; ties go to the lowest global row
// index (the TPU kernel's masked argmin plus its carry-first merge); slots
// beyond the valid rows stay (BIG_DIST, -1). The wrapper divides by D.
//
// Bound: at B = 1024 against 1M x 1280 bf16 the work is 2*B*N*D = 2.7 TFLOP
// against 2.6 GB of gallery: operations bound (2.7 ms at 989 TFLOP/s vs
// 0.78 ms at 3.35 TB/s). Design, two passes:
//  1. grid (64-query block, 8192-row gallery segment). The block streams
//     its segment in 128-row sub-tiles, each in 64-wide K chunks through
//     shared memory (WMMA bf16 -> fp32; the squared norms of the same rows
//     are summed from the registers that load them). Each thread keeps a
//     register top-K of (distance, row) for one query over every fourth
//     row; the four lists of a query merge in shared memory and the
//     segment's top-K goes to a [B, n_seg, K] scratch.
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

// Loads row `row` (< rows) chunk [k0, k0 + 8*count) of a [rows, D] matrix
// as 16-byte vectors c = part + stride*j, zero past D or past the last row.
__device__ __forceinline__ uint4 load_vec(const __nv_bfloat16* m, long row, long rows,
                                          int D, int col) {
    if (row >= rows || col >= D) return make_uint4(0u, 0u, 0u, 0u);
    return *reinterpret_cast<const uint4*>(m + row * (long)D + col);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
topk_pass1(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ g,
           float* __restrict__ part_d, int* __restrict__ part_i,
           int B, int N, int n_valid, int D, int n_seg) {
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

        for (int k0 = 0; k0 < D; k0 += KC) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int c = qp + 4 * j;
                const uint4 v = load_vec(q, q0 + qr, B, D, k0 + 8 * c);
                qpart += sq8(v);
                *reinterpret_cast<uint4*>(q_s + qr * LDS + 8 * c) = v;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = gp + 2 * j;
                const uint4 v = load_vec(g, r0 + gr, N, D, k0 + 8 * c);
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

        const float qsq = qsq_s[eq];
        for (int r = ep; r < RB; r += PHASES) {
            const long row = r0 + r;
            if (row >= seg1) break;
            const float cross = acc_s[r * ACC_LD + eq];
            const float d = fmaxf(__fsub_rn(__fadd_rn(qsq, gsq_s[r]), __fmul_rn(2.0f, cross)), 0.0f);
            insert<K>(bd, bi, d, (int)row);
        }
        __syncthreads();  // acc_s / norms are rewritten by the next sub-tile
    }

    // merge the PHASES lists of each query through shared memory
    float* ld_s = reinterpret_cast<float*>(smem);          // [PHASES][QB][K]
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

template <int K>
__global__ void topk_pass2(const float* __restrict__ part_d, const int* __restrict__ part_i,
                           float* __restrict__ out_d, int32_t* __restrict__ out_i,
                           int B, int n_seg, int k) {
    const int qi = blockIdx.x * blockDim.x + threadIdx.x;
    if (qi >= B) return;
    float bd[K];
    int bi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) { bd[j] = BIG_DIST; bi[j] = NO_ROW; }
    const size_t base = (size_t)qi * n_seg * K;
    for (int s = 0; s < n_seg; ++s)
#pragma unroll
        for (int j = 0; j < K; ++j)
            insert<K>(bd, bi, part_d[base + (size_t)s * K + j], part_i[base + (size_t)s * K + j]);
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (j < k) {
            out_d[(size_t)qi * k + j] = bd[j];
            out_i[(size_t)qi * k + j] = bi[j] == NO_ROW ? -1 : bi[j];
        }
    }
}

template <int K>
int launch(const void* q, const void* g, void* part_d, void* part_i, void* out_d,
           void* out_i, int B, int N, int n_valid, int D, int k, int n_seg,
           cudaStream_t stream) {
    static_assert((size_t)PHASES * QB * K * 8 <= SMEM_Q + SMEM_G + SMEM_ACC,
                  "merge lists must fit the staging buffers");
    cudaError_t err = cudaFuncSetAttribute(
        topk_pass1<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    dim3 grid1((B + QB - 1) / QB, n_seg);
    topk_pass1<K><<<grid1, THREADS, SMEM_BYTES, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)g, (float*)part_d, (int*)part_i,
        B, N, n_valid, D, n_seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    topk_pass2<K><<<(B + 127) / 128, 128, 0, stream>>>(
        (const float*)part_d, (const int*)part_i, (float*)out_d, (int32_t*)out_i, B, n_seg, k);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int topk_l2_segment_rows() { return SEG_ROWS; }

// Scratch size of K (the power of two >= k) the caller allocates per
// (query, segment) for pass 1.
extern "C" int topk_l2_list_len(int k) {
    return k <= 1 ? 1 : k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : 16;
}

// q: [B, D] bf16, g: [N, D] bf16 (rows >= n_valid ignored), part_d/part_i:
// [B, n_seg, topk_l2_list_len(k)] scratch, out_d: [B, k] fp32 raw squared
// distances, out_i: [B, k] int32. Returns a cudaError_t value.
extern "C" int topk_l2_launch(const void* q, const void* g, void* part_d, void* part_i,
                              void* out_d, void* out_i, int B, int N, int n_valid,
                              int D, int k, int n_seg, void* stream) {
    if (B <= 0 || N <= 0 || n_valid <= 0 || n_valid > N || D <= 0 || D % 8 != 0 ||
        k < 1 || k > 16 || n_seg != (n_valid + SEG_ROWS - 1) / SEG_ROWS || n_seg > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (topk_l2_list_len(k)) {
        case 1: return launch<1>(q, g, part_d, part_i, out_d, out_i, B, N, n_valid, D, k, n_seg, s);
        case 2: return launch<2>(q, g, part_d, part_i, out_d, out_i, B, N, n_valid, D, k, n_seg, s);
        case 4: return launch<4>(q, g, part_d, part_i, out_d, out_i, B, N, n_valid, D, k, n_seg, s);
        case 8: return launch<8>(q, g, part_d, part_i, out_d, out_i, B, N, n_valid, D, k, n_seg, s);
        default: return launch<16>(q, g, part_d, part_i, out_d, out_i, B, N, n_valid, D, k, n_seg, s);
    }
}
