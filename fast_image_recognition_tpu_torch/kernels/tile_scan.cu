// Per-tile min and argmin scans for Hopper (sm_90a): the bf16 tile scan
// and the int8 tile scan.
//
// `tilemin_launch` replaces the Pallas TPU kernel `_tilemin_kernel`
// (fast_image_recognition_tpu/ops/distance_kernel.py:174, launched by
// `_tilemin_l2_block` :222), the PCA candidate scan of RecognitionService's
// default `pca_scan='f32'` and of `'bf16'`. For every query and every
// gallery tile of `tile_g` rows it emits the min and the lowest row at the
// min of
//
//     score = |g|^2 - 2 q.g
//
// with bf16 x bf16 products summed in fp32 and |g|^2 precomputed (BIG_DIST
// on pad rows). `bf16_scores` rounds |g|^2, 2 q.g and their difference to
// bf16 (nearest even), as the TPU kernel's `score_t=bfloat16` does; a pad
// row's 3.4e38 then becomes inf. |q|^2, the clamp and the division by D
// are applied by the caller.
//
// `tilemin_quant_launch` replaces `_tilemin_quant_kernel` (:671, launched by
// `_tilemin_quant_block` :717), the scan of bench.py's `--config bf --quant`,
// `match='int8'` and `pca_scan='int8'`:
//
//     score = gsq - (2 s_q) * (cross * s_g)
//
// with int8 queries and rows, `cross` their exact int32 dot (`compute`
// int8) or the fp32 sum of the same values as bf16 products (`compute`
// bf16), the true |g|^2 and per-row scales (0 on pad rows). Every
// operation of the epilogue is rounded on its own (`__fmul_rn`,
// `__fsub_rn`: no contraction into an FMA), so the scores equal the plain
// PyTorch version's bit for bit when the dots do.
//
// Bound: at B = 1024 against 1,000,448 x 128 bf16 rows the work is
// 2*B*Np*D = 262 GFLOP against 256 MB: operations bound (0.265 ms at 989
// TFLOP/s); the int8 scan at D = 1536 is 3.15e12 int8 operations against
// 1.54 GB: 1.59 ms at 1,979 TOPS, operations bound. Design: one block owns
// (64 queries, one tile) and walks the tile in 64-row sub-tiles; each
// sub-tile's products run on the tensor cores through WMMA (bf16 -> fp32,
// or s8 -> s32) over 128-wide feature chunks staged in shared memory (the
// query chunk stays resident when D <= 128), land in a shared tile, and
// each warp reduces 8 query columns to (score, row) pairs in registers,
// combined across lanes with warp shuffles. (score, row) ordering makes
// the result independent of the reduction order. Query blocks vary
// fastest in the grid, so the blocks that read one tile run together and
// share it through L2. No cp.async/TMA pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int QB = 64;        // queries per block
constexpr int RB = 64;        // gallery rows per sub-tile
constexpr int KC = 128;       // feature chunk (elements)
constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 16;       // elements of row padding in shared memory
constexpr int LDS = KC + PAD;
constexpr int ACC_LD = RB + 4;  // accumulator tile, [query][row]
constexpr int QPW = QB / (THREADS / 32);  // query columns reduced per warp

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
    return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int x) { return __int2float_rn(x); }

// Shared-memory layout of a staged [nrows x KC] chunk. bf16: row-major
// with a padded row of LDS elements. int8: WMMA wants 32-byte aligned
// fragment pointers, and a 16-wide int8 k step is 16 bytes, so the chunk
// is kept as KC / 16 planes of [nrows][16].
template <typename Mma>
struct Layout {
    static constexpr int LD = LDS;
    __device__ static Mma* at(Mma* base, int row, int k, int) { return base + row * LDS + k; }
};
template <>
struct Layout<signed char> {
    static constexpr int LD = 16;
    __device__ static signed char* at(signed char* base, int row, int k, int nrows) {
        return base + (k / 16) * (nrows * 16) + row * 16 + (k % 16);
    }
};

// Stages rows [row0, row0 + nrows) x features [k0, k0 + KC) of a [*, D]
// matrix of In (bf16 or int8) into `dst` in Mma's layout, zero past D and
// past `rows`. Int8 into bf16 converts exactly.
template <typename In, typename Mma>
__device__ __forceinline__ void stage(const In* __restrict__ src, long row0, long rows, int nrows,
                                      int D, int k0, Mma* dst) {
    constexpr int EPV = 16 / sizeof(In);  // elements per 16-byte vector
    constexpr int VPR = KC / EPV;
    for (int v = threadIdx.x; v < nrows * VPR; v += THREADS) {
        const int r = v / VPR, c = v % VPR;
        const long row = row0 + r;
        const int col = k0 + c * EPV;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < rows && col < D) val = *reinterpret_cast<const uint4*>(src + row * (long)D + col);
        Mma* out = Layout<Mma>::at(dst, r, c * EPV, nrows);
        if constexpr (sizeof(In) == sizeof(Mma)) {
            *reinterpret_cast<uint4*>(out) = val;
        } else {  // int8 -> bf16, exact
            const int8_t* b = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
            for (int j = 0; j < EPV; ++j) out[j] = __float2bfloat16_rn((float)b[j]);
        }
    }
}

// MODE 0: fp32 scores; 1: bf16 scores; 2: int8 scan (gsq - 2 s_q cross s_g).
template <typename In, typename Mma, typename Acc, int MODE>
__global__ void __launch_bounds__(THREADS)
tile_scan_kernel(const In* __restrict__ q, const float* __restrict__ qs,
                 const In* __restrict__ g, const float* __restrict__ gsq,
                 const float* __restrict__ gsc, float* __restrict__ out_d,
                 int32_t* __restrict__ out_i, int B, int n_tiles, int D, int tile_g) {
    extern __shared__ __align__(128) unsigned char smem[];
    Mma* q_s = reinterpret_cast<Mma*>(smem);            // [QB][LDS]
    Mma* g_s = q_s + QB * LDS;                          // [RB][LDS]
    Acc* acc_s = reinterpret_cast<Acc*>(g_s + RB * LDS);  // [QB][ACC_LD]
    float* gsq_s = reinterpret_cast<float*>(acc_s + QB * ACC_LD);  // [RB]
    float* gsc_s = gsq_s + RB;                                      // [RB]
    float* qs2_s = gsc_s + RB;                                      // [QB]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int q0 = blockIdx.x * QB;
    const int tile = blockIdx.y;
    const long tile0 = (long)tile * tile_g;
    const int n_chunks = (D + KC - 1) / KC;
    const int mf = warp >> 1;       // 16-row slice of the sub-tile
    const int nf = (warp & 1) * 2;  // first of two 16-query slices

    if (MODE == 2 && tid < QB) qs2_s[tid] = q0 + tid < B ? 2.0f * qs[q0 + tid] : 0.0f;

    float bv[QPW];
    int bi[QPW];
#pragma unroll
    for (int i = 0; i < QPW; ++i) { bv[i] = __int_as_float(0x7f800000); bi[i] = INT32_MAX; }

    for (int sub = 0; sub < tile_g / RB; ++sub) {
        const long r0 = tile0 + (long)sub * RB;
        if (tid < RB) {
            gsq_s[tid] = gsq[r0 + tid];
            if (MODE == 2) gsc_s[tid] = gsc[r0 + tid];
        }
        wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> c0, c1;
        wmma::fill_fragment(c0, (Acc)0);
        wmma::fill_fragment(c1, (Acc)0);
        for (int kc = 0; kc < n_chunks; ++kc) {
            if (n_chunks > 1 || sub == 0) stage<In, Mma>(q, q0, B, QB, D, kc * KC, q_s);
            stage<In, Mma>(g, r0, r0 + RB, RB, D, kc * KC, g_s);
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < KC; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, Mma, wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, Mma, wmma::col_major> b0, b1;
                constexpr int LD = Layout<Mma>::LD;
                wmma::load_matrix_sync(a, Layout<Mma>::at(g_s, mf * 16, kk, RB), LD);
                wmma::load_matrix_sync(b0, Layout<Mma>::at(q_s, nf * 16, kk, QB), LD);
                wmma::load_matrix_sync(b1, Layout<Mma>::at(q_s, (nf + 1) * 16, kk, QB), LD);
                wmma::mma_sync(c0, a, b0, c0);
                wmma::mma_sync(c1, a, b1, c1);
            }
            __syncthreads();  // staging buffers are rewritten next chunk
        }
        // column-major store: acc_s[query * ACC_LD + row]
        wmma::store_matrix_sync(acc_s + nf * 16 * ACC_LD + mf * 16, c0, ACC_LD, wmma::mem_col_major);
        wmma::store_matrix_sync(acc_s + (nf + 1) * 16 * ACC_LD + mf * 16, c1, ACC_LD, wmma::mem_col_major);
        __syncthreads();

#pragma unroll
        for (int i = 0; i < QPW; ++i) {
            const int ql = warp * QPW + i;
            const Acc* col = acc_s + ql * ACC_LD;
#pragma unroll
            for (int h = 0; h < RB / 32; ++h) {
                const int r = lane + 32 * h;
                float s;
                if (MODE == 2) {
                    s = __fsub_rn(gsq_s[r], __fmul_rn(qs2_s[ql], __fmul_rn(to_f32(col[r]), gsc_s[r])));
                } else if (MODE == 1) {
                    const float m = bf16_round(__fmul_rn(2.0f, to_f32(col[r])));
                    s = bf16_round(__fsub_rn(bf16_round(gsq_s[r]), m));
                } else {
                    s = __fsub_rn(gsq_s[r], __fmul_rn(2.0f, to_f32(col[r])));
                }
                const int row = sub * RB + r;
                if (before(s, row, bv[i], bi[i])) { bv[i] = s; bi[i] = row; }
            }
        }
        // the next sub-tile writes gsq_s and the staging buffers only after
        // the barrier above; acc_s only after the chunk loop's barriers
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < QPW; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
            const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
            if (before(ov, oi, bv[i], bi[i])) { bv[i] = ov; bi[i] = oi; }
        }
        const int qi = q0 + warp * QPW + i;
        if (lane == 0 && qi < B) {
            out_d[(size_t)qi * n_tiles + tile] = bv[i];
            out_i[(size_t)qi * n_tiles + tile] = (int32_t)(tile0 + bi[i]);
        }
    }
}

template <typename In, typename Mma, typename Acc, int MODE>
int launch(const void* q, const void* qs, const void* g, const void* gsq, const void* gsc,
           void* out_d, void* out_i, int B, int n_tiles, int D, int tile_g, void* stream) {
    if (B <= 0 || n_tiles <= 0 || n_tiles > 65535 || D <= 0 || D % (16 / (int)sizeof(In)) != 0 ||
        tile_g < 128 || tile_g > 1024 || (tile_g & (tile_g - 1)) != 0 ||
        (long)n_tiles * tile_g > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(QB + RB) * LDS * sizeof(Mma) + (size_t)QB * ACC_LD * sizeof(Acc) +
                        (size_t)(2 * RB + QB) * sizeof(float);
    auto kernel = tile_scan_kernel<In, Mma, Acc, MODE>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + QB - 1) / QB, n_tiles);
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const In*)q, (const float*)qs, (const In*)g, (const float*)gsq, (const float*)gsc,
        (float*)out_d, (int32_t*)out_i, B, n_tiles, D, tile_g);
    return (int)cudaGetLastError();
}

}  // namespace

// q: [B, D] bf16, g: [n_tiles * tile_g, D] bf16 (D % 8 == 0), gsq: [>= n_tiles
// * tile_g] fp32 in row order, out_d: [B, n_tiles] fp32 min scores, out_i:
// [B, n_tiles] int32 global rows; tile_g is 128, 256, 512 or 1024.
// Returns a cudaError_t value (0 on success); launches on `stream`.
extern "C" int tilemin_launch(const void* q, const void* g, const void* gsq, void* out_d,
                              void* out_i, int B, int n_tiles, int D, int tile_g,
                              int bf16_scores, void* stream) {
    if (bf16_scores)
        return launch<__nv_bfloat16, __nv_bfloat16, float, 1>(q, nullptr, g, gsq, nullptr, out_d,
                                                              out_i, B, n_tiles, D, tile_g, stream);
    return launch<__nv_bfloat16, __nv_bfloat16, float, 0>(q, nullptr, g, gsq, nullptr, out_d, out_i,
                                                          B, n_tiles, D, tile_g, stream);
}

// q: [B, D] int8, qs: [B] fp32 query scales, g: [n_tiles * tile_g, D] int8
// (D % 16 == 0), gsq/gsc: [>= n_tiles * tile_g] fp32 true |g|^2 and row
// scales in row order, out_d/out_i as for tilemin_launch. compute_int8: 1
// for the int32 dot, 0 for bf16 products summed in fp32.
extern "C" int tilemin_quant_launch(const void* q, const void* qs, const void* g,
                                    const void* gsq, const void* gsc, void* out_d, void* out_i,
                                    int B, int n_tiles, int D, int tile_g, int compute_int8,
                                    void* stream) {
    if (compute_int8)
        return launch<signed char, signed char, int, 2>(q, qs, g, gsq, gsc, out_d, out_i, B, n_tiles, D,
                                                   tile_g, stream);
    return launch<signed char, __nv_bfloat16, float, 2>(q, qs, g, gsq, gsc, out_d, out_i, B, n_tiles, D,
                                                   tile_g, stream);
}
