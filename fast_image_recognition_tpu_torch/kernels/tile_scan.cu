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
// 1.54 GB: 1.59 ms at 1,979 TOPS, operations bound.
//
// The int8 scan with int8 compute (`tilemin_quant_sm90`) runs on the main
// loop of sm90_scan.cuh: a block owns (128 queries, a 2048-row segment of
// whole tiles), two consumer warpgroups of 64 queries are the M side of
// m64n256k32 s8 x s8 -> s32 `wgmma` products, 256 gallery rows the N
// side. 128 int8 queries take 192 KB at D = 1536, so they do not stay
// resident: each stage of the 4-stage TMA ring holds one 128-feature chunk
// of the queries and of the sub-tile ([128 x 128] + [256 x 128] bytes).
// Query tiles vary fastest in the grid, so the query tiles of a segment
// run together and read it from HBM about once (from L2 once per query
// tile). The epilogue stays in registers: |g|^2 and s_g of the sub-tile's
// rows reach shared memory once (plain loads issued before its products,
// stored after them), each thread forms the scores of its two query rows
// at its 64 accumulator columns and keeps one (score, row) a row with a
// strict < over rising columns; a tile of any `tile_g` ends at the end of
// one of the sub-tile's two 128-row halves, where the 4 lanes of a row
// merge with shuffles in (score, row) order and one (min, row) per
// (query, tile) is written.
//
// The bf16 tile scan and the int8 scan with bf16 compute keep the first
// port's design (`tile_scan_kernel`): one block owns (64 queries, one tile)
// and walks the tile in 64-row sub-tiles; each sub-tile's products run on
// the tensor cores through WMMA (bf16 -> fp32) over 128-wide feature chunks
// staged in shared memory (the query chunk stays resident when D <= 128),
// land in a shared tile, and each warp reduces 8 query columns to (score,
// row) pairs in registers, combined across lanes with warp shuffles.
// (score, row) ordering makes the result independent of the reduction
// order. Query blocks vary fastest in the grid, so the blocks that read one
// tile run together and share it through L2. No TMA pipelining and no
// `wgmma` there yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90_scan.cuh"

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

// Stages rows [row0, row0 + nrows) x features [k0, k0 + KC) of a [*, D]
// matrix of In (bf16 or int8) into `dst` as bf16 rows of LDS elements,
// zero past D and past `rows`. Int8 into bf16 converts exactly.
template <typename In>
__device__ __forceinline__ void stage(const In* __restrict__ src, long row0, long rows, int nrows,
                                      int D, int k0, __nv_bfloat16* dst) {
    constexpr int EPV = 16 / sizeof(In);  // elements per 16-byte vector
    constexpr int VPR = KC / EPV;
    for (int v = threadIdx.x; v < nrows * VPR; v += THREADS) {
        const int r = v / VPR, c = v % VPR;
        const long row = row0 + r;
        const int col = k0 + c * EPV;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row < rows && col < D) val = *reinterpret_cast<const uint4*>(src + row * (long)D + col);
        __nv_bfloat16* out = dst + r * LDS + c * EPV;
        if constexpr (sizeof(In) == 2) {
            *reinterpret_cast<uint4*>(out) = val;
        } else {  // int8 -> bf16, exact
            const int8_t* b = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
            for (int j = 0; j < EPV; ++j) out[j] = __float2bfloat16_rn((float)b[j]);
        }
    }
}

// MODE 0: fp32 scores; 1: bf16 scores; 2: int8 scan (gsq - 2 s_q cross s_g)
// with bf16 products.
template <typename In, int MODE>
__global__ void __launch_bounds__(THREADS)
tile_scan_kernel(const In* __restrict__ q, const float* __restrict__ qs,
                 const In* __restrict__ g, const float* __restrict__ gsq,
                 const float* __restrict__ gsc, float* __restrict__ out_d,
                 int32_t* __restrict__ out_i, int B, int n_tiles, int D, int tile_g) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [QB][LDS]
    __nv_bfloat16* g_s = q_s + QB * LDS;                          // [RB][LDS]
    float* acc_s = reinterpret_cast<float*>(g_s + RB * LDS);      // [QB][ACC_LD]
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
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
        wmma::fill_fragment(c0, 0.0f);
        wmma::fill_fragment(c1, 0.0f);
        for (int kc = 0; kc < n_chunks; ++kc) {
            if (n_chunks > 1 || sub == 0) stage<In>(q, q0, B, QB, D, kc * KC, q_s);
            stage<In>(g, r0, r0 + RB, RB, D, kc * KC, g_s);
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < KC; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0, b1;
                wmma::load_matrix_sync(a, g_s + mf * 16 * LDS + kk, LDS);
                wmma::load_matrix_sync(b0, q_s + nf * 16 * LDS + kk, LDS);
                wmma::load_matrix_sync(b1, q_s + (nf + 1) * 16 * LDS + kk, LDS);
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
            const float* col = acc_s + ql * ACC_LD;
#pragma unroll
            for (int h = 0; h < RB / 32; ++h) {
                const int r = lane + 32 * h;
                float s;
                if (MODE == 2) {
                    s = __fsub_rn(gsq_s[r], __fmul_rn(qs2_s[ql], __fmul_rn(col[r], gsc_s[r])));
                } else if (MODE == 1) {
                    const float m = bf16_round(__fmul_rn(2.0f, col[r]));
                    s = bf16_round(__fsub_rn(bf16_round(gsq_s[r]), m));
                } else {
                    s = __fsub_rn(gsq_s[r], __fmul_rn(2.0f, col[r]));
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

template <typename In, int MODE>
int launch(const void* q, const void* qs, const void* g, const void* gsq, const void* gsc,
           void* out_d, void* out_i, int B, int n_tiles, int D, int tile_g, void* stream) {
    if (B <= 0 || n_tiles <= 0 || n_tiles > 65535 || D <= 0 || D % (16 / (int)sizeof(In)) != 0 ||
        tile_g < 128 || tile_g > 1024 || (tile_g & (tile_g - 1)) != 0 ||
        (long)n_tiles * tile_g > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(QB + RB) * LDS * sizeof(__nv_bfloat16) + (size_t)QB * ACC_LD * sizeof(float) +
                        (size_t)(2 * RB + QB) * sizeof(float);
    auto kernel = tile_scan_kernel<In, MODE>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + QB - 1) / QB, n_tiles);
    kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const In*)q, (const float*)qs, (const In*)g, (const float*)gsq, (const float*)gsc,
        (float*)out_d, (int32_t*)out_i, B, n_tiles, D, tile_g);
    return (int)cudaGetLastError();
}

// ---- the int8 scan with int8 compute: tilemin_quant_sm90 ----

constexpr float BIG_DIST = 3.4e38f;
constexpr int QT8 = 128;        // queries per block: two consumer warpgroups of 64
constexpr int BN8 = 256;        // gallery rows per sub-tile (wgmma N)
constexpr int HALF8 = BN8 / 2;  // rows per half: the smallest tile_g
constexpr int SEG_ROWS = 2048;  // gallery rows per block: whole tiles of any tile_g
constexpr int STAGES = 4;       // TMA ring depth
constexpr int Q_BYTES = QT8 * sm90::LINE_BYTES;  // one 128-feature chunk of the queries
constexpr int G_BYTES = BN8 * sm90::LINE_BYTES;  // and of the sub-tile
constexpr int STAGE_BYTES = Q_BYTES + G_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
// ring, |g|^2 and s_g of two sub-tiles, full[] and empty[] barriers
constexpr size_t SMEM8 = sm90::SMEM_ALIGN + RING_BYTES + 4 * BN8 * 4 + 2 * STAGES * 8;

// grid (query tiles, segments); 384 threads: warpgroups 0-1 consume, 2
// produces. qmap: [B, D] int8 boxes [128 x 128]; gmap: [n_rows, D] int8
// boxes [256 x 128]; n_rows = n_tiles * tile_g; n_chunks = ceil(D / 128).
__global__ void __launch_bounds__(sm90::THREADS, 1)
tilemin_quant_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
                   const float* __restrict__ qs, const float* __restrict__ gsq, const float* __restrict__ gsc,
                   float* __restrict__ out_d, int32_t* __restrict__ out_i, int B, int n_tiles, int tile_g,
                   int n_chunks) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = sm90::aligned_smem(smem_raw);
    float* gsq_s = reinterpret_cast<float*>(smem + RING_BYTES);  // [2][BN8]
    float* gsc_s = gsq_s + 2 * BN8;                               // [2][BN8]
    uint64_t* full = reinterpret_cast<uint64_t*>(gsc_s + 2 * BN8);  // [STAGES]
    uint64_t* empty = full + STAGES;                                // [STAGES]

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * QT8;
    const int n_rows = n_tiles * tile_g;
    const int seg0 = blockIdx.y * SEG_ROWS;
    const int n_sub = (min(n_rows, seg0 + SEG_ROWS) - seg0 + BN8 - 1) / BN8;
    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], 2);
        }
        sm90::mbar_init_fence();
    }
    __syncthreads();

    const int wg = tid / sm90::WG_THREADS;
    if (wg == 2) {
        // producer: one thread keeps the ring full
        sm90::setmaxnreg_dec<40>();
        if (tid == 2 * sm90::WG_THREADS) {
            sm90::prefetch_map(&qmap);
            sm90::prefetch_map(&gmap);
            int s = 0;
            uint32_t ph = 0;
            for (int sub = 0; sub < n_sub; ++sub)
                for (int c = 0; c < n_chunks; ++c) {
                    sm90::mbar_wait(&empty[s], ph ^ 1);
                    unsigned char* st = smem + s * STAGE_BYTES;
                    sm90::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
                    sm90::tma_load_2d(st, &qmap, &full[s], c * sm90::KCHUNK_S8, q0);
                    sm90::tma_load_2d(st + Q_BYTES, &gmap, &full[s], c * sm90::KCHUNK_S8, seg0 + sub * BN8);
                    if (++s == STAGES) { s = 0; ph ^= 1; }
                }
        }
    } else {
        sm90::setmaxnreg_inc<232>();
        const int t = tid % sm90::WG_THREADS;  // thread in its warpgroup
        float qs2[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int qi = q0 + wg * 64 + sm90::acc_row(t, h);
            qs2[h] = qi < B ? 2.0f * qs[qi] : 0.0f;
        }
        int acc[BN8 / 2];
        float bv[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
        int bi[2] = {INT32_MAX, INT32_MAX};
        int s = 0, prev = 0;
        uint32_t ph = 0;
        for (int sub = 0; sub < n_sub; ++sub) {
            const int r0 = seg0 + sub * BN8;
            // this sub-tile's |g|^2 and s_g, one row a consumer thread; the
            // loads land while the products run
            const int gr = r0 + tid;
            const float g2_own = gr < n_rows ? gsq[gr] : BIG_DIST;
            const float sg_own = gr < n_rows ? gsc[gr] : 0.0f;
#pragma unroll
            for (int i = 0; i < BN8 / 2; ++i) acc[i] = 0;
            for (int c = 0; c < n_chunks; ++c) {
                sm90::mbar_wait(&full[s], ph);
                const unsigned char* st = smem + s * STAGE_BYTES;
                const unsigned char* qa = st + wg * 64 * sm90::LINE_BYTES;
                sm90::acc_fence(acc);
                sm90::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < sm90::KCHUNK_S8 / 32; ++kk)
                    sm90::wgmma_m64n256k32_s8(acc, sm90::sw128_desc(qa + 32 * kk),
                                              sm90::sw128_desc(st + Q_BYTES + 32 * kk));
                sm90::wgmma_commit();
                sm90::wgmma_wait<1>();
                sm90::acc_fence(acc);
                if (c > 0 && t == 0) sm90::mbar_arrive(&empty[prev]);
                prev = s;
                if (++s == STAGES) { s = 0; ph ^= 1; }
            }
            sm90::wgmma_wait<0>();
            sm90::acc_fence(acc);
            if (t == 0) sm90::mbar_arrive(&empty[prev]);

            float* g2_s = gsq_s + (sub & 1) * BN8;  // two buffers: one barrier per sub-tile
            float* sg_s = gsc_s + (sub & 1) * BN8;
            g2_s[tid] = g2_own;
            sg_s[tid] = sg_own;
            sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
#pragma unroll
                for (int j = 0; j < HALF8 / 8; ++j) {
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int col = sm90::acc_col(t, half * HALF8 / 8 + j, c);
                        const float g2 = g2_s[col], sg = sg_s[col];
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const float cross = __int2float_rn(acc[4 * (half * HALF8 / 8 + j) + 2 * h + c]);
                            const float score = __fsub_rn(g2, __fmul_rn(qs2[h], __fmul_rn(cross, sg)));
                            // columns rise within a thread: strict < keeps the lowest row
                            if (score < bv[h]) { bv[h] = score; bi[h] = r0 + col; }
                        }
                    }
                }
                const int end = r0 + (half + 1) * HALF8;
                if ((end & (tile_g - 1)) == 0) {  // a tile ends with this half
                    const int tile = end / tile_g - 1;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
#pragma unroll
                        for (int off = 1; off < 4; off <<= 1) {
                            const float ov = __shfl_xor_sync(0xffffffffu, bv[h], off);
                            const int oi = __shfl_xor_sync(0xffffffffu, bi[h], off);
                            if (before(ov, oi, bv[h], bi[h])) { bv[h] = ov; bi[h] = oi; }
                        }
                        const int qi = q0 + wg * 64 + sm90::acc_row(t, h);
                        if ((t & 3) == 0 && qi < B && tile < n_tiles) {
                            out_d[(size_t)qi * n_tiles + tile] = bv[h];
                            out_i[(size_t)qi * n_tiles + tile] = bi[h];
                        }
                        bv[h] = __int_as_float(0x7f800000);
                        bi[h] = INT32_MAX;
                    }
                }
            }
        }
    }
}

int launch_quant_sm90(const void* q, const void* qs, const void* g, const void* gsq, const void* gsc,
                      void* out_d, void* out_i, int B, int n_tiles, int D, int tile_g, void* stream) {
    if (B <= 0 || n_tiles <= 0 || D <= 0 || D % 16 != 0 || tile_g < HALF8 || tile_g > 1024 ||
        (tile_g & (tile_g - 1)) != 0 || (long)n_tiles * tile_g > INT32_MAX - SEG_ROWS)
        return (int)cudaErrorInvalidValue;
    const long n_rows = (long)n_tiles * tile_g;
    CUtensorMap qmap, gmap;
    int err = sm90::encode_s8_map(&qmap, q, D, B, D, QT8);
    if (err == 0) err = sm90::encode_s8_map(&gmap, g, D, n_rows, D, BN8);
    if (err != 0) return err;
    const int n_chunks = (D + sm90::KCHUNK_S8 - 1) / sm90::KCHUNK_S8;
    const dim3 grid((B + QT8 - 1) / QT8, (unsigned)((n_rows + SEG_ROWS - 1) / SEG_ROWS));
    if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(tilemin_quant_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM8);
    if (e != cudaSuccess) return (int)e;
    tilemin_quant_sm90<<<grid, sm90::THREADS, SMEM8, (cudaStream_t)stream>>>(
        qmap, gmap, (const float*)qs, (const float*)gsq, (const float*)gsc, (float*)out_d, (int32_t*)out_i, B,
        n_tiles, tile_g, n_chunks);
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
        return launch<__nv_bfloat16, 1>(q, nullptr, g, gsq, nullptr, out_d, out_i, B, n_tiles, D, tile_g,
                                        stream);
    return launch<__nv_bfloat16, 0>(q, nullptr, g, gsq, nullptr, out_d, out_i, B, n_tiles, D, tile_g, stream);
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
        return launch_quant_sm90(q, qs, g, gsq, gsc, out_d, out_i, B, n_tiles, D, tile_g, stream);
    return launch<signed char, 2>(q, qs, g, gsq, gsc, out_d, out_i, B, n_tiles, D, tile_g, stream);
}
