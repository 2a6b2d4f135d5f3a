// Packed tile-min scans for Hopper (sm_90a): the certified min-2 scan and
// the single-min scan.
//
// `tilemin2_packed_launch` replaces the Pallas TPU kernel
// `_tilemin2_packed_kernel` (fast_image_recognition_tpu/ops/distance_kernel.py:393,
// launched by `_tilemin2_packed_block` :430); `tilemin_packed_launch`
// replaces `_tilemin_packed_kernel` (:350, launched by `_tilemin_packed_block`
// :607), which the early-exit cascade runs once per level. For every gallery
// tile of `tile_g` rows (1024 for the min-2 scan; 128, 256, 512 or 1024 for
// the single-min scan) and every query they emit the smallest (and, for the
// min-2 scan, the second-smallest) packed int32 key
//
//     key = (f32 bits of q_aug . g_aug) & ~(tile_g - 1) | row_in_tile
//
// where the augmented columns ([-2q, 1, 1, |q|^2_hi, |q|^2_lo] against
// [g, |g|^2_hi, |g|^2_lo, 1, 1], see ops/distance_kernel.py) make the dot
// the full squared L2 distance. Distances are >= 0 up to rounding, so their
// bit patterns order as int32 and one integer min carries value and argmin;
// a slightly negative distance has the sign bit set and sorts below every
// positive key, as on the TPU. Pad rows carry |g|^2 = 1e38 and never win.
// Equal keys cannot occur within a tile (the row bits differ), so the order
// is (quantized distance, row) whatever the order of the reduction.
//
// Bound: at B = 1024, Np = 1,000,448, Da = 128 the work is 2*B*Np*Da = 262 GFLOP of
// bf16 tensor-core products against 256 MB of gallery: operations bound
// (0.265 ms at 989 TFLOP/s vs 0.076 ms at 3.35 TB/s); at the cascade's
// survivor capacities of a few hundred queries it is bytes bound.
//
// The min-2 scan (`tilemin2_sm90`) runs on the main loop of sm90_scan.cuh.
// A block keeps 128 queries resident in shared memory (TMA, once) as the
// `wgmma` A operand of two consumer warpgroups, and streams its run of
// whole 1024-row tiles through a 4-stage TMA ring in [256 rows x 64
// features] boxes, the N side of m64n256k16 products. The epilogue stays in
// registers: each thread turns its accumulators into keys and keeps (m1,
// m2) for its two query rows over the tile's four 256-row sub-tiles with
// three integer min/max, then the 4 lanes of a row combine with shuffles
// and one (m1, m2) per (query, tile) is written. The grid is (query
// tiles, runs of tiles) sized to one block per SM, the query tiles of a
// run side by side, so one wave reads the gallery from HBM about once
// and from L2 once per query tile. Its 10^9 keys cost integer work
// comparable to the products, so the epilogue's instruction slots, not
// HBM, are what it spends beside the tensor cores.
//
// The single-min scan (`tilemin_packed_kernel`) keeps the first port's
// design: one block owns (64 queries, one tile); the query block stays in
// shared memory, the tile streams through in 64-row sub-tiles, WMMA bf16 x
// bf16 -> fp32 products land in a shared fp32 tile, and each warp reduces 8
// query columns to keys in registers, combined across lanes with warp
// shuffles. Query blocks vary fastest in the grid, so the blocks that read
// one gallery tile run together and share it through L2. No cp.async/TMA
// pipelining and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "sm90_scan.cuh"

using namespace nvcuda;

namespace {

__device__ __forceinline__ void pair_combine(int& m1, int& m2, int b1, int b2) {
    const int lo = min(m1, b1);
    const int hi = max(m1, b1);
    m2 = min(hi, min(m2, b2));
    m1 = lo;
}

// ---- the min-2 scan: tilemin2_sm90 ----

constexpr int TILE_G2 = 1024;  // gallery rows per tile of the min-2 scan
constexpr int QT2 = 128;       // queries per block: two consumer warpgroups of 64
constexpr int BN2 = 256;       // gallery rows per sub-tile (wgmma N)
constexpr int Q_BOX = QT2 * sm90::LINE_BYTES;   // one 64-feature chunk of the queries
constexpr int G_BOX = BN2 * sm90::LINE_BYTES;   // one ring stage
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may use

// grid (query tiles, runs of `run` tiles); 384 threads: warpgroups 0-1
// consume, 2 produces. qmap: [B, da] boxes [128 x 64]; gmap: [Np, da]
// boxes [256 x 64]; n_chunks = ceil(da / 64) boxes per row block.
__global__ void __launch_bounds__(sm90::THREADS, 1)
tilemin2_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
              int32_t* __restrict__ out1, int32_t* __restrict__ out2, int B, int n_tiles, int n_chunks,
              int run, int stages) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = sm90::aligned_smem(smem_raw);
    unsigned char* q_s = smem;                           // [n_chunks][QT2 x 64], resident
    unsigned char* ring = smem + n_chunks * Q_BOX;       // [stages][BN2 x 64]
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * G_BOX);
    uint64_t* empty = full + stages;
    uint64_t* q_full = empty + stages;

    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * QT2;
    const int tile0 = blockIdx.y * run;
    const int tile1 = min(n_tiles, tile0 + run);
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            sm90::mbar_init(&full[s], 1);
            sm90::mbar_init(&empty[s], 2);
        }
        sm90::mbar_init(q_full, 1);
        sm90::mbar_init_fence();
    }
    __syncthreads();

    const int wg = tid / sm90::WG_THREADS;
    if (wg == 2) {
        sm90::setmaxnreg_dec<40>();
        if (tid == 2 * sm90::WG_THREADS) {
            sm90::prefetch_map(&qmap);
            sm90::prefetch_map(&gmap);
            sm90::mbar_arrive_expect_tx(q_full, n_chunks * Q_BOX);
            for (int c = 0; c < n_chunks; ++c)
                sm90::tma_load_2d(q_s + c * Q_BOX, &qmap, q_full, c * sm90::KCHUNK, q0);
            int s = 0;
            uint32_t ph = 0;
            for (int tile = tile0; tile < tile1; ++tile)
                for (int sub = 0; sub < TILE_G2 / BN2; ++sub)
                    for (int c = 0; c < n_chunks; ++c) {
                        sm90::mbar_wait(&empty[s], ph ^ 1);
                        sm90::mbar_arrive_expect_tx(&full[s], G_BOX);
                        sm90::tma_load_2d(ring + s * G_BOX, &gmap, &full[s], c * sm90::KCHUNK,
                                          tile * TILE_G2 + sub * BN2);
                        if (++s == stages) { s = 0; ph ^= 1; }
                    }
        }
    } else {
        sm90::setmaxnreg_inc<232>();
        const int t = tid % sm90::WG_THREADS;
        const unsigned char* qa = q_s + wg * 64 * sm90::LINE_BYTES;  // this warpgroup's 64 queries
        float acc[BN2 / 2];
        int s = 0, prev = 0;
        uint32_t ph = 0;
        sm90::mbar_wait(q_full, 0);
        for (int tile = tile0; tile < tile1; ++tile) {
            int m1[2] = {INT32_MAX, INT32_MAX}, m2[2] = {INT32_MAX, INT32_MAX};
            for (int sub = 0; sub < TILE_G2 / BN2; ++sub) {
#pragma unroll
                for (int i = 0; i < BN2 / 2; ++i) acc[i] = 0.0f;
                for (int c = 0; c < n_chunks; ++c) {
                    sm90::mbar_wait(&full[s], ph);
                    const unsigned char* gb = ring + s * G_BOX;
                    sm90::acc_fence(acc);
                    sm90::wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < sm90::KCHUNK / 16; ++kk)
                        sm90::Wgmma<BN2>::mma(acc, sm90::sw128_desc(qa + c * Q_BOX + 32 * kk),
                                              sm90::sw128_desc(gb + 32 * kk));
                    sm90::wgmma_commit();
                    sm90::wgmma_wait<1>();
                    sm90::acc_fence(acc);
                    if (c > 0 && t == 0) sm90::mbar_arrive(&empty[prev]);
                    prev = s;
                    if (++s == stages) { s = 0; ph ^= 1; }
                }
                sm90::wgmma_wait<0>();
                sm90::acc_fence(acc);
                if (t == 0) sm90::mbar_arrive(&empty[prev]);
                // keys of this sub-tile into (m1, m2) of the thread's two rows
#pragma unroll
                for (int j = 0; j < BN2 / 8; ++j)
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        const int row = sub * BN2 + sm90::acc_col(t, j, c);
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            const int key = (__float_as_int(acc[4 * j + 2 * h + c]) & ~(TILE_G2 - 1)) | row;
                            m2[h] = min(m2[h], max(m1[h], key));
                            m1[h] = min(m1[h], key);
                        }
                    }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
                for (int off = 1; off < 4; off <<= 1) {
                    const int b1 = __shfl_xor_sync(0xffffffffu, m1[h], off);
                    const int b2 = __shfl_xor_sync(0xffffffffu, m2[h], off);
                    pair_combine(m1[h], m2[h], b1, b2);
                }
                const int qi = q0 + wg * 64 + sm90::acc_row(t, h);
                if ((t & 3) == 0 && qi < B) {
                    out1[(size_t)qi * n_tiles + tile] = m1[h];
                    out2[(size_t)qi * n_tiles + tile] = m2[h];
                }
            }
        }
    }
}

int launch_min2(const void* q, const void* g, void* out1, void* out2, int B, int n_tiles, int da,
                void* stream) {
    if (B <= 0 || n_tiles <= 0 || da <= 0 || da % 16 != 0) return (int)cudaErrorInvalidValue;
    const int n_chunks = (da + sm90::KCHUNK - 1) / sm90::KCHUNK;
    // alignment slack, resident queries, the ring and (2 stages + 1) barriers
    const int fixed = sm90::SMEM_ALIGN + n_chunks * Q_BOX + (2 * MAX_STAGES + 1) * 8;
    const int stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) / G_BOX);
    if (stages < 2) return (int)cudaErrorInvalidValue;
    const size_t smem = fixed + (size_t)stages * G_BOX;
    CUtensorMap qmap, gmap;
    int err = sm90::encode_bf16_map(&qmap, q, da, B, (long)da * 2, QT2);
    if (err == 0) err = sm90::encode_bf16_map(&gmap, g, da, (long)n_tiles * TILE_G2, (long)da * 2, BN2);
    if (err != 0) return err;
    // one block per SM: the query tiles of a run of tiles side by side
    const int n_qt = (B + QT2 - 1) / QT2;
    const int sms = sm90::sm_count();
    if (sms <= 0) return (int)cudaErrorInvalidDevice;
    const int n_runs = max(1, min(n_tiles, sms / n_qt));
    const int run = (n_tiles + n_runs - 1) / n_runs;
    cudaError_t e = cudaFuncSetAttribute(tilemin2_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(n_qt, (n_tiles + run - 1) / run);
    tilemin2_sm90<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(
        qmap, gmap, (int32_t*)out1, (int32_t*)out2, B, n_tiles, n_chunks, run, stages);
    return (int)cudaGetLastError();
}

// ---- the single-min scan: tilemin_packed_kernel ----

constexpr int QB = 64;         // queries per block
constexpr int RB = 64;         // gallery rows per sub-tile
constexpr int THREADS = 256;   // 8 warps
constexpr int PAD = 8;         // bf16 row padding in shared memory
constexpr int ACC_LD = RB + 4; // fp32 accumulator tile, [query][row]
constexpr int QPW = QB / (THREADS / 32);  // query columns reduced per warp

__global__ void __launch_bounds__(THREADS)
tilemin_packed_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ g,
                      int32_t* __restrict__ out,
                      int B, int n_tiles, int da, int tile_g) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int ld = da + PAD;
    __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [QB][ld]
    __nv_bfloat16* g_s = q_s + QB * ld;                             // [RB][ld]
    float* acc_s = reinterpret_cast<float*>(g_s + RB * ld);         // [QB][ACC_LD]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int q0 = blockIdx.x * QB;
    const int tile = blockIdx.y;
    const int vpr = da / 8;  // 16-byte vectors per row

    for (int v = tid; v < QB * vpr; v += THREADS) {
        const int r = v / vpr, c = v % vpr;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < B) val = reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * da)[c];
        reinterpret_cast<uint4*>(q_s + r * ld)[c] = val;
    }

    int m1[QPW];
#pragma unroll
    for (int i = 0; i < QPW; ++i) m1[i] = INT32_MAX;

    const int mf = warp >> 1;        // 16-row slice of the sub-tile
    const int nf = (warp & 1) * 2;   // first of two 16-query slices
    const __nv_bfloat16* gtile = g + (size_t)tile * tile_g * da;
    const int mask = ~(tile_g - 1);

    for (int sub = 0; sub < tile_g / RB; ++sub) {
        const __nv_bfloat16* src = gtile + (size_t)sub * RB * da;
        for (int v = tid; v < RB * vpr; v += THREADS) {
            const int r = v / vpr, c = v % vpr;
            reinterpret_cast<uint4*>(g_s + r * ld)[c] =
                reinterpret_cast<const uint4*>(src + (size_t)r * da)[c];
        }
        __syncthreads();

        wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
        wmma::fill_fragment(c0, 0.0f);
        wmma::fill_fragment(c1, 0.0f);
        for (int k0 = 0; k0 < da; k0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b0, b1;
            wmma::load_matrix_sync(a, g_s + mf * 16 * ld + k0, ld);
            wmma::load_matrix_sync(b0, q_s + nf * 16 * ld + k0, ld);
            wmma::load_matrix_sync(b1, q_s + (nf + 1) * 16 * ld + k0, ld);
            wmma::mma_sync(c0, a, b0, c0);
            wmma::mma_sync(c1, a, b1, c1);
        }
        // column-major store: acc_s[query * ACC_LD + row]
        wmma::store_matrix_sync(acc_s + nf * 16 * ACC_LD + mf * 16, c0, ACC_LD, wmma::mem_col_major);
        wmma::store_matrix_sync(acc_s + (nf + 1) * 16 * ACC_LD + mf * 16, c1, ACC_LD, wmma::mem_col_major);
        __syncthreads();

#pragma unroll
        for (int i = 0; i < QPW; ++i) {
            const float* col = acc_s + (warp * QPW + i) * ACC_LD;
#pragma unroll
            for (int h = 0; h < RB / 32; ++h) {
                const int r = lane + 32 * h;
                m1[i] = min(m1[i], (__float_as_int(col[r]) & mask) | (sub * RB + r));
            }
        }
        // The next sub-tile's g_s writes follow the barrier above (all
        // products done); its acc_s writes follow the next barrier (all
        // reductions done).
    }

#pragma unroll
    for (int i = 0; i < QPW; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m1[i] = min(m1[i], __shfl_xor_sync(0xffffffffu, m1[i], off));
        const int qi = q0 + warp * QPW + i;
        if (lane == 0 && qi < B) out[(size_t)qi * n_tiles + tile] = m1[i];
    }
}

int launch_single(const void* q, const void* g, void* out, int B, int n_tiles, int da, int tile_g,
                  void* stream) {
    if (B <= 0 || n_tiles <= 0 || da <= 0 || da % 16 != 0 || n_tiles > 65535 ||
        tile_g < 128 || tile_g > 1024 || (tile_g & (tile_g - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(QB + RB) * (da + PAD) * sizeof(__nv_bfloat16) +
                        (size_t)QB * ACC_LD * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(tilemin_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + QB - 1) / QB, n_tiles);
    tilemin_packed_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)g, (int32_t*)out, B, n_tiles, da, tile_g);
    return (int)cudaGetLastError();
}

}  // namespace

// q: [B, da] bf16, g: [n_tiles * 1024, da] bf16 (both 16-byte aligned),
// out1/out2: [B, n_tiles] int32. Returns a cudaError_t value (0 on
// success); launches on `stream`.
extern "C" int tilemin2_packed_launch(const void* q, const void* g, void* out1,
                                      void* out2, int B, int n_tiles, int da,
                                      void* stream) {
    return launch_min2(q, g, out1, out2, B, n_tiles, da, stream);
}

// q: [B, da] bf16, g: [n_tiles * tile_g, da] bf16, out: [B, n_tiles] int32;
// tile_g is 128, 256, 512 or 1024. Returns a cudaError_t value.
extern "C" int tilemin_packed_launch(const void* q, const void* g, void* out,
                                     int B, int n_tiles, int da, int tile_g,
                                     void* stream) {
    return launch_single(q, g, out, B, n_tiles, da, tile_g, stream);
}
