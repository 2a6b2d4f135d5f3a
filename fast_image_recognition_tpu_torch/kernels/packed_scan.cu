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
// survivor capacities of a few hundred queries it is bytes bound. Design:
// one block owns (64 queries, one tile); the query block stays in shared
// memory, the tile streams through in 64-row sub-tiles, WMMA bf16 x bf16 ->
// fp32 products (what the MXU does with preferred_element_type=f32) land in
// a shared fp32 tile, and each warp reduces 8 query columns to keys in
// registers, combined across lanes with warp shuffles. Query blocks vary
// fastest in the grid, so the blocks that read one gallery tile run
// together and share it through L2. No cp.async/TMA pipelining and no
// wgmma yet: a simple, correct first kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TILE_G2 = 1024;  // gallery rows per tile of the min-2 scan
constexpr int QB = 64;         // queries per block
constexpr int RB = 64;         // gallery rows per sub-tile
constexpr int THREADS = 256;   // 8 warps
constexpr int PAD = 8;         // bf16 row padding in shared memory
constexpr int ACC_LD = RB + 4; // fp32 accumulator tile, [query][row]
constexpr int QPW = QB / (THREADS / 32);  // query columns reduced per warp

__device__ __forceinline__ void pair_combine(int& m1, int& m2, int b1, int b2) {
    const int lo = min(m1, b1);
    const int hi = max(m1, b1);
    m2 = min(hi, min(m2, b2));
    m1 = lo;
}

// EMIT2: also track and write the second-smallest key (out2).
template <bool EMIT2>
__global__ void __launch_bounds__(THREADS)
tilemin_packed_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ g,
                      int32_t* __restrict__ out1,
                      int32_t* __restrict__ out2,
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

    int m1[QPW], m2[QPW];
#pragma unroll
    for (int i = 0; i < QPW; ++i) { m1[i] = INT32_MAX; m2[i] = INT32_MAX; }

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
                const int key = (__float_as_int(col[r]) & mask) | (sub * RB + r);
                if (EMIT2) {
                    if (key < m1[i]) { m2[i] = m1[i]; m1[i] = key; }
                    else if (key < m2[i]) { m2[i] = key; }
                } else {
                    m1[i] = min(m1[i], key);
                }
            }
        }
        // The next sub-tile's g_s writes follow the barrier above (all
        // products done); its acc_s writes follow the next barrier (all
        // reductions done).
    }

#pragma unroll
    for (int i = 0; i < QPW; ++i) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const int b1 = __shfl_xor_sync(0xffffffffu, m1[i], off);
            if (EMIT2) {
                const int b2 = __shfl_xor_sync(0xffffffffu, m2[i], off);
                pair_combine(m1[i], m2[i], b1, b2);
            } else {
                m1[i] = min(m1[i], b1);
            }
        }
        const int qi = q0 + warp * QPW + i;
        if (lane == 0 && qi < B) {
            out1[(size_t)qi * n_tiles + tile] = m1[i];
            if (EMIT2) out2[(size_t)qi * n_tiles + tile] = m2[i];
        }
    }
}

template <bool EMIT2>
int launch(const void* q, const void* g, void* out1, void* out2, int B,
           int n_tiles, int da, int tile_g, void* stream) {
    if (B <= 0 || n_tiles <= 0 || da <= 0 || da % 16 != 0 || n_tiles > 65535 ||
        tile_g < 128 || tile_g > 1024 || (tile_g & (tile_g - 1)) != 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(QB + RB) * (da + PAD) * sizeof(__nv_bfloat16) +
                        (size_t)QB * ACC_LD * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        tilemin_packed_kernel<EMIT2>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((B + QB - 1) / QB, n_tiles);
    tilemin_packed_kernel<EMIT2><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)g, (int32_t*)out1,
        (int32_t*)out2, B, n_tiles, da, tile_g);
    return (int)cudaGetLastError();
}

}  // namespace

// q: [B, da] bf16, g: [n_tiles * 1024, da] bf16, out1/out2: [B, n_tiles] int32.
// Returns a cudaError_t value (0 on success); launches on `stream`.
extern "C" int tilemin2_packed_launch(const void* q, const void* g, void* out1,
                                      void* out2, int B, int n_tiles, int da,
                                      void* stream) {
    return launch<true>(q, g, out1, out2, B, n_tiles, da, TILE_G2, stream);
}

// q: [B, da] bf16, g: [n_tiles * tile_g, da] bf16, out: [B, n_tiles] int32;
// tile_g is 128, 256, 512 or 1024. Returns a cudaError_t value.
extern "C" int tilemin_packed_launch(const void* q, const void* g, void* out,
                                     int B, int n_tiles, int da, int tile_g,
                                     void* stream) {
    return launch<false>(q, g, out, nullptr, B, n_tiles, da, tile_g, stream);
}
