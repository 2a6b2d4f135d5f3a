// Per-tile min and argmin scans for sm_90a on sm90_scan.cuh: `tilemin_launch`
// replaces `_tilemin_kernel` (ops/distance_kernel.py:174), min of |g|^2 - 2 q.g
// per query and `tile_g`-row tile; `tilemin_quant_launch` `_tilemin_quant_kernel`
// (:671), gsq - (2 s_q) (cross s_g), each step rounded. Query tiles run
// fastest: blocks share the gallery through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_scan.cuh"

namespace {

constexpr float BIG_DIST = 3.4e38f;
constexpr int QT = 128;
constexpr int BN = 256;
constexpr int HALF = BN / 2;
constexpr int MAX_STAGES = 4;   // TMA ring depth
constexpr int MAX_GRID_Y = 65535;  // the grid's y limit
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Each of the thread's two rows' (score, row), merged over the row's 4 lanes
// and written; then reset.
__device__ __forceinline__ void store_tile(float (&bv)[2], int (&bi)[2], float* __restrict__ out_d,
                     int32_t* __restrict__ out_i, int q, int t, int B, int n_tiles,
                     int tile, int next_row) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv[h], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[h], off);
      if (before(ov, oi, bv[h], bi[h])) { bv[h] = ov; bi[h] = oi; }
    }
    const int qi = q + sm90::acc_row(t, h);
    if ((t & 3) == 0 && qi < B && tile < n_tiles) {
      out_d[(size_t)qi * n_tiles + tile] = bv[h];
      out_i[(size_t)qi * n_tiles + tile] = bi[h];
    }
    bv[h] = inf();
    bi[h] = next_row;
  }
}

// ---- the bf16 scan: tilemin_sm90 ----

constexpr int Q_BOX = QT * sm90::LINE_BYTES;
constexpr int G_BOX = BN * sm90::LINE_BYTES;

// grid (query tiles, runs of `run` units); 384 threads, warpgroups 0-1 consume,
// 2 produces. A unit: a tile of >= 256 rows, or two of 128. qmap [B, D] boxes
// [128 x 64]; gmap boxes [256 x 64]. STREAM: a stage holds [QT x 64] query
// lanes, then [BN x 64] gallery lanes. One text for both (it won the A/B).
template <bool BF16S, bool STREAM>
__global__ void __launch_bounds__(sm90::THREADS, 1)
tilemin_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
      const float* __restrict__ gsq, float* __restrict__ out_d, int32_t* __restrict__ out_i, int B,
      int n_tiles, int tile_g, int n_chunks, int run, int stages) {
  constexpr int STAGE = STREAM ? Q_BOX + G_BOX : G_BOX;
  constexpr int G_OFF = STREAM ? Q_BOX : 0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  unsigned char* q_s = smem;                                      // [n_chunks][QT x 64], resident
  unsigned char* ring = STREAM ? smem : smem + n_chunks * Q_BOX;  // [stages][STAGE]
  float* g2_s = reinterpret_cast<float*>(ring + stages * STAGE);  // [2 warpgroups][2][BN]
  uint64_t* full = reinterpret_cast<uint64_t*>(g2_s + 4 * BN);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int n_rows = n_tiles * tile_g;
  const int unit_rows = max(tile_g, BN);
  const int subs = unit_rows / BN;
  const int unit0 = blockIdx.y * run;
  const int unit1 = min((n_rows + unit_rows - 1) / unit_rows, unit0 + run);
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
    // producer: one thread keeps the ring full
    sm90::setmaxnreg_dec<40>();
    if (tid == 2 * sm90::WG_THREADS) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&gmap);
      if (!STREAM) {
        sm90::mbar_arrive_expect_tx(q_full, n_chunks * Q_BOX);
        for (int c = 0; c < n_chunks; ++c)
          sm90::tma_load_2d(q_s + c * Q_BOX, &qmap, q_full, c * sm90::KCHUNK, q0);
      }
      int s = 0;
      uint32_t ph = 0;
      for (int unit = unit0; unit < unit1; ++unit)
        for (int sub = 0; sub < subs; ++sub)
          for (int c = 0; c < n_chunks; ++c) {
            sm90::mbar_wait(&empty[s], ph ^ 1);
            sm90::mbar_arrive_expect_tx(&full[s], STAGE);
            if (STREAM) sm90::tma_load_2d(ring + s * STAGE, &qmap, &full[s], c * sm90::KCHUNK, q0);
            sm90::tma_load_2d(ring + s * STAGE + G_OFF, &gmap, &full[s], c * sm90::KCHUNK,
                     (unit * subs + sub) * BN);
            if (++s == stages) { s = 0; ph ^= 1; }
          }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int t = tid % sm90::WG_THREADS;
    // this warpgroup's 64 queries: resident chunks, or the stage's
    const unsigned char* qa = (STREAM ? ring : q_s) + wg * 64 * sm90::LINE_BYTES;
    float acc[BN / 2];
    float bv[2] = {inf(), inf()};
    int bi[2] = {unit0 * unit_rows, unit0 * unit_rows};  // an all-inf tile: its first row
    int s = 0, prev = 0, it = 0;
    uint32_t ph = 0;
    if (!STREAM) sm90::mbar_wait(q_full, 0);
    for (int unit = unit0; unit < unit1; ++unit) {
      for (int sub = 0; sub < subs; ++sub, ++it) {
        const int r0 = (unit * subs + sub) * BN;
        // this sub-tile's |g|^2, two rows a thread, landing while the
        // products run
        float g2_own[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int gr = r0 + t + i * HALF;
          g2_own[i] = gr < n_rows ? gsq[gr] : BIG_DIST;
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
        for (int c = 0; c < n_chunks; ++c) {
          sm90::mbar_wait(&full[s], ph);
          const unsigned char* gb = ring + s * STAGE + G_OFF;
          const unsigned char* qc = qa + (STREAM ? s * STAGE : c * Q_BOX);
          sm90::acc_fence(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < sm90::KCHUNK / 16; ++kk)
            sm90::wgmma_m64n256k16(acc, sm90::sw128_desc(qc + 32 * kk), sm90::sw128_desc(gb + 32 * kk));
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

        // a copy and two buffers a warpgroup, one barrier a sub-tile
        float* g2b = g2_s + (2 * wg + (it & 1)) * BN;
#pragma unroll
        for (int i = 0; i < 2; ++i) g2b[t + i * HALF] = BF16S ? bf16_round(g2_own[i]) : g2_own[i];
        sm90::named_bar_sync(2 + wg, sm90::WG_THREADS);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int j = 0; j < HALF / 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = sm90::acc_col(t, half * HALF / 8 + j, c);
              const float g2 = g2b[col];
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float x = acc[4 * (half * HALF / 8 + j) + 2 * h + c];
                // -2 x is exact, so one FMA rounds as g2 - 2 x does
                const float score = BF16S ? bf16_round(__fsub_rn(g2, bf16_round(__fmul_rn(2.0f, x))))
                             : __fmaf_rn(-2.0f, x, g2);
                // columns rise within a thread: strict < keeps the lowest row
                if (score < bv[h]) { bv[h] = score; bi[h] = r0 + col; }
              }
            }
          }
          const int end = r0 + (half + 1) * HALF;
          if ((end & (tile_g - 1)) == 0)  // a tile ends with this half
            store_tile(bv, bi, out_d, out_i, q0 + wg * 64, t, B, n_tiles, end / tile_g - 1, end);
        }
      }
    }
  }
}

template <bool BF16S>
int launch_tilemin(const void* q, const void* g, const void* gsq, void* out_d, void* out_i, int B, int n_tiles,
         int D, int tile_g, void* stream) {
  if (B <= 0 || n_tiles <= 0 || D <= 0 || D % 8 != 0 || tile_g < HALF || tile_g > 1024 ||
    (tile_g & (tile_g - 1)) != 0 || (long)n_tiles * tile_g > INT32_MAX - BN)
    return (int)cudaErrorInvalidValue;
  const int n_rows = n_tiles * tile_g;
  const int n_chunks = (D + sm90::KCHUNK - 1) / sm90::KCHUNK;
  // slack, |g|^2, (2 stages + 1) barriers, resident queries (streamed above D
  // = 640)
  const int fixed = sm90::SMEM_ALIGN + 4 * BN * 4 + (2 * MAX_STAGES + 1) * 8;
  const int resident_stages = min(MAX_STAGES, (SMEM_LIMIT - fixed - n_chunks * Q_BOX) / G_BOX);
  const bool stream_q = resident_stages < 2;
  const int stages = stream_q ? min(MAX_STAGES, (SMEM_LIMIT - fixed) / (Q_BOX + G_BOX)) : resident_stages;
  const size_t smem = stream_q ? fixed + (size_t)stages * (Q_BOX + G_BOX)
                : fixed + (size_t)n_chunks * Q_BOX + (size_t)stages * G_BOX;
  CUtensorMap qmap, gmap;
  int err = sm90::encode_bf16_map(&qmap, q, D, B, (long)D * 2, QT);
  if (err == 0) err = sm90::encode_bf16_map(&gmap, g, D, n_rows, (long)D * 2, BN);
  if (err != 0) return err;
  // one block per SM: the query tiles of a run of units side by side
  const int unit_rows = max(tile_g, BN);
  const int n_units = (n_rows + unit_rows - 1) / unit_rows;
  const int n_qt = (B + QT - 1) / QT;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int n_runs = max(1, min(n_units, sms / n_qt));
  const int run = (n_units + n_runs - 1) / n_runs;
  auto kernel = stream_q ? tilemin_sm90<BF16S, true> : tilemin_sm90<BF16S, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_qt, (n_units + run - 1) / run);
  kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(qmap, gmap, (const float*)gsq, (float*)out_d,
                                 (int32_t*)out_i, B, n_tiles, tile_g, n_chunks,
                                 run, stages);
  return (int)cudaGetLastError();
}

// ---- the int8 scan with int8 compute: tilemin_quant_sm90 ----

constexpr int QT8 = 128;
constexpr int BN8 = 256;
constexpr int HALF8 = BN8 / 2;
constexpr int SEG_ROWS = 2048;
constexpr int STAGES = 4;       // TMA ring depth
constexpr int Q_BYTES = QT8 * sm90::LINE_BYTES;
constexpr int G_BYTES = BN8 * sm90::LINE_BYTES;
constexpr int STAGE_BYTES = Q_BYTES + G_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr size_t SMEM8 = sm90::SMEM_ALIGN + RING_BYTES + 4 * BN8 * 4 + 2 * STAGES * 8;

// grid (query tiles, segments from seg_base); 384 threads. qmap int8 boxes [128
// x 128]; gmap int8 boxes [256 x 128].
__global__ void __launch_bounds__(sm90::THREADS, 1)
tilemin_quant_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
         const float* __restrict__ qs, const float* __restrict__ gsq, const float* __restrict__ gsc,
         float* __restrict__ out_d, int32_t* __restrict__ out_i, int B, int n_tiles, int tile_g,
         int n_chunks, int seg_base) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  float* gsq_s = reinterpret_cast<float*>(smem + RING_BYTES);  // [2][BN8]
  float* gsc_s = gsq_s + 2 * BN8;                               // [2][BN8]
  uint64_t* full = reinterpret_cast<uint64_t*>(gsc_s + 2 * BN8);  // [STAGES]
  uint64_t* empty = full + STAGES;                                // [STAGES]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT8;
  const int n_rows = n_tiles * tile_g;
  const int seg0 = (seg_base + blockIdx.y) * SEG_ROWS;
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
    const int t = tid % sm90::WG_THREADS;
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
      // this sub-tile's |g|^2 and s_g, a row a thread, landing while the
      // products run
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

      float* g2_s = gsq_s + (sub & 1) * BN8;
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
  const int n_seg = (int)((n_rows + SEG_ROWS - 1) / SEG_ROWS);
  cudaError_t e = cudaFuncSetAttribute(tilemin_quant_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                    (int)SMEM8);
  if (e != cudaSuccess) return (int)e;
  for (int sb = 0; sb < n_seg; sb += MAX_GRID_Y) {
    const dim3 grid((B + QT8 - 1) / QT8, min(MAX_GRID_Y, n_seg - sb));
    tilemin_quant_sm90<<<grid, sm90::THREADS, SMEM8, (cudaStream_t)stream>>>(
      qmap, gmap, (const float*)qs, (const float*)gsq, (const float*)gsc, (float*)out_d, (int32_t*)out_i, B,
      n_tiles, tile_g, n_chunks, sb);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// ---- the int8 scan with bf16 compute: tilemin_quant_bf16_sm90 ----

constexpr int QTB = 256;
constexpr int RB = 128;
constexpr int STAGES_B = 2;  // TMA ring depth
constexpr int QB_BOX = QTB * sm90::LINE_BYTES;
constexpr int GB_BOX = RB * sm90::LINE_BYTES;
constexpr int STAGE_B = 2 * QB_BOX + GB_BOX;
constexpr int RED_BYTES = 2 * 8 * QTB * 8;
constexpr size_t SMEM_B = sm90::SMEM_ALIGN + (size_t)STAGES_B * STAGE_B + RED_BYTES + QTB * 4 + 2 * STAGES_B * 8;

// int8 -> bf16 of bytes 2 i, 2 i + 1, packed as bf16x2 (lower byte low); exact.
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t x, int i) {
  const float lo = __int2float_rn((int)(int8_t)(x >> (16 * i)));
  const float hi = __int2float_rn((int)(int8_t)(x >> (16 * i + 8)));
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (v, r) <- the (score, row) least of itself and (ov, oi)
__device__ __forceinline__ void keep_least(float& v, int& r, float ov, int oi) {
  if (before(ov, oi, v, r)) { v = ov; r = oi; }
}

// grid (256-query tiles fastest, segments); 384 threads. qmap bf16 boxes [256 x
// 64]; gmap int8 boxes [128 x 128].
__global__ void __launch_bounds__(sm90::THREADS, 1)
tilemin_quant_bf16_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
            const float* __restrict__ qs, const float* __restrict__ gsq,
            const float* __restrict__ gsc, float* __restrict__ out_d, int32_t* __restrict__ out_i,
            int B, int D, int n_tiles, int tile_g, int n_chunks) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  float* red_v = reinterpret_cast<float*>(smem + STAGES_B * STAGE_B);  // [2][8][QTB]
  int* red_r = reinterpret_cast<int*>(red_v + 2 * 8 * QTB);            // [2][8][QTB]
  float* qs2_s = reinterpret_cast<float*>(red_r + 2 * 8 * QTB);        // [QTB]
  uint64_t* full = reinterpret_cast<uint64_t*>(qs2_s + QTB);           // [STAGES_B]
  uint64_t* empty = full + STAGES_B;                                   // [STAGES_B]

  const int tid = threadIdx.x;
  const int n_qt = (B + QTB - 1) / QTB;
  const int q0 = (int)(blockIdx.x % n_qt) * QTB;
  const int n_rows = n_tiles * tile_g;
  const int seg0 = (int)(blockIdx.x / n_qt) * SEG_ROWS;
  const int n_sub = (min(n_rows, seg0 + SEG_ROWS) - seg0) / RB;
  if (tid == 0) {
    for (int s = 0; s < STAGES_B; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / sm90::WG_THREADS;
  if (wg == 2) {
    // producer: one thread; a query box past D is not loaded, its products
    // skipped
    sm90::setmaxnreg_dec<40>();
    if (tid == 2 * sm90::WG_THREADS) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&gmap);
      int s = 0;
      uint32_t ph = 0;
      for (int sub = 0; sub < n_sub; ++sub)
        for (int c = 0; c < n_chunks; ++c) {
          const bool two = D - c * sm90::KCHUNK_S8 > sm90::KCHUNK;
          sm90::mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = smem + s * STAGE_B;
          sm90::mbar_arrive_expect_tx(&full[s], (two ? 2 : 1) * QB_BOX + GB_BOX);
          sm90::tma_load_2d(st, &qmap, &full[s], c * sm90::KCHUNK_S8, q0);
          if (two) sm90::tma_load_2d(st + QB_BOX, &qmap, &full[s], c * sm90::KCHUNK_S8 + sm90::KCHUNK, q0);
          sm90::tma_load_2d(st + 2 * QB_BOX, &gmap, &full[s], c * sm90::KCHUNK_S8, seg0 + sub * RB);
          if (++s == STAGES_B) { s = 0; ph ^= 1; }
        }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int t = tid % sm90::WG_THREADS;
    const int lane = tid & 31, warp = tid >> 5;
    const int quad = lane & 3;
    // bytes 2 (quad % 2), + 1 of the word at 4 (quad / 2) and 8 bytes on:
    // features 2 quad, + 1, 8 + 2 quad, + 1 of a 16-feature chunk
    const uint32_t sel = (quad & 1) ? 0x7632u : 0x5410u;
    const int word = 4 * (quad >> 1);
    qs2_s[tid] = q0 + tid < B ? 2.0f * qs[q0 + tid] : 0.0f;
    sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
    float acc[QTB / 2];
    float bv = inf();
    int bi = seg0;
    int s = 0;
    uint32_t ph = 0;
    for (int sub = 0; sub < n_sub; ++sub) {
      const int r0 = seg0 + sub * RB;
      // the thread's two gallery rows, their |g|^2 and s_g, loaded while
      // the products run
      const int lr = wg * 64 + sm90::acc_row(t, 0);
      float g2[2], sg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        g2[h] = gsq[r0 + lr + 8 * h];
        sg[h] = gsc[r0 + lr + 8 * h];
      }
#pragma unroll
      for (int i = 0; i < QTB / 2; ++i) acc[i] = 0.0f;
      for (int c = 0; c < n_chunks; ++c) {
        sm90::mbar_wait(&full[s], ph);
        const unsigned char* st = smem + s * STAGE_B;
        const unsigned char* line = st + 2 * QB_BOX + lr * sm90::LINE_BYTES;
        const int steps = D - c * sm90::KCHUNK_S8 > sm90::KCHUNK ? 8 : 4;
        // A fragments of the 8 k16 steps: int8 from the swizzled line
        // (chunk ks at ks ^ (row % 8)), bf16 in registers
        uint32_t a[8][4];
#pragma unroll
        for (int ks = 0; ks < 8; ++ks) {
          if (ks < steps) {
            const int off = ((ks ^ (lr & 7)) << 4) + word;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t lo = *reinterpret_cast<const uint32_t*>(line + 1024 * h + off);
              const uint32_t hi = *reinterpret_cast<const uint32_t*>(line + 1024 * h + off + 8);
              const uint32_t x = __byte_perm(lo, hi, sel);  // features 2q, 2q+1, 8+2q, 9+2q
              a[ks][h] = s8x2_to_bf16x2(x, 0);
              a[ks][2 + h] = s8x2_to_bf16x2(x, 1);
            }
          }
        }
        sm90::acc_fence(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          if (ks < steps)
            sm90::wgmma_m64n256k16_rs(acc, a[ks], sm90::sw128_desc(st + (ks >> 2) * QB_BOX + 32 * (ks & 3)));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::acc_fence(acc);
        if (t == 0) sm90::mbar_arrive(&empty[s]);
        if (++s == STAGES_B) { s = 0; ph ^= 1; }
      }

      // per query column m = 2 j + c: the (score, row) least of the
      // thread's two rows
      float v[QTB / 4];
      int r[QTB / 4];
#pragma unroll
      for (int j = 0; j < QTB / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float qs2 = qs2_s[sm90::acc_col(t, j, c)];
          float sc[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            sc[h] = __fsub_rn(g2[h], __fmul_rn(qs2, __fmul_rn(acc[4 * j + 2 * h + c], sg[h])));
          const bool second = sc[1] < sc[0];  // a tie keeps the lower row
          v[2 * j + c] = second ? sc[1] : sc[0];
          r[2 * j + c] = r0 + lr + (second ? 8 : 0);
        }
      }
      // a quad residue's 8 lanes halve their columns three times (xor 16,
      // 8, 4): the least over the warp's 16 rows
#pragma unroll
      for (int step = 0; step < 3; ++step) {
        const int off = 16 >> step;
        const int n = 64 >> step;
        const bool upper = lane & off;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (i < n / 2) {
            const float send_v = upper ? v[i] : v[i + n / 2];
            const int send_r = upper ? r[i] : r[i + n / 2];
            const float ov = __shfl_xor_sync(0xffffffffu, send_v, off);
            const int oi = __shfl_xor_sync(0xffffffffu, send_r, off);
            float kv = upper ? v[i + n / 2] : v[i];
            int kr = upper ? r[i + n / 2] : r[i];
            keep_least(kv, kr, ov, oi);
            v[i] = kv;
            r[i] = kr;
          }
        }
      }
      float* rv = red_v + (sub & 1) * 8 * QTB + warp * QTB;
      int* rr = red_r + (sub & 1) * 8 * QTB + warp * QTB;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = 8 * (lane >> 2) + i;
        const int q = 8 * (m >> 1) + 2 * quad + (m & 1);
        rv[q] = v[i];
        rr[q] = r[i];
      }
      sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
      // consumer thread tid: query tid, over the 8 warps' rows
      const float* sv = red_v + (sub & 1) * 8 * QTB;
      const int* sr = red_r + (sub & 1) * 8 * QTB;
      float mv = sv[tid];
      int mr = sr[tid];
#pragma unroll
      for (int w = 1; w < 8; ++w) keep_least(mv, mr, sv[w * QTB + tid], sr[w * QTB + tid]);
      if (mv < bv) { bv = mv; bi = mr; }
      const int end = r0 + RB;
      if ((end & (tile_g - 1)) == 0) {  // a tile ends with this sub-tile
        const int tile = end / tile_g - 1;
        if (q0 + tid < B) {
          out_d[(size_t)(q0 + tid) * n_tiles + tile] = bv;
          out_i[(size_t)(q0 + tid) * n_tiles + tile] = bi;
        }
        bv = inf();
        bi = end;
      }
    }
  }
}

int launch_quant_bf16_sm90(const void* q, const void* qs, const void* g, const void* gsq, const void* gsc,
             void* out_d, void* out_i, int B, int n_tiles, int D, int tile_g, void* stream) {
  if (B <= 0 || n_tiles <= 0 || D <= 0 || D % 16 != 0 || tile_g < RB || tile_g > 1024 ||
    (tile_g & (tile_g - 1)) != 0 || (long)n_tiles * tile_g > INT32_MAX - SEG_ROWS)
    return (int)cudaErrorInvalidValue;
  const long n_rows = (long)n_tiles * tile_g;
  const long blocks = (long)((B + QTB - 1) / QTB) * ((n_rows + SEG_ROWS - 1) / SEG_ROWS);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap qmap, gmap;
  int err = sm90::encode_bf16_map(&qmap, q, D, B, (long)D * 2, QTB);
  if (err == 0) err = sm90::encode_s8_map(&gmap, g, D, n_rows, D, RB);
  if (err != 0) return err;
  const int n_chunks = (D + sm90::KCHUNK_S8 - 1) / sm90::KCHUNK_S8;
  cudaError_t e = cudaFuncSetAttribute(tilemin_quant_bf16_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                    (int)SMEM_B);
  if (e != cudaSuccess) return (int)e;
  tilemin_quant_bf16_sm90<<<(unsigned)blocks, sm90::THREADS, SMEM_B, (cudaStream_t)stream>>>(
    qmap, gmap, (const float*)qs, (const float*)gsq, (const float*)gsc, (float*)out_d, (int32_t*)out_i, B, D,
    n_tiles, tile_g, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [B, D], g [n_tiles * tile_g, D] (D % 8 == 0); out [B, n_tiles].
extern "C" int tilemin_launch(const void* q, const void* g, const void* gsq, void* out_d,
               void* out_i, int B, int n_tiles, int D, int tile_g,
               int bf16_scores, void* stream) {
  if (bf16_scores) return launch_tilemin<true>(q, g, gsq, out_d, out_i, B, n_tiles, D, tile_g, stream);
  return launch_tilemin<false>(q, g, gsq, out_d, out_i, B, n_tiles, D, tile_g, stream);
}

// q int8 (compute_int8) or bf16, g int8 (D % 16 == 0); out as tilemin_launch.
extern "C" int tilemin_quant_launch(const void* q, const void* qs, const void* g,
                  const void* gsq, const void* gsc, void* out_d, void* out_i,
                  int B, int n_tiles, int D, int tile_g, int compute_int8,
                  void* stream) {
  if (compute_int8)
    return launch_quant_sm90(q, qs, g, gsq, gsc, out_d, out_i, B, n_tiles, D, tile_g, stream);
  return launch_quant_bf16_sm90(q, qs, g, gsq, gsc, out_d, out_i, B, n_tiles, D, tile_g, stream);
}
