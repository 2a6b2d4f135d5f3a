// Packed tile-min scans for sm_90a: `tilemin2_packed_launch` replaces
// `_tilemin2_packed_kernel` (ops/distance_kernel.py:393), `tilemin_packed_launch`
// `_tilemin_packed_kernel` (:350). Key = (f32 bits of q_aug . g_aug, a squared
// distance >= 0, so its bits order as int32) & ~(tile_g - 1) | row_in_tile: one
// integer min carries value and row. The epilogue is issue-bound: keep its loop
// shape unless an A/B says so.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_scan.cuh"

namespace {

constexpr int QT = 128;
constexpr int BN = 256;
constexpr int Q_BOX = QT * sm90::LINE_BYTES;
constexpr int G_BOX = BN * sm90::LINE_BYTES;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;

__device__ __forceinline__ void pair_combine(int& m1, int& m2, int b1, int b2) {
  const int lo = min(m1, b1);
  const int hi = max(m1, b1);
  m2 = min(hi, min(m2, b2));
  m1 = lo;
}

// The thread's (m1, m2) of its two rows -> a key (TWO: pair) a query, over a
// row's 4 lanes; then reset.
template <bool TWO>
__device__ __forceinline__ void store_keys(int (&m1)[2], int (&m2)[2], int32_t* __restrict__ out1,
                     int32_t* __restrict__ out2, int q, int t, int B, int n_tiles,
                     int tile) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int b1 = __shfl_xor_sync(0xffffffffu, m1[h], off);
      if (TWO) {
        const int b2 = __shfl_xor_sync(0xffffffffu, m2[h], off);
        pair_combine(m1[h], m2[h], b1, b2);
      } else {
        m1[h] = min(m1[h], b1);
      }
    }
    const int qi = q + sm90::acc_row(t, h);
    if ((t & 3) == 0 && qi < B && tile < n_tiles) {
      out1[(size_t)qi * n_tiles + tile] = m1[h];
      if (TWO) out2[(size_t)qi * n_tiles + tile] = m2[h];
    }
    m1[h] = m2[h] = INT32_MAX;
  }
}

// grid (query tiles, runs of `run` units); 384 threads, warpgroups 0-1 consume,
// 2 produces. A unit: a tile of >= 256 rows, or two of 128. qmap [B, da] boxes
// [128 x 64]; gmap boxes [256 x 64]; out2 with TWO.
template <bool TWO, int TILE_G>
__global__ void __launch_bounds__(sm90::THREADS, 1)
tilemin_packed_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
          int32_t* __restrict__ out1, int32_t* __restrict__ out2, int B, int n_tiles, int n_chunks,
          int run, int stages) {
  constexpr int SUBS = TILE_G > BN ? TILE_G / BN : 1;
  constexpr int TILES = TILE_G > BN ? 1 : BN / TILE_G;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  unsigned char* q_s = smem;                      // [n_chunks][QT x 64], resident
  unsigned char* ring = smem + n_chunks * Q_BOX;  // [stages][BN x 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * G_BOX);
  uint64_t* empty = full + stages;
  uint64_t* q_full = empty + stages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int unit0 = blockIdx.y * run;
  const int unit1 = min((n_tiles + TILES - 1) / TILES, unit0 + run);
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
      for (int unit = unit0; unit < unit1; ++unit)
        for (int sub = 0; sub < SUBS; ++sub)
          for (int c = 0; c < n_chunks; ++c) {
            sm90::mbar_wait(&empty[s], ph ^ 1);
            sm90::mbar_arrive_expect_tx(&full[s], G_BOX);
            sm90::tma_load_2d(ring + s * G_BOX, &gmap, &full[s], c * sm90::KCHUNK,
                     (unit * SUBS + sub) * BN);
            if (++s == stages) { s = 0; ph ^= 1; }
          }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int t = tid % sm90::WG_THREADS;
    const unsigned char* qa = q_s + wg * 64 * sm90::LINE_BYTES;
    float acc[BN / 2];
    int s = 0, prev = 0;
    uint32_t ph = 0;
    sm90::mbar_wait(q_full, 0);
    for (int unit = unit0; unit < unit1; ++unit) {
      int m1[2] = {INT32_MAX, INT32_MAX}, m2[2] = {INT32_MAX, INT32_MAX};
      for (int sub = 0; sub < SUBS; ++sub) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
        for (int c = 0; c < n_chunks; ++c) {
          sm90::mbar_wait(&full[s], ph);
          const unsigned char* gb = ring + s * G_BOX;
          sm90::acc_fence(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < sm90::KCHUNK / 16; ++kk)
            sm90::Wgmma<BN>::mma(acc, sm90::sw128_desc(qa + c * Q_BOX + 32 * kk),
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
        // this sub-tile's keys into (m1, m2) of the thread's two rows;
        // columns 8 j + 2 (t % 4) + c rise with j (TILE_G 128: j >= 16
        // the second tile)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = TILES == 1 ? sub * BN + sm90::acc_col(t, j, c)
                         : sm90::acc_col(t, j, c) - (j < BN / 16 ? 0 : TILE_G);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int key = (__float_as_int(acc[4 * j + 2 * h + c]) & ~(TILE_G - 1)) | row;
              if (TWO) m2[h] = min(m2[h], max(m1[h], key));
              m1[h] = min(m1[h], key);
            }
          }
          if (TILES == 2 && j == BN / 16 - 1)
            store_keys<TWO>(m1, m2, out1, out2, q0 + wg * 64, t, B, n_tiles, 2 * unit);
        }
      }
      store_keys<TWO>(m1, m2, out1, out2, q0 + wg * 64, t, B, n_tiles, unit * TILES + TILES - 1);
    }
  }
}

// The same for da > 640: each of 4 stages holds [QT x 64] query lanes, then [BN
// x 64] gallery lanes; a separate kernel (a switch above ran ~8 % slower).
template <bool TWO, int TILE_G>
__global__ void __launch_bounds__(sm90::THREADS, 1)
tilemin_packed_stream_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
             int32_t* __restrict__ out1, int32_t* __restrict__ out2, int B, int n_tiles,
             int n_chunks, int run, int stages) {
  constexpr int SUBS = TILE_G > BN ? TILE_G / BN : 1;
  constexpr int TILES = TILE_G > BN ? 1 : BN / TILE_G;
  constexpr int STAGE = Q_BOX + G_BOX;  // queries, then rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = sm90::aligned_smem(smem_raw);  // [stages][STAGE]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * STAGE);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int unit0 = blockIdx.y * run;
  const int unit1 = min((n_tiles + TILES - 1) / TILES, unit0 + run);
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / sm90::WG_THREADS;
  if (wg == 2) {
    sm90::setmaxnreg_dec<40>();
    if (tid == 2 * sm90::WG_THREADS) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&gmap);
      int s = 0;
      uint32_t ph = 0;
      for (int unit = unit0; unit < unit1; ++unit)
        for (int sub = 0; sub < SUBS; ++sub)
          for (int c = 0; c < n_chunks; ++c) {
            sm90::mbar_wait(&empty[s], ph ^ 1);
            sm90::mbar_arrive_expect_tx(&full[s], STAGE);
            sm90::tma_load_2d(ring + s * STAGE, &qmap, &full[s], c * sm90::KCHUNK, q0);
            sm90::tma_load_2d(ring + s * STAGE + Q_BOX, &gmap, &full[s], c * sm90::KCHUNK,
                     (unit * SUBS + sub) * BN);
            if (++s == stages) { s = 0; ph ^= 1; }
          }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int t = tid % sm90::WG_THREADS;
    const unsigned char* qa = ring + wg * 64 * sm90::LINE_BYTES;
    float acc[BN / 2];
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int unit = unit0; unit < unit1; ++unit) {
      int m1[2] = {INT32_MAX, INT32_MAX}, m2[2] = {INT32_MAX, INT32_MAX};
      for (int sub = 0; sub < SUBS; ++sub) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
        for (int c = 0; c < n_chunks; ++c) {
          sm90::mbar_wait(&full[s], ph);
          const unsigned char* gb = ring + s * STAGE + Q_BOX;
          const unsigned char* qc = qa + s * STAGE;
          sm90::acc_fence(acc);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < sm90::KCHUNK / 16; ++kk)
            sm90::Wgmma<BN>::mma(acc, sm90::sw128_desc(qc + 32 * kk), sm90::sw128_desc(gb + 32 * kk));
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
        // this sub-tile's keys into (m1, m2), as above
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int row = TILES == 1 ? sub * BN + sm90::acc_col(t, j, c)
                         : sm90::acc_col(t, j, c) - (j < BN / 16 ? 0 : TILE_G);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int key = (__float_as_int(acc[4 * j + 2 * h + c]) & ~(TILE_G - 1)) | row;
              if (TWO) m2[h] = min(m2[h], max(m1[h], key));
              m1[h] = min(m1[h], key);
            }
          }
          if (TILES == 2 && j == BN / 16 - 1)
            store_keys<TWO>(m1, m2, out1, out2, q0 + wg * 64, t, B, n_tiles, 2 * unit);
        }
      }
      store_keys<TWO>(m1, m2, out1, out2, q0 + wg * 64, t, B, n_tiles, unit * TILES + TILES - 1);
    }
  }
}

template <bool TWO, int TILE_G>
int launch(const void* q, const void* g, void* out1, void* out2, int B, int n_tiles, int da, void* stream) {
  constexpr int TILES = TILE_G > BN ? 1 : BN / TILE_G;
  if (B <= 0 || n_tiles <= 0 || da <= 0 || da % 16 != 0 || (long)n_tiles * TILE_G > INT32_MAX - BN)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (da + sm90::KCHUNK - 1) / sm90::KCHUNK;
  // slack, resident queries, ring, (2 stages + 1) barriers
  const int bars = (2 * MAX_STAGES + 1) * 8;
  const int resident_stages = min(MAX_STAGES, (SMEM_LIMIT - sm90::SMEM_ALIGN - n_chunks * Q_BOX - bars) / G_BOX);
  const bool stream_q = resident_stages < 2;
  const int stages = stream_q ? min(MAX_STAGES, (SMEM_LIMIT - sm90::SMEM_ALIGN - bars) / (Q_BOX + G_BOX))
                : resident_stages;
  const size_t smem = stream_q ? sm90::SMEM_ALIGN + bars + (size_t)stages * (Q_BOX + G_BOX)
                : sm90::SMEM_ALIGN + bars + (size_t)n_chunks * Q_BOX + (size_t)stages * G_BOX;
  CUtensorMap qmap, gmap;
  int err = sm90::encode_bf16_map(&qmap, q, da, B, (long)da * 2, QT);
  if (err == 0) err = sm90::encode_bf16_map(&gmap, g, da, (long)n_tiles * TILE_G, (long)da * 2, BN);
  if (err != 0) return err;
  // one block per SM: the query tiles of a run of units side by side
  const int n_units = (n_tiles + TILES - 1) / TILES;
  const int n_qt = (B + QT - 1) / QT;
  const int sms = sm90::sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int n_runs = max(1, min(n_units, sms / n_qt));
  const int run = (n_units + n_runs - 1) / n_runs;
  auto kernel = stream_q ? tilemin_packed_stream_sm90<TWO, TILE_G> : tilemin_packed_sm90<TWO, TILE_G>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_qt, (n_units + run - 1) / run);
  kernel<<<grid, sm90::THREADS, smem, (cudaStream_t)stream>>>(qmap, gmap, (int32_t*)out1, (int32_t*)out2, B,
                                 n_tiles, n_chunks, run, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q [B, da], g [n_tiles * 1024, da] (da % 16 == 0); out1/out2 [B, n_tiles].
extern "C" int tilemin2_packed_launch(const void* q, const void* g, void* out1,
                   void* out2, int B, int n_tiles, int da,
                   void* stream) {
  return launch<true, 1024>(q, g, out1, out2, B, n_tiles, da, stream);
}

// As above, one key a tile; tile_g 128-1024.
extern "C" int tilemin_packed_launch(const void* q, const void* g, void* out,
                  int B, int n_tiles, int da, int tile_g,
                  void* stream) {
  switch (tile_g) {
    case 128: return launch<false, 128>(q, g, out, nullptr, B, n_tiles, da, stream);
    case 256: return launch<false, 256>(q, g, out, nullptr, B, n_tiles, da, stream);
    case 512: return launch<false, 512>(q, g, out, nullptr, B, n_tiles, da, stream);
    case 1024: return launch<false, 1024>(q, g, out, nullptr, B, n_tiles, da, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
