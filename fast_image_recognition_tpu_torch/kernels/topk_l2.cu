// Exact L2 top-k (k <= 256 a launch) for sm_90a, replacing the Pallas
// `_topk_kernel` and `_merge_topk` (ops/distance_kernel.py:92, :57): d =
// max(|q|^2 + |g|^2 - 2 q.g, 0) in fp32, ties to the lowest row. Pass 1 a block
// per (128 queries, row segment), bf16 or the fp32 oracle's split passes (each
// chunk into a fresh accumulator: Hopper truncates as it accumulates); pass 2
// merges the segment lists; pass 3 `topk_rescore`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_scan.cuh"

namespace {

constexpr float BIG_DIST = 3.4e38f;
constexpr int NO_ROW = INT32_MAX;  // empty slot (-1 out)

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

constexpr unsigned FULL = 0xffffffffu;

// An ascending (d, row) list of K = 32 E entries over a warp (lane l: [l E, l E
// + E)), its last entry warp-uniform.
template <int E>
struct WarpList {
  float d[E];
  int i[E];
  float last_d;
  int last_i;

  __device__ __forceinline__ void fill_empty() {
#pragma unroll
    for (int e = 0; e < E; ++e) { d[e] = BIG_DIST; i[e] = NO_ROW; }
    last_d = BIG_DIST;
    last_i = NO_ROW;
  }
  __device__ __forceinline__ void load(const float* ld, const int* li) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < E; ++e) { d[e] = ld[lane * E + e]; i[e] = li[lane * E + e]; }
    last_d = __shfl_sync(FULL, d[E - 1], 31);
    last_i = __shfl_sync(FULL, i[E - 1], 31);
  }
  __device__ __forceinline__ void store(float* ld, int* li) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < E; ++e) { ld[lane * E + e] = d[e]; li[lane * E + e] = i[e]; }
  }
  // Inserts the lanes' candidates where `take`, lowest lane first.
  __device__ __forceinline__ void insert(float cd, int ci, bool take) {
    const int lane = threadIdx.x & 31;
    unsigned m = __ballot_sync(FULL, take && before(cd, ci, last_d, last_i));
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      const float xd = __shfl_sync(FULL, cd, src);
      const int xi = __shfl_sync(FULL, ci, src);
      if (!before(xd, xi, last_d, last_i)) continue;  // warp-uniform
      unsigned lt = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) lt += before(d[e], i[e], xd, xi);
      const int pos = (int)__reduce_add_sync(FULL, lt);
      const float pd = __shfl_up_sync(FULL, d[E - 1], 1);
      const int pi = __shfl_up_sync(FULL, i[E - 1], 1);
#pragma unroll
      for (int e = E - 1; e >= 0; --e) {
        const int p = lane * E + e;
        if (p > pos) {
          if (e > 0) { d[e] = d[e - 1]; i[e] = i[e - 1]; }
          else { d[e] = pd; i[e] = pi; }
        } else if (p == pos) {
          d[e] = xd; i[e] = xi;
        }
      }
      last_d = __shfl_sync(FULL, d[E - 1], 31);
      last_i = __shfl_sync(FULL, i[E - 1], 31);
    }
  }
};

// A warp merges candidates j < n (rows rising) into its list of K at (ld, li)
// (last entry at last_d, last_i).
template <int K, typename Cand>
__device__ __forceinline__ void warp_merge(float* ld, int* li, float* last_d, int* last_i, int n, Cand cand) {
  const int lane = threadIdx.x & 31;
  WarpList<K / 32> list;
  list.last_d = *last_d;
  list.last_i = *last_i;
  bool loaded = false;
  for (int base = 0; base < n; base += 32) {
    const int j = base + lane;
    float cd = BIG_DIST;
    int ci = NO_ROW;
    if (j < n) cand(j, cd, ci);
    const bool take = j < n && before(cd, ci, list.last_d, list.last_i);
    if (!__any_sync(FULL, take)) continue;
    if (!loaded) {
      list.load(ld, li);
      loaded = true;
    }
    list.insert(cd, ci, take);
  }
  if (loaded) {
    list.store(ld, li);
    if (lane == 0) { *last_d = list.last_d; *last_i = list.last_i; }
  }
  __syncwarp();
}

// Fills a list of K and its last entry with empty slots.
template <int K>
__device__ __forceinline__ void warp_fill_empty(float* ld, int* li, float* last_d, int* last_i) {
  for (int e = threadIdx.x & 31; e < K; e += 32) { ld[e] = BIG_DIST; li[e] = NO_ROW; }
  if ((threadIdx.x & 31) == 0) { *last_d = BIG_DIST; *last_i = NO_ROW; }
  __syncwarp();
}

// A slab's floor: only what follows the last slab's (d, row); null admits all.
struct Floor {
  float d;
  int i;
  __device__ __forceinline__ Floor(const float* floor_d, const int* floor_i, int q)
    : d(floor_d != nullptr ? floor_d[q] : -1.0f), i(floor_d != nullptr ? floor_i[q] : 0) {}
  __device__ __forceinline__ void admit(float cd, int ci, float& od, int& oi) const {
    const bool after = before(d, i, cd, ci);
    od = after ? cd : BIG_DIST;
    oi = after ? ci : NO_ROW;
  }
};

// ---- bf16: topk_pass1_sm90 ----

constexpr int QT = 128;
constexpr int SEG_ROWS = 2048;  // gallery rows per block
constexpr int STAGES = 4;       // TMA ring depth

template <int K>
struct Bf16Tile {
  static constexpr int BN = K == 1 ? 256 : 128;
  static constexpr int Q_BYTES = QT * sm90::LINE_BYTES;
  static constexpr int G_BYTES = BN * sm90::LINE_BYTES;
  static constexpr int STAGE_BYTES = Q_BYTES + G_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr size_t SMEM = sm90::SMEM_ALIGN + RING_BYTES + (2 * BN + QT) * 4 + 2 * STAGES * 8;
  static_assert((size_t)QT * 4 * K * 8 <= (size_t)RING_BYTES, "merge lists must fit the ring");
};

// d with the plain version's rounding: (|q|^2 + |g|^2) - 2 q.g, no contraction.
__device__ __forceinline__ float dist(float qsq, float gsq, float cross) {
  return fmaxf(__fsub_rn(__fadd_rn(qsq, gsq), __fmul_rn(2.0f, cross)), 0.0f);
}

// grid (query tiles, segments); 384 threads, warpgroups 0-1 consume, 2
// produces. Maps start at base = start & ~7; lead = start - base lanes are
// outside the window.
template <int K>
__global__ void __launch_bounds__(sm90::THREADS, 1)
topk_pass1_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
        const uint8_t* __restrict__ row_mask, float* __restrict__ part_d, int* __restrict__ part_i,
        int B, int n_valid, int n_seg, int n_chunks, int lead, int seg_base) {
  using T = Bf16Tile<K>;
  constexpr int BN = T::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  float* gsq_s = reinterpret_cast<float*>(smem + T::RING_BYTES);  // [2][BN]
  float* qsq_s = gsq_s + 2 * BN;                                   // [QT]
  uint64_t* full = reinterpret_cast<uint64_t*>(qsq_s + QT);        // [STAGES]
  uint64_t* empty = full + STAGES;                                 // [STAGES]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int seg = seg_base + blockIdx.y;
  const int seg0 = seg * SEG_ROWS;
  const int seg1 = min(n_valid, seg0 + SEG_ROWS);
  if (row_mask != nullptr) {
    const int qi = q0 + tid;
    // a block whose queries are all masked out has nothing to do
    if (!__syncthreads_or(tid < QT && qi < B && row_mask[qi])) return;
  }
  const int n_sub = (seg1 - seg0 + BN - 1) / BN;
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
      for (int sub = 0; sub < n_sub; ++sub) {
        for (int c = 0; c < n_chunks; ++c) {
          sm90::mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = smem + s * T::STAGE_BYTES;
          sm90::mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
          sm90::tma_load_2d(st, &qmap, &full[s], c * sm90::KCHUNK, q0);
          sm90::tma_load_2d(st + T::Q_BYTES, &gmap, &full[s], c * sm90::KCHUNK, seg0 + sub * BN);
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int t = tid % sm90::WG_THREADS;
    const int lane = tid & 31;
    // |g|^2: BN = 256, thread tid sums line tid; BN = 128, half a line
    constexpr int G_CHUNKS = 8 * BN / sm90::CONSUMERS;
    const int g_row = tid * BN / sm90::CONSUMERS;
    const int g_c0 = (tid * G_CHUNKS) % 8;
    // |q|^2: half a line of query row tid / 2 (rows of this warpgroup)
    const int q_row = tid >> 1, q_c0 = (tid & 1) * 4;

    float acc[BN / 2];
    float bd[2][K];
    int bi[2][K];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < K; ++j) { bd[h][j] = BIG_DIST; bi[h][j] = NO_ROW; }
    float qsq[2] = {0.0f, 0.0f};

    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int sub = 0; sub < n_sub; ++sub) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      float gpart = 0.0f, qpart = 0.0f;
      for (int c = 0; c < n_chunks; ++c) {
        sm90::mbar_wait(&full[s], ph);
        unsigned char* st = smem + s * T::STAGE_BYTES;
        const unsigned char* qa = st + wg * 64 * sm90::LINE_BYTES;
        if (c == 0 && lead > 0) {
          // zero this warpgroup's query lanes below the window
          if (t < 64) {
            const int r = wg * 64 + t;
            uint4* v = reinterpret_cast<uint4*>(st + r * sm90::LINE_BYTES + ((r & 7) << 4));
            uint4 x = *v;
            uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (e < lead) w[e >> 1] &= (e & 1) ? 0x0000FFFFu : 0xFFFF0000u;
            *v = make_uint4(w[0], w[1], w[2], w[3]);
          }
          sm90::fence_proxy_async();
          sm90::named_bar_sync(2 + wg, sm90::WG_THREADS);
        }
        sm90::acc_fence(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < sm90::KCHUNK / 16; ++kk)
          sm90::Wgmma<BN>::mma(acc, sm90::sw128_desc(qa + 32 * kk),
                    sm90::sw128_desc(st + T::Q_BYTES + 32 * kk));
        sm90::wgmma_commit();
        // the norms, while the products run
        gpart += sm90::line_sq<G_CHUNKS>(st + T::Q_BYTES, g_row, g_c0, c == 0 ? lead : 0);
        if (sub == 0) qpart += sm90::line_sq<4>(st, q_row, q_c0, 0);
        sm90::wgmma_wait<1>();
        sm90::acc_fence(acc);
        if (c > 0 && t == 0) sm90::mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
      sm90::wgmma_wait<0>();
      sm90::acc_fence(acc);
      if (t == 0) sm90::mbar_arrive(&empty[prev]);

      float* gbuf = gsq_s + (sub & 1) * BN;
      if (G_CHUNKS == 4) gpart += __shfl_xor_sync(0xffffffffu, gpart, 1);
      if (G_CHUNKS == 8 || (tid & 1) == 0) gbuf[g_row] = gpart;
      if (sub == 0) {
        qpart += __shfl_xor_sync(0xffffffffu, qpart, 1);
        if ((tid & 1) == 0) qsq_s[q_row] = qpart;
      }
      sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
      if (sub == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) qsq[h] = qsq_s[wg * 64 + sm90::acc_row(t, h)];
      }
      const int r0 = seg0 + sub * BN;
      const int lim = seg1 - r0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = sm90::acc_col(t, j, c);
          const float g2 = gbuf[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d = dist(qsq[h], g2, acc[4 * j + 2 * h + c]);
            if (K == 1) {
              // columns rise within a thread: strict < keeps the lowest row
              if (col < lim && d < bd[h][0]) { bd[h][0] = d; bi[h][0] = r0 + col; }
            } else if (col < lim) {
              insert<K>(bd[h], bi[h], d, r0 + col);
            }
          }
        }
      }
    }

    // the segment's top-K of each query: merge the 4 lanes of a row
    if constexpr (K == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, bd[h][0], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[h][0], off);
          if (before(od, oi, bd[h][0], bi[h][0])) { bd[h][0] = od; bi[h][0] = oi; }
        }
        const int qi = q0 + wg * 64 + sm90::acc_row(t, h);
        if ((lane & 3) == 0 && qi < B) {
          part_d[(size_t)qi * n_seg + seg] = bd[h][0];
          part_i[(size_t)qi * n_seg + seg] = bi[h][0];
        }
      }
    } else {
      // the ring is idle: every stage has landed and been consumed
      float* ld_s = reinterpret_cast<float*>(smem);  // [QT][4][K]
      int* li_s = reinterpret_cast<int*>(ld_s + QT * 4 * K);
      sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = ((wg * 64 + sm90::acc_row(t, h)) * 4 + (lane & 3)) * K;
#pragma unroll
        for (int j = 0; j < K; ++j) { ld_s[o + j] = bd[h][j]; li_s[o + j] = bi[h][j]; }
      }
      sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
      if (tid < QT) {
        float md[K];
        int mi[K];
#pragma unroll
        for (int j = 0; j < K; ++j) { md[j] = ld_s[tid * 4 * K + j]; mi[j] = li_s[tid * 4 * K + j]; }
        for (int p = 1; p < 4; ++p)
#pragma unroll
          for (int j = 0; j < K; ++j)
            insert<K>(md, mi, ld_s[(tid * 4 + p) * K + j], li_s[(tid * 4 + p) * K + j]);
        const int qi = q0 + tid;
        if (qi < B) {
          const size_t o = ((size_t)qi * n_seg + seg) * K;
#pragma unroll
          for (int j = 0; j < K; ++j) { part_d[o + j] = md[j]; part_i[o + j] = mi[j]; }
        }
      }
    }
  }
}

// ---- bf16, k > 16: topk_pass1_sm90_lists ----

constexpr int SEG_LISTS = 8192;  // gallery rows per block for k > 16

// A separate kernel, so that topk_pass1_sm90 keeps its text: BN = 128, a block
// per (128 queries, 8192 rows); each consumer warp merges its 16 rows'
// distances into their lists of K in the scratch.
struct ListTile {
  static constexpr int BN = 128;
  static constexpr int DLD = BN + 8;
  static constexpr int Q_BYTES = QT * sm90::LINE_BYTES;
  static constexpr int STAGE_BYTES = Q_BYTES + BN * sm90::LINE_BYTES;
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr size_t SMEM =
    sm90::SMEM_ALIGN + RING_BYTES + (2 * BN + QT + QT * DLD + 2 * QT) * 4 + 2 * STAGES * 8;
};

template <int K, bool FLOOR>
__global__ void __launch_bounds__(sm90::THREADS, 1)
topk_pass1_sm90_lists(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
           const uint8_t* __restrict__ row_mask, const float* __restrict__ floor_d,
           const int* __restrict__ floor_i, float* __restrict__ part_d, int* __restrict__ part_i,
           int B, int n_valid, int n_seg, int n_chunks, int lead, int seg_base) {
  using T = ListTile;
  constexpr int BN = T::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  float* gsq_s = reinterpret_cast<float*>(smem + T::RING_BYTES);  // [2][BN]
  float* qsq_s = gsq_s + 2 * BN;                                   // [QT]
  float* d_s = qsq_s + QT;                                         // [QT][DLD]
  float* last_d_s = d_s + QT * T::DLD;                             // [QT]
  int* last_i_s = reinterpret_cast<int*>(last_d_s + QT);           // [QT]
  uint64_t* full = reinterpret_cast<uint64_t*>(last_i_s + QT);     // [STAGES]
  uint64_t* empty = full + STAGES;                                 // [STAGES]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int seg = seg_base + blockIdx.y;
  const int seg0 = seg * SEG_LISTS;
  const int seg1 = min(n_valid, seg0 + SEG_LISTS);
  if (row_mask != nullptr) {
    const int qi = q0 + tid;
    // a block whose queries are all masked out has nothing to do
    if (!__syncthreads_or(tid < QT && qi < B && row_mask[qi])) return;
  }
  const int n_sub = (seg1 - seg0 + BN - 1) / BN;
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
      for (int sub = 0; sub < n_sub; ++sub) {
        for (int c = 0; c < n_chunks; ++c) {
          sm90::mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = smem + s * T::STAGE_BYTES;
          sm90::mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
          sm90::tma_load_2d(st, &qmap, &full[s], c * sm90::KCHUNK, q0);
          sm90::tma_load_2d(st + T::Q_BYTES, &gmap, &full[s], c * sm90::KCHUNK, seg0 + sub * BN);
          if (++s == STAGES) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int t = tid % sm90::WG_THREADS;
    const int lane = tid & 31;
    // |g|^2: half a line of row tid / 2; |q|^2: half a line of query row tid / 2
    constexpr int G_CHUNKS = 8 * BN / sm90::CONSUMERS;
    const int g_row = tid * BN / sm90::CONSUMERS;
    const int g_c0 = (tid * G_CHUNKS) % 8;
    const int q_row = tid >> 1, q_c0 = (tid & 1) * 4;
    // this warp's 16 query rows (its accumulator rows) and their lists
    const int ql0 = (tid >> 5) * 16, ql1 = min(ql0 + 16, B - q0);
    float* dw = d_s + ql0 * T::DLD;
    for (int ql = ql0; ql < ql1; ++ql) {
      const size_t o = ((size_t)(q0 + ql) * n_seg + seg) * K;
      warp_fill_empty<K>(part_d + o, part_i + o, last_d_s + ql, last_i_s + ql);
    }

    float acc[BN / 2];
    float qsq[2] = {0.0f, 0.0f};
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (int sub = 0; sub < n_sub; ++sub) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      float gpart = 0.0f, qpart = 0.0f;
      for (int c = 0; c < n_chunks; ++c) {
        sm90::mbar_wait(&full[s], ph);
        unsigned char* st = smem + s * T::STAGE_BYTES;
        const unsigned char* qa = st + wg * 64 * sm90::LINE_BYTES;
        if (c == 0 && lead > 0) {
          // zero this warpgroup's query lanes below the window
          if (t < 64) {
            const int r = wg * 64 + t;
            uint4* v = reinterpret_cast<uint4*>(st + r * sm90::LINE_BYTES + ((r & 7) << 4));
            uint4 x = *v;
            uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (e < lead) w[e >> 1] &= (e & 1) ? 0x0000FFFFu : 0xFFFF0000u;
            *v = make_uint4(w[0], w[1], w[2], w[3]);
          }
          sm90::fence_proxy_async();
          sm90::named_bar_sync(2 + wg, sm90::WG_THREADS);
        }
        sm90::acc_fence(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < sm90::KCHUNK / 16; ++kk)
          sm90::wgmma_m64n128k16(acc, sm90::sw128_desc(qa + 32 * kk),
                     sm90::sw128_desc(st + T::Q_BYTES + 32 * kk));
        sm90::wgmma_commit();
        // the norms, while the products run
        gpart += sm90::line_sq<G_CHUNKS>(st + T::Q_BYTES, g_row, g_c0, c == 0 ? lead : 0);
        if (sub == 0) qpart += sm90::line_sq<4>(st, q_row, q_c0, 0);
        sm90::wgmma_wait<1>();
        sm90::acc_fence(acc);
        if (c > 0 && t == 0) sm90::mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
      sm90::wgmma_wait<0>();
      sm90::acc_fence(acc);
      if (t == 0) sm90::mbar_arrive(&empty[prev]);

      float* gbuf = gsq_s + (sub & 1) * BN;
      gpart += __shfl_xor_sync(FULL, gpart, 1);
      if ((tid & 1) == 0) gbuf[g_row] = gpart;
      if (sub == 0) {
        qpart += __shfl_xor_sync(FULL, qpart, 1);
        if ((tid & 1) == 0) qsq_s[q_row] = qpart;
      }
      sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
      if (sub == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) qsq[h] = qsq_s[wg * 64 + sm90::acc_row(t, h)];
      }
      const int r0 = seg0 + sub * BN;
      const int lim = min(seg1 - r0, BN);
      // this warp's 16 rows of distances, then its lists
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = sm90::acc_col(t, j, 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 d = make_float2(dist(qsq[h], gbuf[col], acc[4 * j + 2 * h]),
                        dist(qsq[h], gbuf[col + 1], acc[4 * j + 2 * h + 1]));
          *reinterpret_cast<float2*>(dw + (((lane >> 2) + 8 * h) * T::DLD + col)) = d;
        }
      }
      __syncwarp();
      for (int ql = ql0; ql < ql1; ++ql) {
        const size_t o = ((size_t)(q0 + ql) * n_seg + seg) * K;
        const float* dq = d_s + ql * T::DLD;
        if constexpr (FLOOR) {
          const Floor f(floor_d, floor_i, q0 + ql);
          warp_merge<K>(part_d + o, part_i + o, last_d_s + ql, last_i_s + ql, lim,
                 [&](int r, float& cd, int& ci) { f.admit(dq[r], r0 + r, cd, ci); });
        } else {
          warp_merge<K>(part_d + o, part_i + o, last_d_s + ql, last_i_s + ql, lim,
                 [&](int r, float& cd, int& ci) { cd = dq[r]; ci = r0 + r; });
        }
      }
    }
  }
}

constexpr int SEG_PRECISE = 8192;  // gallery rows per block of the split passes

// ---- precise over bf16 rows: split_queries + topk_pass1_split_sm90 ----

// fp32 queries -> bf16 planes hi = bf16(q), mid = bf16(q - hi), lo = bf16(q -
// hi - mid), zero outside [start, end) and past B; |q|^2 to qsq. A warp a row.
__global__ void split_queries(const float* __restrict__ q, __nv_bfloat16* __restrict__ planes,
               float* __restrict__ qsq, int B, int Bp, int D, int start, int end) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= Bp) return;  // the whole warp
  float s = 0.0f;
  for (int col = lane; col < D; col += 32) {
    const float x = row < B && col >= start && col < end ? q[(size_t)row * D + col] : 0.0f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r = x - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r);
    const __nv_bfloat16 lo = __float2bfloat16_rn(r - __bfloat162float(mid));
    planes[(size_t)row * D + col] = hi;
    planes[((size_t)Bp + row) * D + col] = mid;
    planes[((size_t)2 * Bp + row) * D + col] = lo;
    s = fmaf(x, x, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0 && row < B) qsq[row] = s;
}

// A split pass's top-K storage: scratch, floor, (k > 16) the distance tile and
// last entries.
struct SplitOut {
  float* part_d;
  int* part_i;
  const float* floor_d;
  const int* floor_i;
  float* d_s;
  float* last_d_s;
  int* last_i_s;
  int B, q0, seg, n_seg;
};

// A consumer thread's share of a split pass's top-K: its two rows' |q|^2 and
// register lists (k <= 16), or its warp's 16 rows' lists in the scratch.
template <int K>
struct SplitTopK {
  static constexpr int BN = 128;
  static constexpr int DLD = ListTile::DLD;
  static constexpr int KR = K > 16 ? 1 : K;  // register lists (k <= 16)
  float bd[2][KR];
  int bi[2][KR];
  float qsq[2];
  int ql0, ql1;  // k > 16: the queries [ql0, ql1) of the block whose lists this warp owns

  __device__ __forceinline__ SplitTopK(const SplitOut& o, const float* __restrict__ qsq_g, int tid) {
    const int t = tid % sm90::WG_THREADS, wg = tid / sm90::WG_THREADS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = o.q0 + wg * 64 + sm90::acc_row(t, h);
      qsq[h] = qi < o.B ? qsq_g[qi] : 0.0f;
    }
    ql0 = (tid >> 5) * 16;
    ql1 = min(ql0 + 16, o.B - o.q0);
    if constexpr (K > 16) {
      for (int ql = ql0; ql < ql1; ++ql) {
        const size_t off = ((size_t)(o.q0 + ql) * o.n_seg + o.seg) * K;
        warp_fill_empty<K>(o.part_d + off, o.part_i + off, o.last_d_s + ql, o.last_i_s + ql);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < KR; ++j) { bd[h][j] = BIG_DIST; bi[h][j] = NO_ROW; }
  }

  // One sub-tile: products `sum` against rows r0 + column (the first `lim`
  // count), |g|^2 in gbuf.
  __device__ __forceinline__ void take(const SplitOut& o, const float (&sum)[BN / 2], const float* gbuf, int r0,
                    int lim, int tid) {
    const int t = tid % sm90::WG_THREADS, lane = tid & 31;
    if constexpr (K > 16) {
      // this warp's 16 rows of distances, then its lists
      float* dw = o.d_s + ql0 * DLD;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = sm90::acc_col(t, j, 0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 d = make_float2(dist(qsq[h], gbuf[col], sum[4 * j + 2 * h]),
                        dist(qsq[h], gbuf[col + 1], sum[4 * j + 2 * h + 1]));
          *reinterpret_cast<float2*>(dw + (((lane >> 2) + 8 * h) * DLD + col)) = d;
        }
      }
      __syncwarp();
      for (int ql = ql0; ql < ql1; ++ql) {
        const size_t off = ((size_t)(o.q0 + ql) * o.n_seg + o.seg) * K;
        const float* dq = o.d_s + ql * DLD;
        const Floor f(o.floor_d, o.floor_i, o.q0 + ql);
        warp_merge<K>(o.part_d + off, o.part_i + off, o.last_d_s + ql, o.last_i_s + ql, lim,
               [&](int r, float& cd, int& ci) { f.admit(dq[r], r0 + r, cd, ci); });
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = sm90::acc_col(t, j, c);
          const float g2 = gbuf[col];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float d = dist(qsq[h], g2, sum[4 * j + 2 * h + c]);
            if (K == 1) {
              // columns rise within a thread: strict < keeps the lowest row
              if (col < lim && d < bd[h][0]) { bd[h][0] = d; bi[h][0] = r0 + col; }
            } else if (col < lim) {
              insert<KR>(bd[h], bi[h], d, r0 + col);
            }
          }
        }
      }
    }
  }

  // k <= 16, after the segment: each query's top-K, a row's 4 lanes merged
  // (through `smem`, the idle ring).
  __device__ __forceinline__ void emit(const SplitOut& o, unsigned char* smem, int tid) {
    const int t = tid % sm90::WG_THREADS, wg = tid / sm90::WG_THREADS, lane = tid & 31;
    if constexpr (K == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float od = __shfl_xor_sync(FULL, bd[h][0], off);
          const int oi = __shfl_xor_sync(FULL, bi[h][0], off);
          if (before(od, oi, bd[h][0], bi[h][0])) { bd[h][0] = od; bi[h][0] = oi; }
        }
        const int qi = o.q0 + wg * 64 + sm90::acc_row(t, h);
        if ((lane & 3) == 0 && qi < o.B) {
          o.part_d[(size_t)qi * o.n_seg + o.seg] = bd[h][0];
          o.part_i[(size_t)qi * o.n_seg + o.seg] = bi[h][0];
        }
      }
    } else if constexpr (K <= 16) {
      // the ring is idle: every stage has landed and been consumed
      float* ld_s = reinterpret_cast<float*>(smem);  // [QT][4][K]
      int* li_s = reinterpret_cast<int*>(ld_s + QT * 4 * K);
      sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = ((wg * 64 + sm90::acc_row(t, h)) * 4 + (lane & 3)) * K;
#pragma unroll
        for (int j = 0; j < K; ++j) { ld_s[off + j] = bd[h][j]; li_s[off + j] = bi[h][j]; }
      }
      sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
      if (tid < QT) {
        float md[K];
        int mi[K];
#pragma unroll
        for (int j = 0; j < K; ++j) { md[j] = ld_s[tid * 4 * K + j]; mi[j] = li_s[tid * 4 * K + j]; }
        for (int p = 1; p < 4; ++p)
#pragma unroll
          for (int j = 0; j < K; ++j)
            insert<K>(md, mi, ld_s[(tid * 4 + p) * K + j], li_s[(tid * 4 + p) * K + j]);
        const int qi = o.q0 + tid;
        if (qi < o.B) {
          const size_t off = ((size_t)qi * o.n_seg + o.seg) * K;
#pragma unroll
          for (int j = 0; j < K; ++j) { o.part_d[off + j] = md[j]; o.part_i[off + j] = mi[j]; }
        }
      }
    }
  }
};

// The precise pass over bf16 rows as the TPU's HIGHEST dot: three exact bf16
// products a 64-feature chunk (lo, mid, hi) into a fresh accumulator, IEEE adds
// into fp32. BN = 128 (128 queries x 8192 rows a block); a stage: three query
// planes and the gallery box (64 KB), 3 stages (2 for k > 16).
template <int K>
struct SplitTile {
  static constexpr int BN = 128;
  static constexpr int NSTAGE = K > 16 ? 2 : 3;
  static constexpr int Q_BYTES = QT * sm90::LINE_BYTES;  // one plane
  static constexpr int STAGE_BYTES = 3 * Q_BYTES + BN * sm90::LINE_BYTES;
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
  static constexpr int DLD = ListTile::DLD;
  static constexpr size_t SMEM = sm90::SMEM_ALIGN + RING_BYTES + 2 * BN * 4 +
                 (K > 16 ? (QT * DLD + 2 * QT) * 4 : 0) + 2 * NSTAGE * 8;
  static_assert(K > 16 || (size_t)QT * 4 * K * 8 <= (size_t)RING_BYTES, "merge lists must fit the ring");
};

// grid as topk_pass1_sm90; qmap: planes [3 Bp, end - base] boxes [128 x 64];
// gmap: rows, boxes [128 x 64].
template <int K>
__global__ void __launch_bounds__(sm90::THREADS, 1)
topk_pass1_split_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
           const float* __restrict__ qsq_g, const float* __restrict__ floor_d,
           const int* __restrict__ floor_i, float* __restrict__ part_d, int* __restrict__ part_i,
           int B, int Bp, int n_valid, int n_seg, int n_chunks, int lead, int seg_base) {
  using T = SplitTile<K>;
  constexpr int BN = T::BN;
  constexpr int NST = T::NSTAGE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  float* gsq_s = reinterpret_cast<float*>(smem + T::RING_BYTES);  // [2][BN]
  float* d_s = gsq_s + 2 * BN;                                     // k > 16: [QT][DLD]
  float* last_d_s = d_s + (K > 16 ? QT * T::DLD : 0);              // k > 16: [QT]
  int* last_i_s = reinterpret_cast<int*>(last_d_s + (K > 16 ? QT : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(last_i_s + (K > 16 ? QT : 0));  // [NST]
  uint64_t* empty = full + NST;                                                  // [NST]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int seg = seg_base + blockIdx.y;
  const int seg0 = seg * SEG_PRECISE;
  const int seg1 = min(n_valid, seg0 + SEG_PRECISE);
  const int n_sub = (seg1 - seg0 + BN - 1) / BN;
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
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
      for (int sub = 0; sub < n_sub; ++sub) {
        for (int c = 0; c < n_chunks; ++c) {
          sm90::mbar_wait(&empty[s], ph ^ 1);
          unsigned char* st = smem + s * T::STAGE_BYTES;
          sm90::mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            sm90::tma_load_2d(st + p * T::Q_BYTES, &qmap, &full[s], c * sm90::KCHUNK, p * Bp + q0);
          sm90::tma_load_2d(st + 3 * T::Q_BYTES, &gmap, &full[s], c * sm90::KCHUNK, seg0 + sub * BN);
          if (++s == NST) { s = 0; ph ^= 1; }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<232>();
    const int t = tid % sm90::WG_THREADS;
    // |g|^2: half a line of row tid / 2
    const int g_row = tid >> 1, g_c0 = (tid & 1) * 4;
    const SplitOut o{part_d, part_i, floor_d, floor_i, d_s, last_d_s, last_i_s, B, q0, seg, n_seg};
    SplitTopK<K> top(o, qsq_g, tid);

    float acc[BN / 2], sum[BN / 2];
    int s = 0;
    uint32_t ph = 0;
    for (int sub = 0; sub < n_sub; ++sub) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = 0.0f;
      float gpart = 0.0f;
      for (int c = 0; c < n_chunks; ++c) {
        sm90::mbar_wait(&full[s], ph);
        unsigned char* st = smem + s * T::STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
        sm90::acc_fence(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int p = 2; p >= 0; --p)  // lo, mid, hi: the smallest term first
#pragma unroll
          for (int kk = 0; kk < sm90::KCHUNK / 16; ++kk)
            sm90::wgmma_m64n128k16(
              acc, sm90::sw128_desc(st + p * T::Q_BYTES + wg * 64 * sm90::LINE_BYTES + 32 * kk),
              sm90::sw128_desc(st + 3 * T::Q_BYTES + 32 * kk));
        sm90::wgmma_commit();
        // the norms, while the products run
        gpart += sm90::line_sq<4>(st + 3 * T::Q_BYTES, g_row, g_c0, c == 0 ? lead : 0);
        sm90::wgmma_wait<0>();
        sm90::acc_fence(acc);
        if (t == 0) sm90::mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
        if (++s == NST) { s = 0; ph ^= 1; }
      }

      float* gbuf = gsq_s + (sub & 1) * BN;
      gpart += __shfl_xor_sync(FULL, gpart, 1);
      if ((tid & 1) == 0) gbuf[g_row] = gpart;
      sm90::named_bar_sync(sm90::BAR_CONSUMERS, sm90::CONSUMERS);
      const int r0 = seg0 + sub * BN;
      top.take(o, sum, gbuf, r0, min(seg1 - r0, BN), tid);
    }
    top.emit(o, smem, tid);
  }
}

// ---- precise over fp32 rows: split_queries + topk_pass1_split6_sm90 ----

constexpr int KC6 = 32;          // features per chunk: a 64-byte bf16 plane line, a 128-byte fp32 line
constexpr int LINE6 = 64;        // bytes of a plane line (64-byte swizzle)
constexpr int BAR_PRODUCERS = 4;  // named barrier of the producer warpgroup

// acc (+)= query term qt x row term gt (0 hi, 1 mid, 2 lo) over a 32-feature
// chunk; planes 128 lines apart.
__device__ __forceinline__ void product6(float (&acc)[64], const unsigned char* qa, const unsigned char* gb, int qt,
                    int gt, bool fresh) {
#pragma unroll
  for (int kk = 0; kk < KC6 / 16; ++kk)
    sm90::wgmma_m64n128k16(acc, sm90::sw64_desc(qa + qt * 128 * LINE6 + 32 * kk),
               sm90::sw64_desc(gb + gt * 128 * LINE6 + 32 * kk), fresh && kk == 0 ? 0 : 1);
}

// The precise pass over fp32 rows: rows split by split_queries' rule, six exact
// products a 32-feature chunk into one fresh accumulator, smallest first, IEEE
// adds into fp32. Two consumer warpgroups of 64 queries, 128-row sub-tiles;
// producer thread p splits row p of the TMA'd fp32 box (its own ring) into the
// stage's row planes and sums |g|^2. Plane stages 3, boxes 4 (k > 16: 2, 3);
// |g|^2 NSTAGE + 1 buffers.
template <int K>
struct Split6Tile {
  static constexpr int BN = 128;
  static constexpr int NSTAGE = K > 16 ? 2 : 3;  // plane stages
  static constexpr int NBOX = K > 16 ? 3 : 4;    // fp32 boxes
  static constexpr int NGSQ = NSTAGE + 1;        // |g|^2 buffers
  static constexpr int Q_BYTES = QT * LINE6;     // one query plane
  static constexpr int R_BYTES = BN * LINE6;     // one row plane
  static constexpr int STAGE_BYTES = 3 * Q_BYTES + 3 * R_BYTES;
  static constexpr int BOX_BYTES = BN * sm90::LINE_BYTES;  // [BN x 32] fp32
  static constexpr int RING_BYTES = NSTAGE * STAGE_BYTES;
  static constexpr int DLD = ListTile::DLD;
  static constexpr size_t SMEM = sm90::SMEM_ALIGN + RING_BYTES + NBOX * BOX_BYTES + NGSQ * BN * 4 +
                 (K > 16 ? (QT * DLD + 2 * QT) * 4 : 0) + (2 * NSTAGE + NBOX) * 8;
  static_assert(K > 16 || (size_t)QT * 4 * K * 8 <= (size_t)RING_BYTES, "merge lists must fit the ring");
  static_assert(Q_BYTES == 128 * LINE6 && R_BYTES == 128 * LINE6, "product6 and split_row take 128-line planes");
};

// Two fp32 values -> their three bf16 terms, paired as wgmma reads them.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(h), rb = b - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 l = __floats2bfloat162_rn(ra - __low2float(m), rb - __high2float(m));
  hi = reinterpret_cast<const uint32_t&>(h);
  mid = reinterpret_cast<const uint32_t&>(m);
  lo = reinterpret_cast<const uint32_t&>(l);
}

// Splits row p of a landed fp32 box (128-byte swizzle: chunk j at j ^ (p % 8))
// into three bf16 planes R_BYTES apart (64-byte swizzle: chunk c at c ^ ((p /
// 2) % 4)), the first `lead` lanes zero; returns the row's sum of squares.
__device__ __forceinline__ float split_row(const unsigned char* box, unsigned char* planes, int p, int lead) {
  constexpr int R_BYTES = 128 * LINE6;
  const unsigned char* line = box + p * sm90::LINE_BYTES;
  float x[32];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(line + ((j ^ (p & 7)) << 4));
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < lead) x[e] = 0.0f;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // 8 lanes: one 16-byte chunk of each plane's line
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split2(x[8 * c + 2 * e], x[8 * c + 2 * e + 1], hi[e], mid[e], lo[e]);
      s[e] = fmaf(x[8 * c + 2 * e], x[8 * c + 2 * e], s[e]);
      s[e] = fmaf(x[8 * c + 2 * e + 1], x[8 * c + 2 * e + 1], s[e]);
    }
    unsigned char* dst = planes + p * LINE6 + ((c ^ ((p >> 1) & 3)) << 4);
    *reinterpret_cast<uint4*>(dst) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + R_BYTES) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
    *reinterpret_cast<uint4*>(dst + 2 * R_BYTES) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// grid as topk_pass1_sm90; qmap: planes, boxes [128 x 32], 64-byte swizzle;
// gmap: fp32 rows, boxes [128 x 32], 128-byte swizzle.
template <int K>
__global__ void __launch_bounds__(sm90::THREADS, 1)
topk_pass1_split6_sm90(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap gmap,
           const float* __restrict__ qsq_g, const float* __restrict__ floor_d,
           const int* __restrict__ floor_i, float* __restrict__ part_d, int* __restrict__ part_i,
           int B, int Bp, int n_valid, int n_seg, int n_chunks, int lead, int seg_base) {
  using T = Split6Tile<K>;
  constexpr int BN = T::BN;
  constexpr int NST = T::NSTAGE, NBOX = T::NBOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  unsigned char* boxes = smem + T::RING_BYTES;                               // [NBOX][BN][32] fp32
  float* gsq_s = reinterpret_cast<float*>(boxes + NBOX * T::BOX_BYTES);    // [NGSQ][BN]
  float* d_s = gsq_s + T::NGSQ * BN;                                         // k > 16: [QT][DLD]
  float* last_d_s = d_s + (K > 16 ? QT * T::DLD : 0);                        // k > 16: [QT]
  int* last_i_s = reinterpret_cast<int*>(last_d_s + (K > 16 ? QT : 0));
  uint64_t* full = reinterpret_cast<uint64_t*>(last_i_s + (K > 16 ? QT : 0));  // [NST]
  uint64_t* empty = full + NST;                                                  // [NST]
  uint64_t* landed = empty + NST;                                                // [NBOX]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QT;
  const int seg = seg_base + blockIdx.y;
  const int seg0 = seg * SEG_PRECISE;
  const int seg1 = min(n_valid, seg0 + SEG_PRECISE);
  const int n_sub = (seg1 - seg0 + BN - 1) / BN;
  const int total = n_sub * n_chunks;  // chunks of the segment, sub-tile by sub-tile
  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      sm90::mbar_init(&full[s], 1 + sm90::WG_THREADS);
      sm90::mbar_init(&empty[s], 2);
    }
    for (int b = 0; b < NBOX; ++b) sm90::mbar_init(&landed[b], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  const int wg = tid / sm90::WG_THREADS;
  if (wg == 2) {
    // producer: thread 0 loads, thread p splits row p (no setmaxnreg: every
    // warp fits 168 registers).
    const int p = tid - 2 * sm90::WG_THREADS;
    if (p == 0) {
      sm90::prefetch_map(&qmap);
      sm90::prefetch_map(&gmap);
      for (int i = 0; i < min(NBOX, total); ++i) {
        const int sub = i / n_chunks;
        sm90::mbar_arrive_expect_tx(&landed[i], T::BOX_BYTES);
        sm90::tma_load_2d(boxes + i * T::BOX_BYTES, &gmap, &landed[i], (i - sub * n_chunks) * KC6,
                 seg0 + sub * BN);
      }
    }
    float gpart = 0.0f;
    int sub = 0, c = 0;
    for (int i = 0; i < total; ++i) {
      const int s = i % NST, b = i % NBOX;
      unsigned char* st = smem + s * T::STAGE_BYTES;
      sm90::mbar_wait(&empty[s], ((i / NST) & 1) ^ 1);
      if (p == 0) {
        sm90::mbar_arrive_expect_tx(&full[s], 3 * T::Q_BYTES);
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          sm90::tma_load_2d(st + pl * T::Q_BYTES, &qmap, &full[s], c * KC6, pl * Bp + q0);
      }
      sm90::mbar_wait(&landed[b], (i / NBOX) & 1);
      gpart += split_row(boxes + b * T::BOX_BYTES, st + 3 * T::Q_BYTES, p, c == 0 ? lead : 0);
      if (c == n_chunks - 1) {
        gsq_s[(sub % T::NGSQ) * BN + p] = gpart;
        gpart = 0.0f;
      }
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[s]);
      sm90::named_bar_sync(BAR_PRODUCERS, sm90::WG_THREADS);
      if (p == 0 && i + NBOX < total) {
        const int j = i + NBOX, sj = j / n_chunks;
        sm90::mbar_arrive_expect_tx(&landed[b], T::BOX_BYTES);
        sm90::tma_load_2d(boxes + b * T::BOX_BYTES, &gmap, &landed[b], (j - sj * n_chunks) * KC6,
                 seg0 + sj * BN);
      }
      if (++c == n_chunks) { c = 0; ++sub; }
    }
  } else {
    const int t = tid % sm90::WG_THREADS;
    const SplitOut o{part_d, part_i, floor_d, floor_i, d_s, last_d_s, last_i_s, B, q0, seg, n_seg};
    SplitTopK<K> top(o, qsq_g, tid);

    float acc[BN / 2], sum[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    int s = 0;
    uint32_t ph = 0;
    for (int sub = 0; sub < n_sub; ++sub) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] = 0.0f;
      for (int c = 0; c < n_chunks; ++c) {
        sm90::mbar_wait(&full[s], ph);
        const unsigned char* qa = smem + s * T::STAGE_BYTES + wg * 64 * LINE6;
        const unsigned char* gb = smem + s * T::STAGE_BYTES + 3 * T::Q_BYTES;
        sm90::acc_fence(acc);
        sm90::wgmma_fence();
        // smallest first: ~2^-16 of hi.hi, then ~2^-8, then hi.hi
        product6(acc, qa, gb, 0, 2, true);  // hi.lo, into a fresh accumulator
        product6(acc, qa, gb, 2, 0, false);  // lo.hi
        product6(acc, qa, gb, 1, 1, false);  // mid.mid
        product6(acc, qa, gb, 0, 1, false);  // hi.mid
        product6(acc, qa, gb, 1, 0, false);  // mid.hi
        product6(acc, qa, gb, 0, 0, false);  // hi.hi
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::acc_fence(acc);
        if (t == 0) sm90::mbar_arrive(&empty[s]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
        if (++s == NST) { s = 0; ph ^= 1; }
      }
      // the producer wrote |g|^2 of this sub-tile before its last full[] arrive
      const int r0 = seg0 + sub * BN;
      top.take(o, sum, gsq_s + (sub % T::NGSQ) * BN, r0, min(seg1 - r0, BN), tid);
    }
    top.emit(o, smem, tid);
  }
}

// A warp a query merges its n_seg lists: each lane every 32nd list, then a
// shuffle butterfly.
template <int K>
__global__ void topk_pass2(const float* __restrict__ part_d, const int* __restrict__ part_i,
             const uint8_t* __restrict__ row_mask, float* __restrict__ out_d,
             int32_t* __restrict__ out_i, int B, int n_seg, int k) {
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= B) return;  // the whole warp
  float bd[K];
  int bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) { bd[j] = BIG_DIST; bi[j] = NO_ROW; }
  if (row_mask == nullptr || row_mask[qi]) {
    const size_t base = (size_t)qi * n_seg * K;
    for (int s = lane; s < n_seg; s += 32)
#pragma unroll
      for (int j = 0; j < K; ++j)
        insert<K>(bd, bi, part_d[base + (size_t)s * K + j], part_i[base + (size_t)s * K + j]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      od[j] = __shfl_xor_sync(0xffffffffu, bd[j], off);
      oi[j] = __shfl_xor_sync(0xffffffffu, bi[j], off);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) insert<K>(bd, bi, od[j], oi[j]);
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        out_d[(size_t)qi * k + j] = bd[j];
        out_i[(size_t)qi * k + j] = bi[j] == NO_ROW ? -1 : bi[j];
      }
    }
  }
}

// k > 16: a warp a query merges its n_seg lists of K into one over its lanes.
template <int K>
__global__ void topk_pass2_lists(const float* __restrict__ part_d, const int* __restrict__ part_i,
                const uint8_t* __restrict__ row_mask, float* __restrict__ out_d,
                int32_t* __restrict__ out_i, int B, int n_seg, int k) {
  constexpr int E = K / 32;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (qi >= B) return;  // the whole warp
  WarpList<E> list;
  list.fill_empty();
  if (row_mask == nullptr || row_mask[qi]) {
    for (int s = 0; s < n_seg; ++s) {
      const size_t o = ((size_t)qi * n_seg + s) * K;
      for (int base = 0; base < K; base += 32) {
        const float cd = part_d[o + base + lane];
        const int ci = part_i[o + base + lane];
        const bool take = before(cd, ci, list.last_d, list.last_i);
        // the segment's list rises: once no lane beats the last entry, none after will
        if (!__any_sync(FULL, take)) break;
        list.insert(cd, ci, take);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int p = lane * E + e;
    if (p < k) {
      out_d[(size_t)qi * k + p] = list.d[e];
      out_i[(size_t)qi * k + p] = list.i[e] == NO_ROW ? -1 : list.i[e];
    }
  }
}

// Pass 3, after all slabs: each pick's d again as the fp32 sum of (q - g)^2
// over the window (the expansion cancels where q and its row nearly coincide),
// each list sorted again, empty slots last. A block a query.
__device__ __forceinline__ float as_f32(float x) { return x; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TQ, typename TG>
__global__ void topk_rescore(const TQ* __restrict__ q, const TG* __restrict__ g, float* __restrict__ d,
              int32_t* __restrict__ idx, int k, int D, int start, int end) {
  const int lane = threadIdx.x & 31;
  const TQ* qr = q + (size_t)blockIdx.x * D;
  float* dl = d + (size_t)blockIdx.x * k;
  int32_t* il = idx + (size_t)blockIdx.x * k;
  for (int j = threadIdx.x >> 5; j < k; j += blockDim.x >> 5) {
    const int r = il[j];
    if (r < 0) continue;  // the whole warp
    float s = 0.0f;
    for (int c = start + lane; c < end; c += 32) {
      const float t = as_f32(qr[c]) - as_f32(g[(size_t)r * D + c]);
      s = fmaf(t, t, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) dl[j] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int j = 1; j < k && il[j] >= 0; ++j) {  // insertion sort: off only at near-ties
    const float dj = dl[j];
    const int ij = il[j];
    int p = j;
    for (; p > 0 && before(dj, ij, dl[p - 1], il[p - 1]); --p) {
      dl[p] = dl[p - 1];
      il[p] = il[p - 1];
    }
    dl[p] = dj;
    il[p] = ij;
  }
}

template <typename TQ, typename TG>
int launch_rescore(const void* q, const void* g, void* d, void* idx, int B, int k, int D, int start, int end,
         cudaStream_t s) {
  topk_rescore<TQ, TG><<<B, 128, 0, s>>>((const TQ*)q, (const TG*)g, (float*)d, (int32_t*)idx, k, D, start, end);
  return (int)cudaGetLastError();
}

struct Args {
  const void* q;
  const void* g;
  const uint8_t* row_mask;
  const float* floor_d;  // the slab floor (k > 16 only) or null
  const int* floor_i;
  void* planes;  // precise: [3][Bp][D] bf16 query planes
  float* qsq;    // and [B] fp32 |q|^2
  void *part_d, *part_i, *out_d, *out_i;
  int B, N, n_valid, D, k, n_seg, start, end;
};

constexpr int PASS2_WARPS = 8;

constexpr int MAX_GRID_Y = 65535;  // segments per pass-1 launch

template <int K>
int launch_pass2(const Args& a, cudaStream_t stream) {
  const int blocks = (a.B + PASS2_WARPS - 1) / PASS2_WARPS;
  if constexpr (K > 16)
    topk_pass2_lists<K><<<blocks, 32 * PASS2_WARPS, 0, stream>>>(
      (const float*)a.part_d, (const int*)a.part_i, a.row_mask, (float*)a.out_d, (int32_t*)a.out_i, a.B,
      a.n_seg, a.k);
  else
    topk_pass2<K><<<blocks, 32 * PASS2_WARPS, 0, stream>>>(
      (const float*)a.part_d, (const int*)a.part_i, a.row_mask, (float*)a.out_d, (int32_t*)a.out_i, a.B,
      a.n_seg, a.k);
  return (int)cudaGetLastError();
}

// Pass 1 a grid row a (128 queries, segment), at most MAX_GRID_Y segments a launch from `seg_base`, then pass 2.
template <int K, typename... P, typename... A>
int launch_pass1(void (*kernel)(P...), size_t smem, const Args& a, cudaStream_t stream, A... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  for (int sb = 0; e == cudaSuccess && sb < a.n_seg; sb += MAX_GRID_Y) {
    kernel<<<dim3((a.B + QT - 1) / QT, min(MAX_GRID_Y, a.n_seg - sb)), sm90::THREADS, smem, stream>>>(args..., sb);
    e = cudaGetLastError();
  }
  return e != cudaSuccess ? (int)e : launch_pass2<K>(a, stream);
}

template <int K>
constexpr int bf16_bn() {
  if constexpr (K > 16) return ListTile::BN;
  else return Bf16Tile<K>::BN;
}

// bf16 (k > 16: topk_pass1_sm90_lists). Both maps start at the 8-lane (16-byte) boundary below the window.
template <int K, bool FLOOR>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int BN = bf16_bn<K>();
  const int base = a.start & ~7;
  const long cols = a.end - base;
  CUtensorMap qmap, gmap;
  int err = sm90::encode_bf16_map(&qmap, (const __nv_bfloat16*)a.q + base, cols, a.B, (long)a.D * 2, QT);
  if (err == 0) err = sm90::encode_bf16_map(&gmap, (const __nv_bfloat16*)a.g + base, cols, a.n_valid, (long)a.D * 2,
                       BN);
  if (err != 0) return err;
  const int n_chunks = (int)((cols + sm90::KCHUNK - 1) / sm90::KCHUNK);
  if constexpr (K > 16)
    return launch_pass1<K>(topk_pass1_sm90_lists<K, FLOOR>, ListTile::SMEM, a, stream, qmap, gmap, a.row_mask,
               a.floor_d, a.floor_i, (float*)a.part_d, (int*)a.part_i, a.B, a.n_valid, a.n_seg,
               n_chunks, a.start - base);
  else
    return launch_pass1<K>(topk_pass1_sm90<K>, Bf16Tile<K>::SMEM, a, stream, qmap, gmap, a.row_mask,
               (float*)a.part_d, (int*)a.part_i, a.B, a.n_valid, a.n_seg, n_chunks, a.start - base);
}

// precise: the query planes (rows Bp a plane) and |q|^2.
int launch_split_queries(const Args& a, int Bp, cudaStream_t stream) {
  split_queries<<<(Bp + 7) / 8, 256, 0, stream>>>((const float*)a.q, (__nv_bfloat16*)a.planes, a.qsq, a.B, Bp,
                          a.D, a.start, a.end);
  return (int)cudaGetLastError();
}

// precise: split, topk_pass1_split_sm90 over bf16 rows or (SIX) topk_pass1_split6_sm90 over fp32 rows, merge.
template <int K, bool SIX>
int launch_split(const Args& a, cudaStream_t stream) {
  const int Bp = (a.B + QT - 1) / QT * QT;
  int err = launch_split_queries(a, Bp, stream);
  if (err != 0) return err;
  const int base = a.start & ~7;  // both maps at the 8-lane boundary below the window
  const long cols = a.end - base;
  const __nv_bfloat16* planes = (const __nv_bfloat16*)a.planes + base;
  CUtensorMap qmap, gmap;
  if constexpr (SIX) {
    err = sm90::encode_bf16_sw64_map(&qmap, planes, cols, 3L * Bp, (long)a.D * 2, QT);
    if (err == 0) err = sm90::encode_f32_map(&gmap, (const float*)a.g + base, cols, a.n_valid, (long)a.D * 4,
                        Split6Tile<K>::BN);
  } else {
    err = sm90::encode_bf16_map(&qmap, planes, cols, 3L * Bp, (long)a.D * 2, QT);
    if (err == 0) err = sm90::encode_bf16_map(&gmap, (const __nv_bfloat16*)a.g + base, cols, a.n_valid,
                         (long)a.D * 2, SplitTile<K>::BN);
  }
  if (err != 0) return err;
  const int kc = SIX ? KC6 : sm90::KCHUNK;
  return launch_pass1<K>(SIX ? topk_pass1_split6_sm90<K> : topk_pass1_split_sm90<K>,
             SIX ? Split6Tile<K>::SMEM : SplitTile<K>::SMEM, a, stream, qmap, gmap, a.qsq, a.floor_d,
             a.floor_i, (float*)a.part_d, (int*)a.part_i, a.B, Bp, a.n_valid, a.n_seg,
             (int)((cols + kc - 1) / kc), a.start - base);
}

// The pass-1 kernels: bf16; precise over bf16 rows; precise over fp32 rows.
enum class Pass { BF16, SPLIT3, SPLIT6 };

template <int K, Pass P>
int launch(const Args& a, cudaStream_t stream) {
  if constexpr (P != Pass::BF16)
    return launch_split<K, P == Pass::SPLIT6>(a, stream);
  else
    return K > 16 && a.floor_d != nullptr ? launch_bf16<K, (K > 16)>(a, stream) : launch_bf16<K, false>(a, stream);
}

constexpr int MAX_K = 256;
int list_len(int k) {
  int n = 1;
  while (n < k) n *= 2;
  return n;
}
int segment_rows(bool precise, int k) { return precise ? SEG_PRECISE : k > 16 ? SEG_LISTS : SEG_ROWS; }

template <Pass P>
int dispatch(const Args& a, void* stream) {
  constexpr bool PRECISE = P != Pass::BF16;
  const int seg = segment_rows(PRECISE, a.k);
  if (a.B <= 0 || a.N <= 0 || a.n_valid <= 0 || a.n_valid > a.N || a.n_valid > INT32_MAX - seg || a.D <= 0 ||
    a.D % 8 != 0 || a.k < 1 || a.k > MAX_K || a.n_seg != (a.n_valid + seg - 1) / seg || a.start < 0 ||
    a.start >= a.end || a.end > a.D || (a.floor_d != nullptr && (a.k <= 16 || a.floor_i == nullptr)) ||
    (PRECISE && (a.planes == nullptr || a.qsq == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (list_len(a.k)) {
    case 1: return launch<1, P>(a, s);
    case 2: return launch<2, P>(a, s);
    case 4: return launch<4, P>(a, s);
    case 8: return launch<8, P>(a, s);
    case 16: return launch<16, P>(a, s);
    case 32: return launch<32, P>(a, s);
    case 64: return launch<64, P>(a, s);
    case 128: return launch<128, P>(a, s);
    default: return launch<256, P>(a, s);
  }
}

}  // namespace

// Gallery rows a pass-1 block for this mode and k.
extern "C" int topk_l2_segment_rows(int precise, int k) { return segment_rows(precise != 0, k); }

// Queries a bf16 pass-1 block (a row mask skips blocks).
extern "C" int topk_l2_query_rows() { return QT; }

// Scratch K (the power of two >= k) a (query, segment).
extern "C" int topk_l2_list_len(int k) { return list_len(k); }

// The largest k a launch takes (more runs in slabs).
extern "C" int topk_l2_max_k() { return MAX_K; }

// Dynamic shared memory of the split precise pass over bf16 rows at this k.
extern "C" int topk_l2_split_smem(int k) {
  switch (list_len(k)) {
    case 1: return (int)SplitTile<1>::SMEM;
    case 2: return (int)SplitTile<2>::SMEM;
    case 4: return (int)SplitTile<4>::SMEM;
    case 8: return (int)SplitTile<8>::SMEM;
    case 16: return (int)SplitTile<16>::SMEM;
    default: return (int)SplitTile<32>::SMEM;
  }
}

// Shared memory of the six-product pass at this k.
extern "C" int topk_l2_split6_smem(int k) {
  switch (list_len(k)) {
    case 1: return (int)Split6Tile<1>::SMEM;
    case 2: return (int)Split6Tile<2>::SMEM;
    case 4: return (int)Split6Tile<4>::SMEM;
    case 8: return (int)Split6Tile<8>::SMEM;
    case 16: return (int)Split6Tile<16>::SMEM;
    default: return (int)Split6Tile<32>::SMEM;
  }
}

// q, g: [B, D], [N, D] bf16 (D % 8 == 0); row_mask [B] uint8 or null (0:
// empty); floor_d/floor_i [B] or null (k > 16: only (d, row) after them);
// part_d/part_i [B, n_seg, topk_l2_list_len(k)] scratch; out [B, k]. Returns a
// cudaError_t.
extern "C" int topk_l2_launch(const void* q, const void* g, const void* row_mask, const void* floor_d,
               const void* floor_i, void* part_d, void* part_i, void* out_d, void* out_i, int B,
               int N, int n_valid, int D, int k, int n_seg, int start, int end, void* stream) {
  const Args a{q, g, (const uint8_t*)row_mask, (const float*)floor_d, (const int*)floor_i, nullptr, nullptr,
        part_d, part_i, out_d, out_i, B, N, n_valid, D, k, n_seg, start, end};
  return dispatch<Pass::BF16>(a, stream);
}

// precise: q [B, D] fp32, g fp32 (g_f32) or bf16, planes [3, round_up(B,
// topk_l2_query_rows()), D] bf16 and qsq [B] scratch; the rest as
// topk_l2_launch, no mask.
extern "C" int topk_l2_precise_launch(const void* q, const void* g, int g_f32, void* planes, void* qsq,
                   const void* floor_d, const void* floor_i, void* part_d, void* part_i,
                   void* out_d, void* out_i, int B, int N, int n_valid, int D, int k, int n_seg,
                   int start, int end, void* stream) {
  const Args a{q, g, nullptr, (const float*)floor_d, (const int*)floor_i, planes, (float*)qsq,
        part_d, part_i, out_d, out_i, B, N, n_valid, D, k, n_seg, start, end};
  return g_f32 ? dispatch<Pass::SPLIT6>(a, stream) : dispatch<Pass::SPLIT3>(a, stream);
}

// Pass 3 in place on out_d/out_i [B, k]: q bf16 or fp32 (q_f32), g bf16 or fp32
// (g_f32, fp32 queries only).
extern "C" int topk_l2_rescore_launch(const void* q, const void* g, int q_f32, int g_f32, void* d, void* idx, int B,
                   int k, int D, int start, int end, void* stream) {
  if (B <= 0 || k < 1 || D <= 0 || start < 0 || start >= end || end > D || (!q_f32 && g_f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!q_f32) return launch_rescore<__nv_bfloat16, __nv_bfloat16>(q, g, d, idx, B, k, D, start, end, s);
  if (!g_f32) return launch_rescore<float, __nv_bfloat16>(q, g, d, idx, B, k, D, start, end, s);
  return launch_rescore<float, float>(q, g, d, idx, B, k, D, start, end, s);
}
