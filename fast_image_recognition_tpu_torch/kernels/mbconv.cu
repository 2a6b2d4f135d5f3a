// Fused stride-1 MBConv block for sm_90a, replacing the Pallas `_mbconv_kernel`
// (ops/mbconv_kernel.py:82): expand, depthwise, SE, project (+ residual), NHWC
// bf16, one launch of 512 threads a block an image (two at 7x7). With SE, pass
// 0 writes the depthwise output to a bf16 scratch and pools it; pass 1 loads it
// by TMA as the project's `wgmma` A tile and gates it. Rounding: the TPU
// kernel's, plus the depthwise output to bf16 before the gate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_scan.cuh"

namespace {

constexpr int THREADS = 512;  // four consumer warpgroups; warp 0 copies
constexpr int WGS = THREADS / 128;
constexpr int WARPS = THREADS / 32;
constexpr int CS = 64;
constexpr int LINE = 128;
constexpr int NT_MAX = 3;
constexpr int PX = 4;         // output pixels of a row per depthwise item
constexpr int MAX_SMEM = 232448;

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of a block (`plane_smem` mirrors it).
struct Layout {
  int hh, hw, halo, xrows, rx, ro, cin_ch, nslab, npt, n_tiles, tiles_w, xbufs, wbufs, aux, cep, s32;
  bool xplane;
  int off_x, off_wexp, off_wproj, off_aux, off_hid, off_dws, off_pool, off_s1, off_bproj, off_bar, total;
};

// The plan as `ops/mbconv_kernel.py::plane_smem` names it; with expand and one
// tile the box is the bare plane (`xplane`): the halo's zero border written once.
__host__ __device__ inline Layout layout(int H, int W, int k, int cin, int ce, int cout, int S, int has_expand,
                    int th, int tw, int group, int bufs, int ipb) {
  Layout L;
  L.hh = th + k - 1;
  L.hw = tw + k - 1;
  L.halo = L.hh * L.hw;
  L.tiles_w = (W + tw - 1) / tw;
  L.n_tiles = (H + th - 1) / th * L.tiles_w;
  L.xplane = has_expand && L.n_tiles == 1;
  L.xrows = ipb * (L.xplane ? H * W : L.halo);
  L.rx = round_up(L.xrows, 64);  // whole 64-row expand tiles
  L.ro = round_up(ipb * th * tw, 64);  // output rows: whole 64-row project tiles
  L.cin_ch = (cin + CS - 1) / CS;
  L.nslab = (ce + CS - 1) / CS;
  L.npt = (cout + CS - 1) / CS;
  if (group < L.npt) L.npt = group;
  L.xbufs = L.n_tiles > 1 && (bufs & 1) ? 2 : 1;  // a whole plane stays resident across the passes
  L.wbufs = bufs & 2 ? 2 : 1;
  L.aux = round_up((k * k + 2) * CS * 4, 1024);  // a slab's w_dw rows, b_dw and b_exp (fp32)
  L.cep = round_up(ce, CS);
  L.s32 = round_up(S, 32);
  int o = 0;
  L.off_x = o;  o += L.xbufs * L.cin_ch * L.rx * LINE;
  const int wexp = has_expand ? L.wbufs * L.cin_ch * 64 * LINE : 0, wproj = L.wbufs * L.npt * 64 * LINE;
  L.off_wexp = o;
  if (S > 0) {
    L.off_wproj = o;  o += wexp > wproj ? wexp : wproj;
  } else {
    o += wexp;
    L.off_wproj = o;  o += wproj;
  }
  L.off_aux = o;  o += L.wbufs * L.aux;
  L.off_hid = o;  o += has_expand ? round_up(ipb * L.halo * LINE, 1024) : 0;
  // the project's A tile; before the project (pass 0 and the SE) the depthwise sums
  L.off_dws = o;  o += L.ro * LINE > WARPS * ipb * CS * 4 ? L.ro * LINE : WARPS * ipb * CS * 4;
  L.off_pool = o;  o += ipb * L.cep * 4;  // the pool, then the gate, of each image
  L.off_s1 = o;  o += ipb * L.s32 * 4;
  L.off_bproj = o;  o += round_up(cout, CS) * 4;
  L.off_bar = o;  o += 4 * 8;
  L.total = o + sm90::SMEM_ALIGN;
  return L;
}

__host__ __device__ inline bool refused(const Layout& L) {
  return L.total > MAX_SMEM || (L.ro / 64 * L.npt + WGS - 1) / WGS > NT_MAX;
}

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

// swish by the fast exp and division (inside the bf16 rounding), or relu6.
__device__ __forceinline__ float act(float v, int relu6) {
  return relu6 ? fminf(fmaxf(v, 0.0f), 6.0f) : __fdividef(v, 1.0f + __expf(-v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// One 4-D TMA box of an NHWC tensor at (channel c0, column c1, row c2, image c3).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                      int c3) {
  asm volatile(
    "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
    " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(sm90::smem_u32(dst)),
    "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
    : "memory");
}

// A copy of `bytes` (% 16) global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          sm90::smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
    SM90_R32
    "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
    : SM90_D32("+f", 0)
    : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
    SM90_R16
    "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
    : SM90_D8("+f", 0), SM90_D8("+f", 8)
    : "l"(da), "l"(db), "r"(1));
}

struct Params {
  const __nv_bfloat16* x;  // [B, H, W, cin]
  __nv_bfloat16* dwg;      // [B, H, W, ce]: the depthwise output between the passes (with SE)
  const float* aux;        // [nslab][k*k + 2][64]: per slab the w_dw rows, b_dw, b_exp
  const float* w_se1;      // [ce, S] or null (no SE)
  const float* b_se1;      // [S]
  const float* w_se2;      // [S, ce]
  const float* b_se2;      // [ce]
  const float* b_proj;     // [cout]
  __nv_bfloat16* out;      // [B, H, W, cout]
  int B, H, W, cin, ce, cout, S, pad_h, pad_w, th, tw, group, bufs, ipb, has_expand, residual, relu6;
};

// grid (ceil(B / IPB), groups); 512 threads. xmap: x [B, H, W, cin], boxes
// [IPB, hh, hw, 64] or the bare plane, 128-byte swizzle with expand, none
// without; emap: w_exp^T [ce, cin], pmap: w_proj^T [cout, ce], boxes [64 x 64];
// amap (SE): the depthwise output, boxes [IPB, th, tw, 64], 128-byte swizzle.
template <int K, int IPB>
__global__ void __launch_bounds__(THREADS, 1)
mbconv_sm90(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap emap,
      const __grid_constant__ CUtensorMap pmap, const __grid_constant__ CUtensorMap amap, const Params p) {
  const Layout L = layout(p.H, p.W, K, p.cin, p.ce, p.cout, p.S, p.has_expand, p.th, p.tw, p.group, p.bufs, IPB);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  unsigned char* xs = smem + L.off_x;
  unsigned char* wexp = smem + L.off_wexp;
  unsigned char* wproj = smem + L.off_wproj;
  unsigned char* dws = smem + L.off_dws;
  float* pool_s = reinterpret_cast<float*>(smem + L.off_pool);  // [IPB][cep]: the pool, then the gate
  float* s1_s = reinterpret_cast<float*>(smem + L.off_s1);      // [IPB][s32]
  float* bproj_s = reinterpret_cast<float*>(smem + L.off_bproj);
  float* red_s = reinterpret_cast<float*>(dws);  // [WARPS][IPB][64], while dws holds no A tile
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + L.off_bar);  // [2]
  uint64_t* xbar = wbar + 2;                                       // [2]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int t = tid & 127;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b0 = blockIdx.x * IPB;
  const int o0 = blockIdx.y * p.group * 64;
  const int npt = min(L.npt, (p.cout - o0 + 63) / 64);
  const bool has_se = p.w_se1 != nullptr;
  const int P0 = has_se ? L.n_tiles * L.nslab : 0;
  const int n_steps = P0 + L.n_tiles * L.nslab;
  const int xb_rows = L.xplane ? p.H * p.W : L.halo;
  const int x_buf = L.cin_ch * L.rx * LINE;
  const int wexp_buf = L.cin_ch * 64 * LINE;
  const int wproj_buf = L.npt * 64 * LINE;
  const int aux_bytes = (K * K + 2) * CS * 4;
  const bool x_per_tile = L.n_tiles > 1;  // the input box is loaded per tile, else once
  const int th = p.th, tw = p.tw;
  const int tpix = th * tw;
  const int n_proj = (L.ro / 64) * npt;

  // step n: pass n < P0 ? 0 : 1, tile tile_of(n), slab n % nslab; the input
  // box serves the expand/depthwise steps
  auto tile_of = [&](int n) { return (n < P0 ? n : n - P0) / L.nslab; };
  auto runs_dw = [&](int n) { return !has_se || n < P0; };
  auto abuf = [&](int n) { return (n - P0) & 1 ? xs : dws; };  // pass 1 with SE: the A tiles
  // a step's copies: SE pass 1 the A tile and w_proj^T; else w_exp^T
  // (expand), w_proj^T (no SE) and aux
  auto w_bytes = [&](int n) {
    if (!runs_dw(n)) return npt * 64 * LINE + IPB * tpix * LINE;
    return (p.has_expand ? wexp_buf : 0) + (has_se ? 0 : npt * 64 * LINE) + aux_bytes;
  };
  // issued by warp 0, a copy a lane; lane 0 sets the expected bytes first
  auto issue_weights = [&](int n) {
    const int s = n % L.nslab, buf = n % L.wbufs, tile = tile_of(n);
    if (lane == 0) sm90::mbar_arrive_expect_tx(&wbar[buf], w_bytes(n));
    __syncwarp();
    if (!runs_dw(n)) {
      for (int e = lane; e <= npt; e += 32) {
        if (e < npt)
          sm90::tma_load_2d(wproj + buf * wproj_buf + e * 64 * LINE, &pmap, &wbar[buf], s * CS, o0 + e * 64);
        else
          tma_load_4d(abuf(n), &amap, &wbar[buf], s * CS, tile % L.tiles_w * tw, tile / L.tiles_w * th, b0);
      }
      return;
    }
    const int n_exp = p.has_expand ? L.cin_ch : 0, n_pb = has_se ? 0 : npt;
    for (int e = lane; e <= n_exp + n_pb; e += 32) {
      if (e < n_exp)
        sm90::tma_load_2d(wexp + buf * wexp_buf + e * 64 * LINE, &emap, &wbar[buf], e * CS, s * CS);
      else if (e < n_exp + n_pb)
        sm90::tma_load_2d(wproj + buf * wproj_buf + (e - n_exp) * 64 * LINE, &pmap, &wbar[buf], s * CS,
                 o0 + (e - n_exp) * 64);
      else
        bulk_load(smem + L.off_aux + buf * L.aux, p.aux + (size_t)s * (K * K + 2) * CS, aux_bytes, &wbar[buf]);
    }
  };
  auto issue_x = [&](int tile) {
    const int buf = tile % L.xbufs;
    const int c1 = L.xplane ? 0 : tile % L.tiles_w * tw - p.pad_w;
    const int c2 = L.xplane ? 0 : tile / L.tiles_w * th - p.pad_h;
    if (lane == 0) sm90::mbar_arrive_expect_tx(&xbar[buf], L.cin_ch * IPB * xb_rows * LINE);
    __syncwarp();
    for (int c = lane; c < L.cin_ch; c += 32)
      tma_load_4d(xs + buf * x_buf + c * L.rx * LINE, &xmap, &xbar[buf], c * CS, c1, c2, b0);
  };

  for (int c = tid; c < IPB * L.cep; c += THREADS) pool_s[c] = 0.0f;
  for (int c = tid; c < p.cout; c += THREADS) bproj_s[c] = p.b_proj[c];
  if (L.xplane) {
    uint4* h = reinterpret_cast<uint4*>(smem + L.off_hid);
    for (int i = tid; i < IPB * L.halo * LINE / 16; i += THREADS) h[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (!has_se) {
    uint4* a = reinterpret_cast<uint4*>(dws);
    for (int i = tid; i < L.ro * LINE / 16; i += THREADS) a[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) sm90::mbar_init(&wbar[i], 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      sm90::prefetch_map(&xmap);
      if (p.has_expand) sm90::prefetch_map(&emap);
      sm90::prefetch_map(&pmap);
      if (has_se) sm90::prefetch_map(&amap);
    }
    issue_x(0);
    issue_weights(0);
  }
  uint32_t wph = 0, xph = 0;

  // step n's copies (double buffers: the next step's too, but pass 1's first
  // A tile, which lands on the live depthwise sums), then the waits
  auto begin_step = [&](int n) {
    const int s = n % L.nslab, tile = tile_of(n);
    if (warp == 0) {
      if (L.wbufs == 2) {
        if (n + 1 < n_steps && !(has_se && n + 1 == P0)) issue_weights(n + 1);
        if (has_se && n == P0 && n > 0) issue_weights(n);
      } else if (n > 0) {
        issue_weights(n);
      }
      if (s == 0 && runs_dw(n)) {
        if (L.xbufs == 2 && tile + 1 < L.n_tiles) issue_x(tile + 1);
        if (L.xbufs == 1 && x_per_tile && tile > 0) issue_x(tile);
      }
    }
    if (s == 0 && runs_dw(n) && (x_per_tile || tile == 0)) {
      const int xb = tile % L.xbufs;
      sm90::mbar_wait(&xbar[xb], (xph >> xb) & 1);
      xph ^= 1u << xb;
    }
    const int wb = n % L.wbufs;
    sm90::mbar_wait(&wbar[wb], (wph >> wb) & 1);
    wph ^= 1u << wb;
  };

  // 1. step n's hidden slab act(x w_exp + b_exp) into the halo
  // [IPB][hh][hw][64], zero outside; no expand: the input box.
  auto hidden = [&](int n, const unsigned char* xcur, const float* aux) -> const unsigned char* {
    const int s = n % L.nslab, tile = tile_of(n);
    if (!p.has_expand) return xcur + s * L.rx * LINE;
    const int gy0 = tile / L.tiles_w * th - p.pad_h, gx0 = tile % L.tiles_w * tw - p.pad_w;
    unsigned char* hid_w = smem + L.off_hid;
    const unsigned char* we = wexp + (n % L.wbufs) * wexp_buf;
    const int ksteps = (p.cin + 15) / 16;
    for (int v = wg; v < L.rx / 64 * 2; v += WGS) {
      const int m = v >> 1, half = v & 1;
      float e[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) e[i] = 0.0f;
      sm90::acc_fence(e);
      sm90::wgmma_fence();
      for (int ks = 0; ks < ksteps; ++ks) {
        const int c = ks >> 2, kk = ks & 3;
        wgmma_m64n32k16(e, sm90::sw128_desc(xcur + c * L.rx * LINE + m * 64 * LINE + 32 * kk),
                sm90::sw128_desc(we + c * 64 * LINE + half * 32 * LINE + 32 * kk));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::acc_fence(e);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m * 64 + sm90::acc_row(t, h);
        if (r >= L.xrows) continue;
        int hr;  // its row of the hidden halo
        bool inside = true;
        if (L.xplane) {
          const int i = r / (p.H * p.W), pr = r % (p.H * p.W);
          hr = i * L.halo + (pr / p.W + p.pad_h) * L.hw + pr % p.W + p.pad_w;
        } else {
          const int gy = gy0 + r / L.hw, gx = gx0 + r % L.hw;
          inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
          hr = r;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = half * 32 + sm90::acc_col(t, j, 0);
          uint32_t w = 0;
          if (inside && s * CS + col < p.ce) {
            const float2 be = *reinterpret_cast<const float2*>(aux + (K * K + 1) * CS + col);
            w = pack_bf16(act(e[4 * j + 2 * h] + be.x, p.relu6), act(e[4 * j + 2 * h + 1] + be.y, p.relu6));
          }
          *reinterpret_cast<uint32_t*>(hid_w + hr * LINE + col * 2) = w;
        }
      }
    }
    __syncthreads();
    return hid_w;
  };

  // 2. step n's depthwise: an item is PX pixels of a row, a lane a channel
  // pair (16 lanes an item at <= 32 channels), a kernel row's PX + K - 1 halo
  // values loaded once; bf16 out to global (SE, fp32 sums to red_s) or the A
  // tile.
  auto depthwise = [&](int n, const unsigned char* hid, const float* aux) {
    const int s = n % L.nslab, tile = tile_of(n);
    const int ty0 = tile / L.tiles_w * th, tx0 = tile % L.tiles_w * tw;
    const int slab_ch = min(CS, p.ce - s * CS);
    const int lpi = slab_ch > 32 ? 32 : 16;
    const int cp = lane % lpi;
    const bool cok = 2 * cp < slab_ch;
    const float2* wk = reinterpret_cast<const float2*>(aux) + cp;  // tap i at wk[i * CS / 2]
    const float2 bdw = reinterpret_cast<const float2*>(aux + K * K * CS)[cp];
    const int segs = (tw + PX - 1) / PX;
    const int ipw = 32 / lpi;
    float ps[IPB][2];
#pragma unroll
    for (int i = 0; i < IPB; ++i) ps[i][0] = ps[i][1] = 0.0f;
    for (int it = warp * ipw + lane / lpi; it < IPB * th * segs; it += WARPS * ipw) {
      const int im = it / (th * segs), ir = it % (th * segs);
      const int py = ir / segs, px0 = ir % segs * PX;
      const bool row_real = ty0 + py < p.H && cok && b0 + im < p.B;
      float a[PX][2];
#pragma unroll
      for (int i = 0; i < PX; ++i) a[i][0] = a[i][1] = 0.0f;
      if (row_real) {
#pragma unroll
        for (int di = 0; di < K; ++di) {
          const unsigned char* row = hid + (im * L.halo + (py + di) * L.hw) * LINE + 4 * cp;
          uint32_t v[PX + K - 1];
#pragma unroll
          for (int j = 0; j < PX + K - 1; ++j)  // past the halo row only for pixels past the tile
            v[j] = *reinterpret_cast<const uint32_t*>(row + min(px0 + j, L.hw - 1) * LINE);
#pragma unroll
          for (int dj = 0; dj < K; ++dj) {
            const float2 w = wk[(di * K + dj) * (CS / 2)];
#pragma unroll
            for (int i = 0; i < PX; ++i) {
              a[i][0] = fmaf(bf16_lo(v[i + dj]), w.x, a[i][0]);
              a[i][1] = fmaf(bf16_hi(v[i + dj]), w.y, a[i][1]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < PX; ++i) {
        const int px = px0 + i;
        if (px >= tw) break;
        const bool real = row_real && tx0 + px < p.W;
        const float a0 = real ? act(a[i][0] + bdw.x, p.relu6) : 0.0f;
        const float a1 = real ? act(a[i][1] + bdw.y, p.relu6) : 0.0f;
        if (has_se) {
          if (real) {
            const size_t pix = ((size_t)(b0 + im) * p.H + ty0 + py) * p.W + tx0 + px;
            *reinterpret_cast<uint32_t*>(p.dwg + pix * p.ce + s * CS + 2 * cp) = pack_bf16(a0, a1);
          }
#pragma unroll
          for (int j = 0; j < IPB; ++j)
            if (im == j) {
              ps[j][0] += a0;
              ps[j][1] += a1;
            }
        } else {
          const int q = im * tpix + py * tw + px;  // a row of the project's A tile
          *reinterpret_cast<uint32_t*>(dws + q * LINE + (((cp >> 2) ^ (q & 7)) << 4) + 4 * (cp & 3)) =
            real ? pack_bf16(a0, a1) : 0u;
        }
      }
    }
    if (has_se) {
#pragma unroll
      for (int im = 0; im < IPB; ++im) {
        float p0 = ps[im][0], p1 = ps[im][1];
        if (lpi == 16) {  // the warp's two items share their channels
          p0 += __shfl_xor_sync(0xffffffffu, p0, 16);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 16);
        }
        if (lane < lpi) {
          red_s[(warp * IPB + im) * CS + 2 * cp] = p0;
          red_s[(warp * IPB + im) * CS + 2 * cp + 1] = p1;
        }
      }
    } else {
      sm90::fence_proxy_async();  // the A tile, written here, is read by wgmma
    }
  };

  // 3. step n's project: this warpgroup's tiles += A x w_proj^T; after the
  // last slab bias, residual, bf16 out
  auto project = [&](int n, const unsigned char* a_tile, const unsigned char* xcur, float (&acc)[NT_MAX][32]) {
    const int s = n % L.nslab, tile = tile_of(n);
    const int ty0 = tile / L.tiles_w * th, tx0 = tile % L.tiles_w * tw;
    const unsigned char* wp = wproj + (n % L.wbufs) * wproj_buf;
    sm90::wgmma_fence();
#pragma unroll
    for (int i = 0; i < NT_MAX; ++i) {
      const int tile_i = wg + WGS * i;
      if (tile_i < n_proj) {
        const int m = tile_i / npt, j = tile_i % npt;
        sm90::acc_fence(acc[i]);
#pragma unroll
        for (int kk = 0; kk < CS / 16; ++kk)
          wgmma_m64n64k16(acc[i], sm90::sw128_desc(a_tile + m * 64 * LINE + 32 * kk),
                  sm90::sw128_desc(wp + j * 64 * LINE + 32 * kk));
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NT_MAX; ++i) sm90::acc_fence(acc[i]);
    if (s != L.nslab - 1) return;
#pragma unroll
    for (int i = 0; i < NT_MAX; ++i) {
      const int tile_i = wg + WGS * i;
      if (tile_i >= n_proj) continue;
      const int m = tile_i / npt, jt = tile_i % npt;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = m * 64 + sm90::acc_row(t, h);
        const int im = q / tpix, py = q % tpix / tw, px = q % tw;
        const int oy = ty0 + py, ox = tx0 + px;
        if (q >= IPB * tpix || b0 + im >= p.B || oy >= p.H || ox >= p.W) continue;
        const size_t pix = ((size_t)(b0 + im) * p.H + oy) * p.W + ox;
        // its row of the input box
        const int xr = L.xplane ? im * p.H * p.W + oy * p.W + ox
                    : im * L.halo + (py + p.pad_h) * L.hw + px + p.pad_w;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int o = o0 + jt * 64 + sm90::acc_col(t, j, 0);
          if (o >= p.cout) continue;
          float y0 = acc[i][4 * j + 2 * h] + bproj_s[o];
          float y1 = acc[i][4 * j + 2 * h + 1] + bproj_s[o + 1];
          if (p.residual) {
            uint32_t r;
            if (has_se) {
              r = *reinterpret_cast<const uint32_t*>(p.x + pix * p.cin + o);
            } else {
              const int c = o & 63;  // swizzled with expand
              const int u = p.has_expand ? (c >> 3) ^ (xr & 7) : c >> 3;
              r = *reinterpret_cast<const uint32_t*>(xcur + (o >> 6) * L.rx * LINE + xr * LINE + u * 16 +
                                 (c & 7) * 2);
            }
            y0 += bf16_lo(r);
            y1 += bf16_hi(r);
          }
          *reinterpret_cast<uint32_t*>(p.out + pix * p.cout + o) = pack_bf16(y0, y1);
        }
      }
    }
  };

  // pass 0 (with SE): expand, depthwise to global memory, the pool
  for (int n = 0; n < P0; ++n) {
    const int s = n % L.nslab;
    begin_step(n);
    const float* aux = reinterpret_cast<const float*>(smem + L.off_aux + (n % L.wbufs) * L.aux);
    const unsigned char* xcur = xs + (tile_of(n) % L.xbufs) * x_buf;
    const unsigned char* hid = hidden(n, xcur, aux);
    depthwise(n, hid, aux);
    __syncthreads();
    // the pool: the slab's channel sums in warp order, tiles in order
    if (tid < IPB * CS && s * CS + tid % CS < p.ce) {
      const int im = tid / CS, c = tid % CS;
      float sum = 0.0f;
      for (int w = 0; w < WARPS; ++w) sum += red_s[(w * IPB + im) * CS + c];
      pool_s[im * L.cep + s * CS + c] += sum;
    }
    __syncthreads();
  }
  if (has_se) {
    // the SE gate of each image: mean, MLP (warp w sums channels w mod
    // WARPS, lane j a hidden unit, via red_s), sigmoid
    for (int c = tid; c < IPB * L.cep; c += THREADS) pool_s[c] = pool_s[c] / (float)(p.H * p.W);
    __syncthreads();
    for (int im = 0; im < IPB; ++im) {
      const float* mean = pool_s + im * L.cep;
      for (int j0 = 0; j0 < p.S; j0 += 32) {
        const int j = j0 + lane;
        float a = 0.0f;
        if (j < p.S) {
#pragma unroll 8
          for (int c = warp; c < p.ce; c += WARPS) a = fmaf(mean[c], p.w_se1[(size_t)c * p.S + j], a);
        }
        red_s[warp * CS + lane] = a;
        __syncthreads();
        if (tid < 32 && j < p.S) {
          float sum = 0.0f;
          for (int w = 0; w < WARPS; ++w) sum += red_s[w * CS + tid];
          s1_s[im * L.s32 + j] = swish(sum + p.b_se1[j]);
        }
        __syncthreads();
      }
    }
    for (int c0 = tid; c0 < IPB * p.ce; c0 += 2 * THREADS) {  // two (image, channel)s a thread at once
      float a[2] = {0.0f, 0.0f};
      int im[2], c[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        im[u] = (c0 + u * THREADS) / p.ce;
        c[u] = (c0 + u * THREADS) % p.ce;
      }
#pragma unroll 4
      for (int j = 0; j < p.S; ++j) {
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (c0 + u * THREADS < IPB * p.ce)
            a[u] = fmaf(s1_s[im[u] * L.s32 + j], p.w_se2[(size_t)j * p.ce + c[u]], a[u]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
        if (c0 + u * THREADS < IPB * p.ce)
          pool_s[im[u] * L.cep + c[u]] = 1.0f / (1.0f + expf(-(a[u] + p.b_se2[c[u]])));
    }
    // this block's depthwise output, written by its threads, is read back by TMA in pass 1
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
    __syncthreads();
  }

  // pass 1: SE: the stored depthwise output, gated, into the project; else
  // expand, depthwise, project (two loops keep the depthwise's registers
  // free)
  float acc[NT_MAX][32];
  auto zero_acc = [&]() {
#pragma unroll
    for (int i = 0; i < NT_MAX; ++i)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[i][e] = 0.0f;
  };
  if (has_se) {
    for (int n = P0; n < n_steps; ++n) {
      const int s = n % L.nslab;
      begin_step(n);
      if (s == 0) zero_acc();
      // round(round(a) * gate): the A tile, in place (16 bytes, 8 channels, a thread at a time)
      unsigned char* at = abuf(n);
      for (int u = tid; u < IPB * tpix * 8; u += THREADS) {
        const int row = u >> 3, im = row / tpix;
        const int c = s * CS + (((u & 7) ^ (row & 7)) << 3);  // its first channel
        uint4* v = reinterpret_cast<uint4*>(at + row * LINE + (u & 7) * 16);
        uint4 x = *v;
        uint32_t* w = reinterpret_cast<uint32_t*>(&x);
        const float* g = pool_s + im * L.cep + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = pack_bf16(bf16_lo(w[e]) * g[2 * e], bf16_hi(w[e]) * g[2 * e + 1]);
        *v = x;
      }
      sm90::fence_proxy_async();
      __syncthreads();
      project(n, at, xs, acc);
      __syncthreads();
    }
  } else {
    for (int n = 0; n < n_steps; ++n) {
      const int s = n % L.nslab;
      begin_step(n);
      if (s == 0) zero_acc();
      const float* aux = reinterpret_cast<const float*>(smem + L.off_aux + (n % L.wbufs) * L.aux);
      const unsigned char* xcur = xs + (tile_of(n) % L.xbufs) * x_buf;
      depthwise(n, hidden(n, xcur, aux), aux);
      __syncthreads();
      project(n, dws, xcur, acc);
      __syncthreads();
    }
  }
}

// The 4-D map of an NHWC tensor [B, H, W, C] read in boxes [ipb, hh, hw, 64].
int encode_nhwc_map(CUtensorMap* map, const void* base, int B, int H, int W, int C, int ipb, int hh, int hw,
          bool swizzle) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2, (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CS, (cuuint32_t)hw, (cuuint32_t)hh, (cuuint32_t)ipb};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int K, int IPB>
int launch(const Params& p, int B, const void* w_exp_t, const void* w_proj_t, cudaStream_t stream) {
  const Layout L =
    layout(p.H, p.W, K, p.cin, p.ce, p.cout, p.S, p.has_expand, p.th, p.tw, p.group, p.bufs, p.ipb);
  if (refused(L) || L.hh > 256 || L.hw > 256) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, emap, pmap;
  int err = L.xplane ? encode_nhwc_map(&xmap, p.x, B, p.H, p.W, p.cin, p.ipb, p.H, p.W, true)
           : encode_nhwc_map(&xmap, p.x, B, p.H, p.W, p.cin, p.ipb, L.hh, L.hw, p.has_expand != 0);
  // without expand the map is unused: any valid map will do
  if (err == 0)
    err = p.has_expand ? sm90::encode_bf16_map(&emap, w_exp_t, p.cin, p.ce, (long)p.cin * 2, 64)
             : sm90::encode_bf16_map(&emap, w_proj_t, p.ce, p.cout, (long)p.ce * 2, 64);
  if (err == 0) err = sm90::encode_bf16_map(&pmap, w_proj_t, p.ce, p.cout, (long)p.ce * 2, 64);
  // the stored depthwise output, with SE (without, any valid map will do)
  CUtensorMap amap;
  if (err == 0)
    err = p.dwg != nullptr ? encode_nhwc_map(&amap, p.dwg, B, p.H, p.W, p.ce, IPB, p.th, p.tw, true)
               : encode_nhwc_map(&amap, p.x, B, p.H, p.W, p.cin, IPB, p.th, p.tw, true);
  if (err != 0) return err;
  static int opted_in = 0;  // once per kernel: the limit, not the size, is set
  if (!opted_in) {
    const cudaError_t e =
      cudaFuncSetAttribute(mbconv_sm90<K, IPB>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    opted_in = 1;
  }
  const int groups = ((p.cout + 63) / 64 + p.group - 1) / p.group;
  mbconv_sm90<K, IPB><<<dim3((B + IPB - 1) / IPB, groups), THREADS, L.total, stream>>>(xmap, emap, pmap, amap, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory of a block for the plan, or -1 if refused (`refused`).
extern "C" int mbconv_smem(int H, int W, int k, int cin, int ce, int cout, int S, int has_expand, int th, int tw,
             int group, int bufs, int ipb) {
  const Layout L = layout(H, W, k, cin, ce, cout, S, has_expand, th, tw, group, bufs, ipb);
  return refused(L) || ipb < 1 || ipb > 2 || (ipb > 1 && (L.n_tiles > 1 || k == 7)) ? -1 : L.total;
}

// NHWC bf16 in and out, the weights as `ops/mbconv_kernel.py::prepare_params`
// lays them out (null w_exp_t: no expand; null SE: none); dw the SE's bf16
// scratch. k 3, 5, 7; channels % 8 == 0. Returns a cudaError_t.
extern "C" int mbconv_launch(const void* x, const void* w_exp_t, const void* aux, void* dw, const void* w_se1,
              const void* b_se1, const void* w_se2, const void* b_se2, const void* w_proj_t,
              const void* b_proj, void* out, int B, int H, int W, int cin, int ce, int cout, int S,
              int k, int pad_h, int pad_w, int th, int tw, int group, int bufs, int ipb, int relu6,
              int residual, void* stream) {
  if (B < 1 || H < 1 || W < 1 || cin % 8 || ce % 8 || cout % 8 || th < 1 || tw < 1 || th > H || tw > W ||
    group < 1 || bufs < 0 || bufs > 3 || ipb < 1 || ipb > 2 || (ipb > 1 && (th != H || tw != W)) ||
    (w_exp_t == nullptr && cin != ce) || (residual && cin != cout) ||
    (w_se1 != nullptr && (S < 1 || dw == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Params p{(const __nv_bfloat16*)x, w_se1 != nullptr ? (__nv_bfloat16*)dw : nullptr, (const float*)aux,
         (const float*)w_se1, (const float*)b_se1,
         (const float*)w_se2, (const float*)b_se2, (const float*)b_proj, (__nv_bfloat16*)out,
         B, H, W, cin, ce, cout, w_se1 != nullptr ? S : 0, pad_h, pad_w, th, tw, group, bufs, ipb,
         w_exp_t != nullptr, residual != 0, relu6};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k * 2 + ipb - 1) {
    case 6: return launch<3, 1>(p, B, w_exp_t, w_proj_t, s);
    case 7: return launch<3, 2>(p, B, w_exp_t, w_proj_t, s);
    case 10: return launch<5, 1>(p, B, w_exp_t, w_proj_t, s);
    case 11: return launch<5, 2>(p, B, w_exp_t, w_proj_t, s);
    case 14: return launch<7, 1>(p, B, w_exp_t, w_proj_t, s);
    default: return (int)cudaErrorInvalidValue;  // two images a block only at k = 3 and 5
  }
}
