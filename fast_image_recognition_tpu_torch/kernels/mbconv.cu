// Fused stride-1 MBConv block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_mbconv_kernel`
// (fast_image_recognition_tpu/ops/mbconv_kernel.py:82, launched by
// `_fused_mbconv_jit` :192): one BN-folded inverted-residual block,
//
//     hid = act(x @ w_exp + b_exp)            (1x1 expand, if any; else x)
//     a   = act(depthwise_kxk_SAME(hid) + b_dw)
//     g   = sigmoid(swish(mean_hw(a) @ w_se1 + b_se1) @ w_se2 + b_se2)  (SE, if any)
//     y   = (a * g) @ w_proj + b_proj (+ x)   (1x1 project, residual if any)
//
// on activations in NHWC memory (PyTorch's channels_last), bf16 in and out.
//
// Design. The TPU kernel keeps one image's whole plane in VMEM; a Hopper
// block has at most 227 KB of shared memory and B0's bf16 hidden planes
// reach 882 KB (56x56x144), and the SE gate needs the whole plane before
// the project. So the block runs as two launches:
//   1. `expand_dw_kernel`: one block per (32 hidden channels, spatial tile
//      of th x tw output pixels, image). It loads the tile's input halo
//      ((th+k-1) x (tw+k-1) pixels, all Cin channels) into shared memory,
//      recomputes the expand for those 32 channels on the halo with WMMA
//      bf16 x bf16 -> fp32 (the halo overlap is recomputed, not exchanged),
//      adds bias, applies the activation, rounds to bf16 and writes true
//      zeros at halo pixels outside the image (SAME padding pads AFTER the
//      expand, so the border taps must read 0, not act(b_exp)). The
//      depthwise conv then runs on the CUDA cores in fp32 (weights in
//      registers, one channel per thread), adds bias and activation, writes
//      the output bf16 to `dw` [B, H, W, Ce] and the tile's fp32 channel
//      sums over its real pixels to `part` [B, n_tiles, Ce].
//   2. `se_project_kernel`: one block per (64 pixels, 64 output channels,
//      image). It sums the image's `part` rows in tile order (a fixed
//      order, no atomics: the result is the same run after run), divides by
//      H*W, runs the SE MLP on the CUDA cores (widths 8..48 are no multiple
//      of 16), then streams `dw` in 64-channel steps, scales it by the gate
//      in fp32, rounds to bf16 and runs the project with WMMA; the epilogue
//      adds bias and the bf16 residual in fp32 and writes bf16.
// Rounding points are the TPU kernel's (hidden bf16; depthwise, SE pool,
// SE MLP and scale fp32; scaled hidden bf16 before the project; fp32
// project accumulator, bias and residual; bf16 out) plus one: the
// depthwise output is stored in bf16 between the launches.
// `kernels/plain.py::mbconv_plain` rounds at the same places.
//
// Bound and cost: a block's least work is one read of x and one write of y
// (bytes bound for the 112x112 and 56x56 blocks) or its expand and project
// products at 989 TFLOP/s and its depthwise taps at the 67 TFLOP/s fp32
// CUDA-core rate. This design pays one bf16 round trip of the depthwise
// output through device memory (2 * B*H*W*Ce bytes, about 2.2 ms over B0's
// twelve stride-1 blocks at B=1024), the halo's share of recomputed expand
// products, and one recomputation of the SE MLP per project block. WMMA
// rather than wgmma, no cp.async/TMA pipelining: a simple, correct first
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int CC = 32;        // hidden channels per expand_dw block (= warp size)
constexpr int PAD = 8;        // bf16 row padding in shared memory
constexpr int PT = 64;        // pixels per se_project block
constexpr int NC = 64;        // output channels per se_project block
constexpr int KC = 64;        // hidden channels per project K step
constexpr int ACC_LD = NC + 4;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a Hopper block may opt in to

__host__ __device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ __forceinline__ float swish(float v) { return v / (1.0f + expf(-v)); }

__device__ __forceinline__ float act(float v, int relu6) {
    return relu6 ? fminf(fmaxf(v, 0.0f), 6.0f) : swish(v);
}

// Shared memory of one expand_dw block; ops/mbconv_kernel.py::expand_dw_smem
// computes the same number to choose the tile.
__host__ __device__ inline int expand_dw_smem(int th, int tw, int k, int cin, int has_expand) {
    const int npp = round_up((th + k - 1) * (tw + k - 1), 16);
    int total = npp * (CC + PAD) * 2 + THREADS * 4;
    if (has_expand) {
        const int cinp = round_up(cin, 16);
        total += npp * (cinp + PAD) * 2 + cinp * (CC + PAD) * 2 + WARPS * 256 * 4;
    }
    return total;
}

template <int K>
__global__ void __launch_bounds__(THREADS)
expand_dw_kernel(const __nv_bfloat16* __restrict__ x,      // [B, H, W, cin]
                 const __nv_bfloat16* __restrict__ w_exp,  // [cin, ce] or null
                 const float* __restrict__ b_exp,          // [ce]
                 const float* __restrict__ w_dw,           // [K*K, ce]
                 const float* __restrict__ b_dw,           // [ce]
                 __nv_bfloat16* __restrict__ dw,           // [B, H, W, ce]
                 float* __restrict__ part,                 // [B, n_tiles, ce]
                 int H, int W, int cin, int ce, int pad_h, int pad_w,
                 int th, int tw, int tiles_w, int n_tiles, int relu6) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int hh = th + K - 1, hw = tw + K - 1;
    const int np = hh * hw;
    const int npp = round_up(np, 16);
    const int has_expand = w_exp != nullptr;
    const int cinp = round_up(cin, 16);
    __nv_bfloat16* hid_s = reinterpret_cast<__nv_bfloat16*>(smem);          // [npp][CC+PAD]
    float* red_s = reinterpret_cast<float*>(hid_s + npp * (CC + PAD));       // [WARPS][CC]
    __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(red_s + THREADS);  // [npp][cinp+PAD]
    __nv_bfloat16* w_s = x_s + npp * (cinp + PAD);                           // [cinp][CC+PAD]
    float* scr_s = reinterpret_cast<float*>(w_s + cinp * (CC + PAD));        // [WARPS][16*16]

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int c0 = blockIdx.x * CC;
    const int tile = blockIdx.y;
    const int b = blockIdx.z;
    const int ty0 = (tile / tiles_w) * th;
    const int tx0 = (tile % tiles_w) * tw;
    const int gy0 = ty0 - pad_h, gx0 = tx0 - pad_w;  // image coordinates of halo pixel 0
    const size_t img = (size_t)b * H * W;

    if (has_expand) {
        const int vpr = cinp / 8;
        for (int v = tid; v < npp * vpr; v += THREADS) {
            const int r = v / vpr, cv = v % vpr;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (r < np && cv * 8 < cin) {
                const int gy = gy0 + r / hw, gx = gx0 + r % hw;
                if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    val = *reinterpret_cast<const uint4*>(x + (img + (size_t)gy * W + gx) * cin + cv * 8);
            }
            *reinterpret_cast<uint4*>(x_s + r * (cinp + PAD) + cv * 8) = val;
        }
        for (int v = tid; v < cinp * (CC / 8); v += THREADS) {
            const int r = v / (CC / 8), cv = v % (CC / 8);
            const int c = c0 + cv * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (r < cin && c < ce) val = *reinterpret_cast<const uint4*>(w_exp + (size_t)r * ce + c);
            *reinterpret_cast<uint4*>(w_s + r * (CC + PAD) + cv * 8) = val;
        }
        __syncthreads();
        float* scr = scr_s + warp * 256;
        for (int mf = warp; mf < npp / 16; mf += WARPS) {
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
            wmma::fill_fragment(acc0, 0.0f);
            wmma::fill_fragment(acc1, 0.0f);
            for (int k0 = 0; k0 < cinp; k0 += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b0, b1;
                wmma::load_matrix_sync(a, x_s + mf * 16 * (cinp + PAD) + k0, cinp + PAD);
                wmma::load_matrix_sync(b0, w_s + k0 * (CC + PAD), CC + PAD);
                wmma::load_matrix_sync(b1, w_s + k0 * (CC + PAD) + 16, CC + PAD);
                wmma::mma_sync(acc0, a, b0, acc0);
                wmma::mma_sync(acc1, a, b1, acc1);
            }
            for (int nf = 0; nf < 2; ++nf) {
                wmma::store_matrix_sync(scr, nf ? acc1 : acc0, 16, wmma::mem_row_major);
                __syncwarp();
                for (int e = lane; e < 256; e += 32) {
                    const int r = mf * 16 + (e >> 4);
                    const int c = nf * 16 + (e & 15);
                    float v = 0.0f;
                    if (r < np && c0 + c < ce) {
                        const int gy = gy0 + r / hw, gx = gx0 + r % hw;
                        if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = act(scr[e] + b_exp[c0 + c], relu6);
                    }
                    hid_s[r * (CC + PAD) + c] = __float2bfloat16_rn(v);
                }
                __syncwarp();
            }
        }
    } else {  // no expand (cin == ce): the hidden tensor is x itself
        for (int v = tid; v < npp * (CC / 8); v += THREADS) {
            const int r = v / (CC / 8), cv = v % (CC / 8);
            const int c = c0 + cv * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (r < np && c < ce) {
                const int gy = gy0 + r / hw, gx = gx0 + r % hw;
                if (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    val = *reinterpret_cast<const uint4*>(x + (img + (size_t)gy * W + gx) * cin + c);
            }
            *reinterpret_cast<uint4*>(hid_s + r * (CC + PAD) + cv * 8) = val;
        }
    }
    __syncthreads();

    // depthwise: thread (group, channel) walks the tile's pixels
    const int c = tid % CC;
    const int grp = tid / CC;
    const int gc = c0 + c;
    const bool cok = gc < ce;
    float wk[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) wk[t] = cok ? w_dw[(size_t)t * ce + gc] : 0.0f;
    const float bias = cok ? b_dw[gc] : 0.0f;
    float psum = 0.0f;
    for (int p = grp; p < th * tw; p += THREADS / CC) {
        const int py = p / tw, px = p % tw;
        const int oy = ty0 + py, ox = tx0 + px;
        if (oy >= H || ox >= W) continue;
        float a = 0.0f;
#pragma unroll
        for (int di = 0; di < K; ++di) {
#pragma unroll
            for (int dj = 0; dj < K; ++dj)
                a = fmaf(__bfloat162float(hid_s[((py + di) * hw + px + dj) * (CC + PAD) + c]), wk[di * K + dj], a);
        }
        a = act(a + bias, relu6);
        psum += a;
        if (cok) dw[(img + (size_t)oy * W + ox) * ce + gc] = __float2bfloat16_rn(a);
    }
    red_s[grp * CC + c] = psum;
    __syncthreads();
    if (tid < CC && c0 + tid < ce) {
        float s = 0.0f;
        for (int g = 0; g < THREADS / CC; ++g) s += red_s[g * CC + tid];
        part[((size_t)b * n_tiles + tile) * ce + c0 + tid] = s;
    }
}

__global__ void __launch_bounds__(THREADS)
se_project_kernel(const __nv_bfloat16* __restrict__ dw,      // [B, HW, ce]
                  const float* __restrict__ part,            // [B, n_tiles, ce]
                  const float* __restrict__ w_se1,           // [ce, S] or null
                  const float* __restrict__ b_se1,           // [S]
                  const float* __restrict__ w_se2,           // [S, ce]
                  const float* __restrict__ b_se2,           // [ce]
                  const __nv_bfloat16* __restrict__ w_proj,  // [ce, cout]
                  const float* __restrict__ b_proj,          // [cout]
                  const __nv_bfloat16* __restrict__ x_res,   // [B, HW, cout] or null
                  __nv_bfloat16* __restrict__ out,           // [B, HW, cout]
                  int HW, int ce, int cout, int S, int n_tiles) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int cep = round_up(ce, 32);
    float* gate_s = reinterpret_cast<float*>(smem);                              // [cep]
    float* s1_s = gate_s + cep;                                                  // [round_up(S, 32)]
    __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(s1_s + round_up(S, 32));  // [PT][KC+PAD]
    __nv_bfloat16* w_s = h_s + PT * (KC + PAD);                                  // [KC][NC+PAD]
    float* acc_s = reinterpret_cast<float*>(h_s);  // [PT][ACC_LD], after the K loop

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int p0 = blockIdx.x * PT;
    const int n0 = blockIdx.y * NC;
    const int b = blockIdx.z;
    const bool has_se = w_se1 != nullptr;

    if (has_se) {
        // pool: the image's tile sums in tile order, then the mean
        for (int c = tid; c < ce; c += THREADS) {
            const float* pp = part + (size_t)b * n_tiles * ce + c;
            float s = 0.0f;
            for (int t = 0; t < n_tiles; ++t) s += pp[(size_t)t * ce];
            gate_s[c] = s / (float)HW;
        }
        __syncthreads();
        for (int j = warp; j < S; j += WARPS) {
            float a = 0.0f;
            for (int c = lane; c < ce; c += 32) a = fmaf(gate_s[c], w_se1[(size_t)c * S + j], a);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
            if (lane == 0) s1_s[j] = swish(a + b_se1[j]);
        }
        __syncthreads();
        for (int c = tid; c < ce; c += THREADS) {
            float a = 0.0f;
            for (int j = 0; j < S; ++j) a = fmaf(s1_s[j], w_se2[(size_t)j * ce + c], a);
            gate_s[c] = 1.0f / (1.0f + expf(-(a + b_se2[c])));
        }
        __syncthreads();
    }

    const int mf = warp >> 1;       // 16-pixel slice
    const int nf = (warp & 1) * 2;  // first of two 16-channel slices
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc0, acc1;
    wmma::fill_fragment(acc0, 0.0f);
    wmma::fill_fragment(acc1, 0.0f);
    const size_t img = (size_t)b * HW;
    for (int kc = 0; kc < ce; kc += KC) {
        for (int v = tid; v < PT * (KC / 8); v += THREADS) {
            const int r = v / (KC / 8), cv = v % (KC / 8);
            const int c = kc + cv * 8, p = p0 + r;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (p < HW && c < ce) {
                val = *reinterpret_cast<const uint4*>(dw + (img + p) * ce + c);
                if (has_se) {
                    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
                    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16_rn(__bfloat162float(e[i]) * gate_s[c + i]);
                }
            }
            *reinterpret_cast<uint4*>(h_s + r * (KC + PAD) + cv * 8) = val;
        }
        for (int v = tid; v < KC * (NC / 8); v += THREADS) {
            const int r = v / (NC / 8), cv = v % (NC / 8);
            const int c = kc + r, n = n0 + cv * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (c < ce && n < cout) val = *reinterpret_cast<const uint4*>(w_proj + (size_t)c * cout + n);
            *reinterpret_cast<uint4*>(w_s + r * (NC + PAD) + cv * 8) = val;
        }
        __syncthreads();
#pragma unroll
        for (int k0 = 0; k0 < KC; k0 += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b0, b1;
            wmma::load_matrix_sync(a, h_s + mf * 16 * (KC + PAD) + k0, KC + PAD);
            wmma::load_matrix_sync(b0, w_s + k0 * (NC + PAD) + nf * 16, NC + PAD);
            wmma::load_matrix_sync(b1, w_s + k0 * (NC + PAD) + (nf + 1) * 16, NC + PAD);
            wmma::mma_sync(acc0, a, b0, acc0);
            wmma::mma_sync(acc1, a, b1, acc1);
        }
        __syncthreads();
    }
    wmma::store_matrix_sync(acc_s + mf * 16 * ACC_LD + nf * 16, acc0, ACC_LD, wmma::mem_row_major);
    wmma::store_matrix_sync(acc_s + mf * 16 * ACC_LD + (nf + 1) * 16, acc1, ACC_LD, wmma::mem_row_major);
    __syncthreads();
    for (int v = tid; v < PT * NC; v += THREADS) {
        const int r = v / NC, n = v % NC;
        const int p = p0 + r, gn = n0 + n;
        if (p < HW && gn < cout) {
            float y = acc_s[r * ACC_LD + n] + b_proj[gn];
            if (x_res != nullptr) y += __bfloat162float(x_res[(img + p) * cout + gn]);
            out[(img + p) * cout + gn] = __float2bfloat16_rn(y);
        }
    }
}

int se_project_smem(int ce, int S) {
    const int stage = PT * (KC + PAD) * 2 + KC * (NC + PAD) * 2;
    const int acc = PT * ACC_LD * 4;
    return (round_up(ce, 32) + round_up(S, 32)) * 4 + (stage > acc ? stage : acc);
}

template <int K>
cudaError_t launch_expand_dw(const void* x, const void* w_exp, const void* b_exp, const void* w_dw,
                             const void* b_dw, void* dw, void* part, int B, int H, int W, int cin, int ce,
                             int pad_h, int pad_w, int th, int tw, int relu6, cudaStream_t stream) {
    const int smem = expand_dw_smem(th, tw, K, cin, w_exp != nullptr);
    if (smem > MAX_SMEM) return cudaErrorInvalidValue;
    static bool opted_in = false;  // once per kernel: the limit, not the size, is set
    if (!opted_in) {
        cudaError_t err = cudaFuncSetAttribute(expand_dw_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (err != cudaSuccess) return err;
        opted_in = true;
    }
    const int tiles_h = (H + th - 1) / th, tiles_w = (W + tw - 1) / tw;
    dim3 grid((ce + CC - 1) / CC, tiles_h * tiles_w, B);
    expand_dw_kernel<K><<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w_exp),
        static_cast<const float*>(b_exp), static_cast<const float*>(w_dw), static_cast<const float*>(b_dw),
        static_cast<__nv_bfloat16*>(dw), static_cast<float*>(part), H, W, cin, ce, pad_h, pad_w, th, tw,
        tiles_w, tiles_h * tiles_w, relu6);
    return cudaGetLastError();
}

}  // namespace

// First launch: expand (when w_exp is not null) + depthwise + activation of
// one stride-1 block; writes dw [B, H, W, ce] bf16 and part [B, n_tiles, ce]
// fp32 (n_tiles = ceil(H/th) * ceil(W/tw)). k is 3, 5 or 7; cin, ce % 8 == 0.
extern "C" int mbconv_expand_dw_launch(const void* x, const void* w_exp, const void* b_exp, const void* w_dw,
                                       const void* b_dw, void* dw, void* part, int B, int H, int W, int cin,
                                       int ce, int k, int pad_h, int pad_w, int th, int tw, int relu6,
                                       cudaStream_t stream) {
    if (B < 1 || B > 65535 || cin % 8 || ce % 8 || th < 1 || tw < 1 || (w_exp == nullptr && cin != ce))
        return (int)cudaErrorInvalidValue;
    switch (k) {
        case 3: return (int)launch_expand_dw<3>(x, w_exp, b_exp, w_dw, b_dw, dw, part, B, H, W, cin, ce, pad_h, pad_w, th, tw, relu6, stream);
        case 5: return (int)launch_expand_dw<5>(x, w_exp, b_exp, w_dw, b_dw, dw, part, B, H, W, cin, ce, pad_h, pad_w, th, tw, relu6, stream);
        case 7: return (int)launch_expand_dw<7>(x, w_exp, b_exp, w_dw, b_dw, dw, part, B, H, W, cin, ce, pad_h, pad_w, th, tw, relu6, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Second launch: SE gate (when w_se1 is not null; S its width) from the
// first launch's tile sums, scale, project, bias and residual (when x_res
// is not null, cout == cin); writes out [B, hw, cout] bf16.
extern "C" int mbconv_se_project_launch(const void* dw, const void* part, const void* w_se1, const void* b_se1,
                                        const void* w_se2, const void* b_se2, const void* w_proj,
                                        const void* b_proj, const void* x_res, void* out, int B, int hw, int ce,
                                        int cout, int S, int n_tiles, cudaStream_t stream) {
    if (B < 1 || B > 65535 || ce % 8 || cout % 8 || (w_se1 != nullptr && S < 1)) return (int)cudaErrorInvalidValue;
    const int smem = se_project_smem(ce, S);
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
    static bool opted_in = false;
    if (!opted_in) {
        cudaError_t err = cudaFuncSetAttribute(se_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
        if (err != cudaSuccess) return (int)err;
        opted_in = true;
    }
    dim3 grid((hw + PT - 1) / PT, (cout + NC - 1) / NC, B);
    se_project_kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(dw), static_cast<const float*>(part), static_cast<const float*>(w_se1),
        static_cast<const float*>(b_se1), static_cast<const float*>(w_se2), static_cast<const float*>(b_se2),
        static_cast<const __nv_bfloat16*>(w_proj), static_cast<const float*>(b_proj),
        static_cast<const __nv_bfloat16*>(x_res), static_cast<__nv_bfloat16*>(out), hw, ce, cout,
        w_se1 != nullptr ? S : 0, n_tiles);
    return (int)cudaGetLastError();
}
