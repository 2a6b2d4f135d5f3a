// Chi-square 1-NN scan for Hopper (sm_90a).
//
// `chi2_launch` replaces the Pallas TPU kernel `_chi2_kernel`
// (fast_image_recognition_tpu/ops/chi2_kernel.py:55, launched by
// `_chi2_block` :120), the scan of `chi2_nn`. For every query it finds the
// gallery row, among rows [0, n_valid), with the least
//
//     d = sum_k (g_k - q_k)^2 * rcp(max(g_k + q_k, 1e-30))
//
// and returns it as one 64-bit key `(float bits of d) << 32 | row` per
// query. d is the unnormalized sum; the caller divides by D and may
// rescore the winner exactly. Queries are fp32, the gallery fp32 or bf16
// (upcast exactly on load), any D and any N.
//
// Reciprocal: `rcp.approx.ftz.f32` (MUFU.RCP, at most 1 ulp off the
// rounded reciprocal; max(s, 1e-30) is a normal fp32 value, so `ftz`
// changes nothing). A term of 0 (q_k = g_k, zero padding) stays 0.
//
// Ties and order: chi2 terms are >= 0 (the reciprocal of a value >=
// 1e-30 is > 0), so the fp32 bits of d order like d, and the least key is
// the least d at the lowest row. Every block reduces its (query, row)
// keys to one per query in shared memory and merges it into the output
// with one 64-bit `atomicMin`: the result does not depend on the order in
// which blocks run, and one launch covers every query block (JAX loops
// over query blocks of 256 on the host and rereads the gallery for each).
//
// Bound: one reciprocal per (query, row, feature) triple. At chi2_cost's
// shape (1024 x 102,400 x 1536 = 1.611e11 triples) the SFU's 16
// reciprocals per clock per SM (132 SMs at 1.98 GHz: 4.18e12/s) need
// 38.5 ms; the ~6 fp32 operations per triple at 67 TFLOP/s 14.4 ms; one
// read of the gallery 0.19 ms (fp32). So the reciprocals bound it, not
// the FMAs or HBM. Design: one block owns (64 queries, 64 rows) and walks
// D in 32-wide chunks staged in shared memory (fp32, transposed, padded
// against bank conflicts); each thread keeps a 4 x 4 register block of
// (query, row) sums, each summed per chunk first (two-level summation
// keeps the fp32 error near that of a pairwise sum). Query blocks vary
// fastest in the grid, so the blocks that read one gallery tile run
// together and share it through L2. No cp.async pipelining yet, and one
// reciprocal per term (a later version can share one between two terms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;  // queries per block
constexpr int RB = 64;  // gallery rows per block
constexpr int KC = 32;  // features per staged chunk
constexpr int TQ = 4;   // queries per thread, strided by QB / TQ
constexpr int TR = 4;   // rows per thread, strided by RB / TR
constexpr int THREADS = (QB / TQ) * (RB / TR);  // 256
constexpr int LDQ = QB + 1;  // padded: a warp stores one row's 32 features to 32 banks
constexpr int LDR = RB + 1;

__device__ __forceinline__ float rcp_approx(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename G>
__global__ void __launch_bounds__(THREADS)
chi2_kernel(const float* __restrict__ q, const G* __restrict__ g,
            unsigned long long* __restrict__ best, int B, int n_valid, int D, int n_qblocks) {
    __shared__ float q_s[KC * LDQ];  // [feature][query]
    __shared__ float g_s[KC * LDR];  // [feature][row]
    __shared__ unsigned long long best_s[QB];

    const int tid = threadIdx.x;
    const int tq = tid % (QB / TQ);  // queries tq + 16 i
    const int tr = tid / (QB / TQ);  // rows tr + 16 j
    const int q0 = (int)(blockIdx.x % n_qblocks) * QB;
    const long r0 = (long)(blockIdx.x / n_qblocks) * RB;
    if (tid < QB) best_s[tid] = ~0ull;

    float acc[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC) {
        // a warp loads KC consecutive features of one query and of one row
        for (int e = tid; e < QB * KC; e += THREADS) {
            const int r = e / KC, c = e % KC, k = k0 + c;
            const int qi = q0 + r;
            const long gi = r0 + r;
            q_s[c * LDQ + r] = (qi < B && k < D) ? q[(long)qi * D + k] : 0.f;
            g_s[c * LDR + r] = (gi < n_valid && k < D) ? to_f32(g[gi * D + k]) : 0.f;
        }
        __syncthreads();
        float part[TQ][TR];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < TR; ++j) part[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < KC; ++c) {
            float qv[TQ], gv[TR];
#pragma unroll
            for (int i = 0; i < TQ; ++i) qv[i] = q_s[c * LDQ + tq + i * (QB / TQ)];
#pragma unroll
            for (int j = 0; j < TR; ++j) gv[j] = g_s[c * LDR + tr + j * (RB / TR)];
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
                for (int j = 0; j < TR; ++j) {
                    const float diff = gv[j] - qv[i];
                    const float r = rcp_approx(fmaxf(gv[j] + qv[i], 1e-30f));
                    part[i][j] = fmaf(diff * diff, r, part[i][j]);
                }
        }
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
            for (int j = 0; j < TR; ++j) acc[i][j] += part[i][j];
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TQ; ++i) {
        unsigned long long key = ~0ull;
#pragma unroll
        for (int j = 0; j < TR; ++j) {
            const long row = r0 + tr + j * (RB / TR);
            if (row < n_valid) {
                const unsigned long long kj =
                    ((unsigned long long)__float_as_uint(acc[i][j]) << 32) | (unsigned)row;
                key = kj < key ? kj : key;
            }
        }
        if (key != ~0ull) atomicMin(&best_s[tq + i * (QB / TQ)], key);
    }
    __syncthreads();
    if (tid < QB && q0 + tid < B && best_s[tid] != ~0ull) atomicMin(&best[q0 + tid], best_s[tid]);
}

}  // namespace

// q [B, D] fp32, g [N, D] fp32 (g_f32 = 1) or bf16 (g_f32 = 0), rows
// [0, n_valid) scanned (1 <= n_valid <= N). `best` [B] must hold ~0 (all
// bits set) before the launch; it receives the least key per query.
extern "C" int chi2_launch(const float* q, const void* g, int g_f32, unsigned long long* best,
                           int B, int n_valid, int D, cudaStream_t stream) {
    if (B < 1 || n_valid < 1 || D < 1) return (int)cudaErrorInvalidValue;
    const long n_qblocks = (B + QB - 1) / QB;
    const long n_rblocks = ((long)n_valid + RB - 1) / RB;
    if (n_qblocks * n_rblocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)(n_qblocks * n_rblocks));
    if (g_f32) {
        chi2_kernel<float><<<grid, THREADS, 0, stream>>>(
            q, static_cast<const float*>(g), best, B, n_valid, D, (int)n_qblocks);
    } else {
        chi2_kernel<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
            q, static_cast<const __nv_bfloat16*>(g), best, B, n_valid, D, (int)n_qblocks);
    }
    return (int)cudaGetLastError();
}
