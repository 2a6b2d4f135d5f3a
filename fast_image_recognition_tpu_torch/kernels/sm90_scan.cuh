// The Hopper main loop of the gallery scans, sm_90a only: a ring of TMA boxes
// filled by one producer thread, `wgmma` of two consumer warpgroups,
// `mbarrier`s between (full[s]: stage s landed; empty[s]: released). A box is
// [rows x 128 bytes], 128-byte swizzle (chunk c of row r at c ^ (r % 8)). A
// wait open after ~2^35 clocks traps.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int KCHUNK = 64;
constexpr int KCHUNK_S8 = 128;
constexpr int LINE_BYTES = 128;
constexpr int WG_THREADS = 128;   // one warpgroup
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int THREADS = 384;      // + one producer warpgroup
constexpr int SMEM_ALIGN = 1024;
constexpr int BAR_CONSUMERS = 1;  // the consumers' named barrier

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// First SMEM_ALIGN-aligned byte of dynamic shared memory (SMEM_ALIGN extra
// requested).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((SMEM_ALIGN - (a % SMEM_ALIGN)) % SMEM_ALIGN);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Barrier inits visible to TMA; the caller then syncs the block.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
    "{\n.reg .pred p;\n"
    "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
    "selp.u32 %0, 1, 0, p;\n}\n"
    : "=r"(done)
    : "r"(addr), "r"(parity)
    : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1ll << 35)) __trap();
}

// A 2-D TMA box [box_rows x 64] at (c0, c1) into `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
    "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
    " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
    "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
    : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma descriptor, K-major 128-byte swizzle (1024-byte aligned tile + 32 bytes
// a 16-feature slice).
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The same, 64-byte swizzle (chunk c of row r at c ^ ((r / 2) % 4)): 512-byte
// tiles and groups.
__device__ __forceinline__ uint64_t sw64_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins accumulator reads and writes against wgmma launches and waits.
template <int R>
__device__ __forceinline__ void acc_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void acc_fence(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Orders generic-proxy shared writes before async-proxy (wgmma, TMA) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// fp32 sum of squares of 8 bf16, the first `lead` as zero.
__device__ __forceinline__ float sq8(uint4 v, int lead = 0) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float lo = __uint_as_float(w[j] << 16), hi = __uint_as_float(w[j] & 0xFFFF0000u);
    if (2 * j < lead) lo = 0.0f;
    if (2 * j + 1 < lead) hi = 0.0f;
    s = fmaf(lo, lo, s);
    s = fmaf(hi, hi, s);
  }
  return s;
}

// Sum of squares of chunks [c0, c0 + n) of row `r`'s swizzled line, the first
// `lead` features zero.
template <int N>
__device__ __forceinline__ float line_sq(const unsigned char* tile, int r, int c0, int lead) {
  const unsigned char* line = tile + r * LINE_BYTES;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = c0 + i;
    const uint4 v = *reinterpret_cast<const uint4*>(line + ((c ^ (r & 7)) << 4));
    s += sq8(v, c == 0 ? lead : 0);
  }
  return s;
}

// The accumulators' asm operands: "%0, ..., %N-1" and c(d[0]), ..., c(d[N-1]).
#define SM90_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define SM90_R32 SM90_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_R64 SM90_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47" \
  ", %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_R128 SM90_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79" \
  ", %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95" \
  ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111" \
  ", %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define SM90_D8(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), c(d[i + 7])
#define SM90_D32(c, i) SM90_D8(c, i), SM90_D8(c, i + 8), SM90_D8(c, i + 16), SM90_D8(c, i + 24)
#define SM90_D128(c) SM90_D32(c, 0), SM90_D32(c, 32), SM90_D32(c, 64), SM90_D32(c, 96)

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
    SM90_R128
    "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
    : SM90_D128("+f")
    : "l"(da), "l"(db), "r"(1));
}

// scale_d = 0 ignores d's values: the product starts a fresh accumulator.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int scale_d = 1) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
    SM90_R64
    "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
    : SM90_D32("+f", 0), SM90_D32("+f", 32)
    : "l"(da), "l"(db), "r"(scale_d));
}

// The same with A (64 rows x 16 bf16) from registers in the m16n8k16 fragment
// layout.
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
    SM90_R128
    "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
    : SM90_D128("+f")
    : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
struct Wgmma;
template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db) { wgmma_m64n256k16(d, da, db); }
};
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) { wgmma_m64n128k16(d, da, db); }
};

// int8 x int8 -> exact int32, 32 features an instruction; fragments as the bf16
// ones.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
    "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
    SM90_R128
    "}, %128, %129, p;\n}\n"
    : SM90_D128("+r")
    : "l"(da), "l"(db), "r"(1));
}

// m64nNk16/k32 accumulator: thread t holds d[4 j + 2 h + c] at query row 16 (t
// / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + c.
__device__ __forceinline__ int acc_row(int t, int h) { return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * h; }
__device__ __forceinline__ int acc_col(int t, int j, int c) { return 8 * j + 2 * (t & 3) + c; }

// ---- host ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda via the runtime.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
      cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Map of a row-major [rows, cols] matrix (`stride` bytes a row, % 16; `base`
// 16-byte aligned) in [box_rows x line_bytes] boxes with that line's swizzle
// (128 or 64). Returns a cudaError_t.
inline int encode_swizzled_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
               long cols, long rows, long stride, int box_rows, int line_bytes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)(line_bytes / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             line_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline int encode_sw128_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
              long cols, long rows, long stride, int box_rows) {
  return encode_swizzled_map(map, type, elem_bytes, base, cols, rows, stride, box_rows, LINE_BYTES);
}

inline int encode_bf16_map(CUtensorMap* map, const void* base, long cols, long rows, long stride, int box_rows) {
  return encode_sw128_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols, rows, stride, box_rows);
}

// bf16 in boxes of [box_rows x 32] with the 64-byte swizzle.
inline int encode_bf16_sw64_map(CUtensorMap* map, const void* base, long cols, long rows, long stride, int box_rows) {
  return encode_swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols, rows, stride, box_rows, 64);
}

// fp32 in boxes of [box_rows x 32] with the 128-byte swizzle.
inline int encode_f32_map(CUtensorMap* map, const void* base, long cols, long rows, long stride, int box_rows) {
  return encode_sw128_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, cols, rows, stride, box_rows);
}

// int8: TMA has no signed 8-bit type; UINT8 copies the bits unchanged.
inline int encode_s8_map(CUtensorMap* map, const void* base, long cols, long rows, long stride, int box_rows) {
  return encode_sw128_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, cols, rows, stride, box_rows);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

}  // namespace sm90
