// The Hopper primitives that the hand-written kernels share: mbarriers, TMA
// loads and stores and the tensor maps they use, a cluster's barrier and
// shared-memory reads, named barriers, cp.async, the wgmma descriptor,
// fence, commit and wait, and the register fences that keep the compiler off
// the registers an issued wgmma still reads or writes.  The attention
// mainloop (hopper_attention.cuh: K1, K2, K7, K8, K10), the W4 GEMMs
// (w4a8_matmul.cu: K3, w4_bwd_dx.cu: K9) and T9's, T10's and T12's GEMMs and
// T11's GEMV (proto_int8_matmul.cu) are built from them; the products that
// only the GEMMs and T4's int8 Q K^T take (int8 and 256-wide bf16 wgmma, A
// from registers or from shared memory) are here too.
//
// The tensor maps are built on the host each call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPointByVersion
// (cudaGetDriverEntryPoint before CUDA 12.5; no link flag: the libraries
// link nothing beyond the runtime), and passed as __grid_constant__ kernel
// parameters, so a CUDA graph captures them by value.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace physicedit {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed.  A fresh barrier
// counts its phase before phase 0 (parity 1) as completed, so a producer's
// first wait on an empty barrier passes.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// A contiguous copy of bytes (a multiple of 16; dst and src 16-byte aligned)
// from global to shared memory, which completes its bytes on bar: the bulk
// form of TMA, no tensor map.
__device__ __forceinline__ void bulk_load_1d(uint32_t dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A TMA store of one box from shared memory (the layout of the map's
// swizzle) to the tensor at (c0, c1); elements out of bounds are not
// written.  It joins this thread's current bulk group (bulk_commit).
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's bulk groups still read shared
// memory (their source may then be written again).
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// Wait until this thread's bulk groups have completed (their writes done).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory writes of this thread, made by ordinary stores, become
// visible to the async proxy (wgmma's operand reads, TMA) that a barrier
// later lets at them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- thread-block clusters ---------------------------------------------------

// This block's rank in its cluster (0 for a launch without clusters).
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives and waits: shared-memory
// writes before it are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 32-bit word at this block's shared address addr in the shared memory of
// the cluster's block of rank `rank` (distributed shared memory).
__device__ __forceinline__ uint32_t ld_cluster_u32(uint32_t addr, uint32_t rank) {
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// ---- named barriers (the consumers' ping-pong) -------------------------------

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- cp.async (asynchronous copies into shared memory) ---------------------

// Each copies src_bytes of src to dst and zero-fills the rest of its size (16
// or 4 bytes); with src_bytes 0 nothing is read.  cp_async_16 caches in L2
// only and needs dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies; their bytes are then visible to it.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units; base offset 0 (every tile
// starts on a 1024-byte boundary).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keep the compiler from reading or moving registers that an issued wgmma
// still reads or writes: a no-op that claims to modify each one.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The GEMMs' accumulators: K3's int32 (64 a thread), K9's fp32 (128), T9's
// int32 or fp32 (128).
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define PE_OUT8(c, b)                                                                    \
  "+" c(d[(b) + 0]), "+" c(d[(b) + 1]), "+" c(d[(b) + 2]), "+" c(d[(b) + 3]),             \
      "+" c(d[(b) + 4]), "+" c(d[(b) + 5]), "+" c(d[(b) + 6]), "+" c(d[(b) + 7])
#define PE_OUT32(c, b) PE_OUT8(c, b), PE_OUT8(c, (b) + 8), PE_OUT8(c, (b) + 16), PE_OUT8(c, (b) + 24)
#define PE_OUT64(c) PE_OUT32(c, 0), PE_OUT32(c, 32)
#define PE_OUT128(c) PE_OUT32(c, 0), PE_OUT32(c, 32), PE_OUT32(c, 64), PE_OUT32(c, 96)
#define PE_REGS64                                                                         \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define PE_REGS128                                                                        \
  PE_REGS64 ", "                                                                          \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "      \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "      \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "      \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "  \
  "%124, %125, %126, %127"

// D[64 x 128] += A[64 x 32] . B[128 x 32]^T in int8 with exact int32 sums,
// A from registers (per warp the layout of mma.sync's m16n8k32 A fragment:
// a0 row g, k 4t..4t+3; a1 row g+8; a2 row g, k 16+4t..; a3 both), B K-major
// in shared memory (int8 wgmma takes K-major operands only).  Accumulator
// layout as the bf16 products': d[4 n + 2 i + j] is row 16 w + g + 8 i,
// column 8 n + 2 t + j.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                            uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" PE_REGS64
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : PE_OUT64("r")
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T in int8 with exact int32 sums,
// A and B K-major in shared memory (128-byte swizzle): T4's int8 Q K^T.
// scale_d 0 overwrites D.  Accumulator layout as wgmma_s8_rs's.
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" PE_REGS64
      "}, %64, %65, p;\n}\n"
      : PE_OUT64("r")
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256] in bf16 with fp32 sums, A from
// registers (mma.sync's m16n8k16 A fragment per warp), B MN-major in shared
// memory: four 64-column boxes with the 128-byte swizzle, lbo bytes apart.
__device__ __forceinline__ void wgmma_bf16_rs_n256(float (&d)[128], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" PE_REGS128
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : PE_OUT128("f")
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

// D[64 x 256] += A[64 x 32] . B[256 x 32]^T in int8 with exact int32 sums,
// A and B K-major in shared memory (128-byte swizzle, as sw128_desc
// describes them): T9's i32 GEMM.  Accumulator layout as above, n < 32.
__device__ __forceinline__ void wgmma_s8_ss_n256(int (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" PE_REGS128
      "}, %128, %129, p;\n}\n"
      : PE_OUT128("r")
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[256 x 16]^T in bf16 with fp32 sums, A and B
// K-major in shared memory: T9's f32 GEMM.
__device__ __forceinline__ void wgmma_bf16_ss_n256(float (&d)[128], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" PE_REGS128
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : PE_OUT128("f")
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#undef PE_REGS128
#undef PE_REGS64
#undef PE_OUT128
#undef PE_OUT64
#undef PE_OUT32
#undef PE_OUT8

// ---- shared memory by address ------------------------------------------------

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void sts64(uint32_t addr, uint32_t lo, uint32_t hi) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(lo), "r"(hi) : "memory");
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// ---- host: tensor maps -----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a row-major [rows, cols] matrix whose rows lie pitch
// bytes apart (a multiple of 16, as is the base address): boxes of box_cols
// x box_rows elements, zero fill past the edges; false if
// cuTensorMapEncodeTiled refuses it.
inline bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                        uint64_t cols, uint64_t rows, uint64_t pitch, uint32_t box_cols,
                        uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The number of SMs of the current device, read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

}  // namespace hopper
}  // namespace physicedit
