// Shared helpers for the attention kernels: one warp-level bf16 tensor-core
// product (mma.sync m16n8k16, fp32 accumulators) and bf16 packing.
//
// Fragment layout of m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row-major) a0: (g, 2t..2t+1)  a1: (g+8, 2t..)  a2: (g, 2t+8..)  a3: (g+8, 2t+8..)
//   B (16x8, col-major)  b0: (k 2t..2t+1, n g)  b1: (k 2t+8..2t+9, n g)
//   C (16x8)             c0,c1: (g, 2t..2t+1)  c2,c3: (g+8, 2t..2t+1)
// Two neighbouring C tiles (columns 0-7 and 8-15) are, packed to bf16, the A
// fragment of a 16-wide k chunk: that is how P stays in registers between
// the two products of attention.
#pragma once

#include "common.cuh"

namespace physicedit {

constexpr int kHeadDim = 128;
constexpr int kBlockQ = 64;               // query rows per block: 4 warps x 16
constexpr int kBlockK = 64;               // keys per tile
constexpr int kThreads = 128;
constexpr int kRowStride = kHeadDim + 8;  // bf16 per smem row: +16 B keeps the
                                          // fragment loads free of bank conflicts

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo goes to the low 16 bits: the element with the smaller column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// Copy rows [row0, row0 + 64) of a [rows, 128] bf16 matrix whose row r starts
// at base + r * row_pitch (elements) into smem with kRowStride; rows at or
// past n_rows are zero-filled.  16 bytes per thread per step.
__device__ __forceinline__ void load_tile(uint16_t* smem, const uint16_t* base,
                                          long row_pitch, int row0, int n_rows) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < (kBlockK * kHeadDim / 8) / kThreads; ++it) {
    const int idx = tid + it * kThreads;
    const int r = idx >> 4;
    const int c = (idx & 15) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(base + (long)(row0 + r) * row_pitch + c);
    }
    *reinterpret_cast<uint4*>(smem + r * kRowStride + c) = val;
  }
}

// acc[16 x 128] += P[16 x 64] (bf16, from registers) . V_tile[64 x 128].
__device__ __forceinline__ void pv_tile(float acc[16][4], const float p[8][4],
                                        const uint16_t* vs, int g, int t) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    pa[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    pa[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    pa[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    const uint16_t* v0 = vs + (16 * kc + 2 * t) * kRowStride + g;
#pragma unroll
    for (int jd = 0; jd < 16; ++jd) {
      const uint16_t* col = v0 + 8 * jd;
      const uint32_t b0 = pack_raw(col[0], col[kRowStride]);
      const uint32_t b1 = pack_raw(col[8 * kRowStride], col[9 * kRowStride]);
      mma_bf16_16816(acc[jd], pa, b0, b1);
    }
  }
}

// Sum a per-thread partial over the 4 threads that share a row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

// Write the warp's rows g and g+8 as bf16 acc / max(l, 1e-30).  off_g and
// off_g8 are the element offsets of the two output rows; a row that is not
// live (past the sequence end) is not written.  A row with l == 0 (every key
// masked) comes out as exactly 0.
__device__ __forceinline__ void store_rows(uint16_t* out, long off_g, long off_g8,
                                           bool live_g, bool live_g8,
                                           const float acc[16][4], float l_g, float l_g8,
                                           int t) {
  const float d_g = fmaxf(l_g, 1e-30f);
  const float d_g8 = fmaxf(l_g8, 1e-30f);
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (live_g)
      *reinterpret_cast<uint32_t*>(out + off_g + c) =
          pack_bf16(acc[jd][0] / d_g, acc[jd][1] / d_g);
    if (live_g8)
      *reinterpret_cast<uint32_t*>(out + off_g8 + c) =
          pack_bf16(acc[jd][2] / d_g8, acc[jd][3] / d_g8);
  }
}

}  // namespace physicedit
