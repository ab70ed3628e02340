// Helpers for the packed-int4 matmul (K3): one warp-level int8 tensor-core
// product (mma.sync m16n8k32, int32 accumulators) and the nibble unpack.
//
// Fragment layout of m16n8k32 .s8 (g = lane / 4, t = lane % 4; each register
// holds four int8 along k, the lowest byte first):
//   A (16x32, row-major) a0: (g, 4t..4t+3)  a1: (g+8, 4t..)  a2: (g, 4t+16..)  a3: (g+8, 4t+16..)
//   B (32x8, col-major)  b0: (k 4t..4t+3, n g)  b1: (k 4t+16..4t+19, n g)
//   C (16x8, int32)      c0,c1: (g, 2t..2t+1)  c2,c3: (g+8, 2t..2t+1)
// B col-major is W4's own layout: the port stores w4 as [N, K/2], so the k
// values of one output column are contiguous.
//
// Packing (the JAX package's quantize_weight_int4, bit for bit): byte j of
// column n holds w[n, j] + 8 in its low nibble and w[n, j + K/2] in its high
// nibble, j < K/2, both in [-7, 7].
#pragma once

#include "common.cuh"

namespace physicedit {

__device__ __forceinline__ void mma_s8_16832(int c[4], const uint32_t a[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Subtract 8 from each of four bytes in [0, 15], wrapping per byte (no borrow
// crosses a byte: 0x80 | t - 8 stays in [120, 135]).
__device__ __forceinline__ uint32_t bytes_minus8(uint32_t t) {
  return ((t | 0x80808080u) - 0x08080808u) ^ 0x80808080u;
}

// Four packed bytes -> four int8 low-plane weights and four high-plane ones:
// lo = (b & 15) - 8, hi = b >> 4 (arithmetic).
__device__ __forceinline__ void unpack_w4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo = bytes_minus8(w & 0x0F0F0F0Fu);
  hi = bytes_minus8(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);
}

// The epilogue of the JAX kernel in its order, each step rounded in fp32:
// acc * x_scale * w_scale + b, then bf16.
__device__ __forceinline__ float w4a8_epilogue(int acc, float xs, float ws,
                                               const __nv_bfloat16* bias, int col) {
  float v = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  if (bias != nullptr) v = __fadd_rn(v, __bfloat162float(bias[col]));
  return v;
}

}  // namespace physicedit
