// Shared helpers for the attention kernels: bf16 packing, the row sums and
// maxima of a quad, and the output rows' store.
//
// Fragment layout of mma.sync m16n8k16, which the wgmma accumulators of a
// warp share (g = lane / 4, t = lane % 4):
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

// lo goes to the low 16 bits: the element with the smaller column index.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
