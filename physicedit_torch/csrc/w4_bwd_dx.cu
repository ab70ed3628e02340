// K9: the input gradient of the W4A8 linear, dx = bf16(g * w_scale) .
// unpack(w4)^T, straight through the activation quantizer (the weights are
// frozen and take no gradient).
//
// Replaces physicedit_tpu/kernels/quant_matmul.py::_w4_bwd_dx_kernel
// (launched from _w4_bwd_dx in _w4a8_linear_bwd).  The port stores the
// packed weights as w4 [N, K/2] (K3's layout): byte j of output column n
// holds w[j, n] + 8 in its low nibble and w[j + K/2, n] in its high nibble,
// so dx[:, j] takes the low plane (b & 15) - 8 and dx[:, j + K/2] the high
// plane b >> 4 (arithmetic, on the signed byte); both are exact in bf16.
// g2 = bf16(fp32(g) * w_scale) is formed as the g tile is staged, rounded
// after the multiply as the JAX wrapper rounds it.
//
// What bounds it on an H100: 2 * M * N * K operations over the bytes of g
// (M * N * 2), w4 (N * K / 2) and dx (M * K * 2).  At the DiT's training
// shapes (M = 1,560 image or ~128-256 text tokens, K and N of 3072 to
// 12288) the image stream is above the ~295 FLOP/byte ridge (tensor cores)
// and the text stream near or below it.  Design: one block of 4 warps per
// (64 rows of dx, 64 packed columns j); it writes dx columns j and j + K/2
// straight into their places (no concatenate).  Per step of 64 n it stages
// the g2 tile and both unpacked weight planes as bf16 in shared memory, and
// each warp runs 16 rows x (64 low + 64 high) columns on bf16 mma.sync
// m16n8k16 with fp32 accumulators.  Not done yet: TMA, wgmma, a multi-stage
// pipeline, unpacking in registers.
#include "mma_bf16.cuh"

using namespace physicedit;

namespace {

constexpr int kBM = 64;               // dx rows per block: 4 warps x 16
constexpr int kBJ = 64;               // packed columns per block (x2 planes)
constexpr int kBN = 64;               // contraction (n) per step
constexpr int kGStride = kBN + 8;     // bf16 per smem row of the g2 tile
constexpr int kWStride = kBJ + 8;     // bf16 per smem row of a weight plane

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_value(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__global__ void __launch_bounds__(kThreads)
w4_bwd_dx_kernel(const uint16_t* __restrict__ gr, const int8_t* __restrict__ w4,
                 const float* __restrict__ ws, uint16_t* __restrict__ dx, int m, int n, int k) {
  __shared__ __align__(16) uint16_t gs[kBM * kGStride];  // g2 [row][n]
  __shared__ __align__(16) uint16_t wl[kBN * kWStride];  // low plane [n][j]
  __shared__ __align__(16) uint16_t wh[kBN * kWStride];  // high plane [n][j]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const int m0 = blockIdx.y * kBM;
  const int j0 = blockIdx.x * kBJ;
  const int k2 = k >> 1;

  float acc[2][8][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) acc[p][jt][0] = acc[p][jt][1] = acc[p][jt][2] = acc[p][jt][3] = 0.f;

  for (int n0 = 0; n0 < n; n0 += kBN) {
    // g2 tile: 64 rows x 64 n, 8 values per chunk, 4 chunks per thread
#pragma unroll
    for (int it = 0; it < kBM * kBN / 8 / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx >> 3;
      const int c = (idx & 7) * 8;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) raw = *reinterpret_cast<const uint4*>(gr + (long)(m0 + r) * n + n0 + c);
      const float4 s0 = *reinterpret_cast<const float4*>(ws + n0 + c);
      const float4 s1 = *reinterpret_cast<const float4*>(ws + n0 + c + 4);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = pack_bf16(bf16_value(w[i] & 0xffffu) * sc[2 * i],
                         bf16_value(w[i] >> 16) * sc[2 * i + 1]);
      }
      *reinterpret_cast<uint4*>(gs + r * kGStride + c) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    // weight tile: 64 n x 64 packed bytes, 16 bytes per chunk, 2 per thread
#pragma unroll
    for (int it = 0; it < kBN * kBJ / 16 / kThreads; ++it) {
      const int idx = tid + it * kThreads;
      const int r = idx >> 2;
      const int c = (idx & 3) * 16;
      const int4 raw = *reinterpret_cast<const int4*>(w4 + (long)(n0 + r) * k2 + j0 + c);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b0 = b[2 * i], b1 = b[2 * i + 1];
        lo[i] = pack_raw(bf16_bits(static_cast<float>((b0 & 15) - 8)),
                         bf16_bits(static_cast<float>((b1 & 15) - 8)));
        hi[i] = pack_raw(bf16_bits(static_cast<float>(b0 >> 4)),
                         bf16_bits(static_cast<float>(b1 >> 4)));
      }
      uint16_t* lrow = wl + r * kWStride + c;
      uint16_t* hrow = wh + r * kWStride + c;
      *reinterpret_cast<uint4*>(lrow) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(lrow + 8) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      *reinterpret_cast<uint4*>(hrow) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(hrow + 8) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      uint32_t a[4];
      const uint16_t* r0 = gs + (wr + g) * kGStride + kc * 16 + 2 * t;
      const uint16_t* r1 = r0 + 8 * kGStride;
      a[0] = *reinterpret_cast<const uint32_t*>(r0);
      a[1] = *reinterpret_cast<const uint32_t*>(r1);
      a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint16_t* plane = (p ? wh : wl) + (16 * kc + 2 * t) * kWStride + g;
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
          const uint16_t* col = plane + 8 * jt;
          const uint32_t b0 = pack_raw(col[0], col[kWStride]);
          const uint32_t b1 = pack_raw(col[8 * kWStride], col[9 * kWStride]);
          mma_bf16_16816(acc[p][jt], a, b0, b1);
        }
      }
    }
    __syncthreads();
  }

  const int rg = m0 + wr + g;
  const int rg8 = rg + 8;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const int col = p * k2 + j0 + 8 * jt + 2 * t;
      if (rg < m)
        *reinterpret_cast<uint32_t*>(dx + (long)rg * k + col) =
            pack_bf16(acc[p][jt][0], acc[p][jt][1]);
      if (rg8 < m)
        *reinterpret_cast<uint32_t*>(dx + (long)rg8 * k + col) =
            pack_bf16(acc[p][jt][2], acc[p][jt][3]);
    }
  }
}

}  // namespace

// g bf16 [M, N], w4 int8 [N, K/2] (K3's packing), w_scale fp32 [N], dx bf16
// [M, K]; all contiguous.  K/2 % 128 == 0 and N % 128 == 0 (the contract of
// the JAX kernel; the wrapper checks it).  Returns cudaGetLastError().
extern "C" int w4_bwd_dx_bf16(const void* g, const void* w4, const void* w_scale, void* dx,
                              int m, int n, int k, void* stream) {
  const dim3 grid((k / 2) / kBJ, (m + kBM - 1) / kBM);
  w4_bwd_dx_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(g), static_cast<const int8_t*>(w4),
      static_cast<const float*>(w_scale), static_cast<uint16_t*>(dx), m, n, k);
  return static_cast<int>(cudaGetLastError());
}
