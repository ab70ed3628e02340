// K3: the W4A8 matmul, y = (x_q . unpack(w4)) * x_scale * w_scale + b, with
// int8 activations, packed-int4 weights, exact int32 accumulation and a bf16
// result.
//
// Replaces physicedit_tpu/kernels/quant_matmul.py::_w4a8_kernel (M < 256) and
// ::_w4a8_kernel_i32 (otherwise), both launched from _w4a8_matmul.  Those two
// variants, their VMEM block sizes and the AND-only unpack are TPU matters;
// this file computes the same products in two regimes of its own.
//
// What bounds it on an H100:
//  - M <= 16 (the VL decode at M = 1, the DiT modulation at M = 2): reading
//    the weights, 0.5 byte each (the lm_head alone is 272 MB per token).
//    Design: one warp per output column; each lane reads 16 packed bytes
//    (32 weights) per step with one 128-bit load, unpacks them in registers
//    and multiplies them against the x_lo and x_hi halves with __dp4a.  x is
//    at most 16 rows and stays in L1.
//  - M > 16 (the DiT text stream, the VL prefill and prompt encode, the ViT):
//    the int8 tensor cores.  Design: 128 x 128 output tiles, 8 warps of
//    32 x 64, mma.sync m16n8k32 s8; each step stages 64 packed bytes of k,
//    unpacked into separate low- and high-plane int8 tiles in shared memory,
//    against the two matching 64-byte slices of x (k and k + K/2); the next
//    step's global loads are issued before the current step's products.  Not
//    done yet: wgmma, TMA, a multi-stage pipeline.
// Both regimes end in the JAX epilogue order (mma_int8.cuh).  An optional
// int32 output receives the raw accumulators, so a check can hold them
// against an exact product.
#include "mma_int8.cuh"

using namespace physicedit;

namespace {

constexpr int kGemvWarps = 8;
constexpr int kMaxGemvRows = 16;

template <int MT>
__global__ void __launch_bounds__(kGemvWarps * 32)
w4a8_gemv_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w4,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int* __restrict__ acc_out, int m, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  if (col >= n) return;
  const int k2 = k >> 1;
  const int8_t* wcol = w4 + (long)col * k2;
  int acc[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) acc[r] = 0;

  for (int j = lane * 16; j < k2; j += 32 * 16) {
    const int4 wv = __ldg(reinterpret_cast<const int4*>(wcol + j));
    uint32_t lo[4], hi[4];
    unpack_w4(static_cast<uint32_t>(wv.x), lo[0], hi[0]);
    unpack_w4(static_cast<uint32_t>(wv.y), lo[1], hi[1]);
    unpack_w4(static_cast<uint32_t>(wv.z), lo[2], hi[2]);
    unpack_w4(static_cast<uint32_t>(wv.w), lo[3], hi[3]);
#pragma unroll
    for (int r = 0; r < MT; ++r) {
      if (r < m) {
        const int8_t* xr = xq + (long)r * k + j;
        const int4 xl = __ldg(reinterpret_cast<const int4*>(xr));
        const int4 xh = __ldg(reinterpret_cast<const int4*>(xr + k2));
        int a = acc[r];
        a = __dp4a(static_cast<int>(lo[0]), xl.x, a);
        a = __dp4a(static_cast<int>(lo[1]), xl.y, a);
        a = __dp4a(static_cast<int>(lo[2]), xl.z, a);
        a = __dp4a(static_cast<int>(lo[3]), xl.w, a);
        a = __dp4a(static_cast<int>(hi[0]), xh.x, a);
        a = __dp4a(static_cast<int>(hi[1]), xh.y, a);
        a = __dp4a(static_cast<int>(hi[2]), xh.z, a);
        a = __dp4a(static_cast<int>(hi[3]), xh.w, a);
        acc[r] = a;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    int a = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == r && r < m) {
      const long o = (long)r * n + col;
      out[o] = __float2bfloat16_rn(w4a8_epilogue(a, xs[r], ws[col], bias, col));
      if (acc_out != nullptr) acc_out[o] = a;
    }
  }
}

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBKP = 64;             // packed bytes of k per step (64 low + 64 high k)
constexpr int kTiledThreads = 256;
constexpr int kSmemRow = kBKP + 16;  // bytes per smem row: 80 keeps the fragment
                                     // loads of a warp on 32 distinct banks

__global__ void __launch_bounds__(kTiledThreads)
w4a8_tiled_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w4,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                  int* __restrict__ acc_out, int m, int n, int k) {
  __shared__ __align__(16) int8_t a_lo[kBM * kSmemRow];
  __shared__ __align__(16) int8_t a_hi[kBM * kSmemRow];
  __shared__ __align__(16) int8_t b_lo[kBN * kSmemRow];
  __shared__ __align__(16) int8_t b_hi[kBN * kSmemRow];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp & 3) * 32;   // the warp's rows within the tile
  const int wn = (warp >> 2) * 64;  // and its columns
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k2 = k >> 1;

  // Global -> register staging: each thread moves two 16-byte chunks of each
  // of the three tiles (x low half, x high half, packed w) per step.
  int4 rx_lo[2], rx_hi[2], rw[2];
  auto load_global = [&](int j0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kTiledThreads;
      const int r = c >> 2;
      const int cc = (c & 3) * 16;
      const int row = m0 + r;
      if (row < m) {
        const int8_t* xr = xq + (long)row * k + j0 + cc;
        rx_lo[i] = __ldg(reinterpret_cast<const int4*>(xr));
        rx_hi[i] = __ldg(reinterpret_cast<const int4*>(xr + k2));
      } else {
        rx_lo[i] = rx_hi[i] = make_int4(0, 0, 0, 0);
      }
      rw[i] = __ldg(reinterpret_cast<const int4*>(w4 + (long)(n0 + r) * k2 + j0 + cc));
    }
  };
  auto store_smem = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kTiledThreads;
      const int off = (c >> 2) * kSmemRow + (c & 3) * 16;
      *reinterpret_cast<int4*>(a_lo + off) = rx_lo[i];
      *reinterpret_cast<int4*>(a_hi + off) = rx_hi[i];
      uint32_t lo[4], hi[4];
      unpack_w4(static_cast<uint32_t>(rw[i].x), lo[0], hi[0]);
      unpack_w4(static_cast<uint32_t>(rw[i].y), lo[1], hi[1]);
      unpack_w4(static_cast<uint32_t>(rw[i].z), lo[2], hi[2]);
      unpack_w4(static_cast<uint32_t>(rw[i].w), lo[3], hi[3]);
      *reinterpret_cast<uint4*>(b_lo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(b_hi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  };

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  load_global(0);
  for (int j0 = 0; j0 < k2; j0 += kBKP) {
    store_smem();
    __syncthreads();
    if (j0 + kBKP < k2) load_global(j0 + kBKP);
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const int8_t* as = plane ? a_hi : a_lo;
      const int8_t* bs = plane ? b_hi : b_lo;
#pragma unroll
      for (int ks = 0; ks < kBKP; ks += 32) {
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int8_t* r0 = as + (wm + mt * 16 + g) * kSmemRow + ks + 4 * t;
          const int8_t* r8 = r0 + 8 * kSmemRow;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(r8);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int8_t* bc = bs + (wn + nt * 8 + g) * kSmemRow + ks + 4 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bc);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bc + 16);
          mma_s8_16832(acc[0][nt], af[0], b0, b1);
          mma_s8_16832(acc[1][nt], af[1], b0, b1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mt * 16 + g + 8 * half;
      if (row >= m) continue;
      const float xsr = xs[row];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn + nt * 8 + 2 * t;
        const int a0 = acc[mt][nt][2 * half];
        const int a1 = acc[mt][nt][2 * half + 1];
        const long o = (long)row * n + col;
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(
            w4a8_epilogue(a0, xsr, ws[col], bias, col),
            w4a8_epilogue(a1, xsr, ws[col + 1], bias, col + 1));
        if (acc_out != nullptr) *reinterpret_cast<int2*>(acc_out + o) = make_int2(a0, a1);
      }
    }
  }
}

template <int MT>
cudaError_t launch_gemv(const int8_t* xq, const int8_t* w4, const float* xs, const float* ws,
                        const __nv_bfloat16* bias, __nv_bfloat16* out, int* acc_out, int m,
                        int n, int k, cudaStream_t stream) {
  const dim3 grid((n + kGemvWarps - 1) / kGemvWarps);
  w4a8_gemv_kernel<MT><<<grid, kGemvWarps * 32, 0, stream>>>(xq, w4, xs, ws, bias, out,
                                                              acc_out, m, n, k);
  return cudaGetLastError();
}

}  // namespace

// x_q int8 [M, K], w4 int8 [N, K/2] (the packing above), x_scale fp32 [M],
// w_scale fp32 [N], bias bf16 [N] or null, out bf16 [M, N], acc_out int32
// [M, N] or null; all contiguous.  K/2 % 128 == 0 and N % 128 == 0 (the
// contract of the JAX kernel; the wrapper checks it).  Returns
// cudaGetLastError() after the launch.
extern "C" int w4a8_matmul_bf16(const void* xq, const void* w4, const void* xs,
                                const void* ws, const void* bias, void* out, void* acc_out,
                                int m, int n, int k, void* stream) {
  const auto* x = static_cast<const int8_t*>(xq);
  const auto* w = static_cast<const int8_t*>(w4);
  const auto* xsp = static_cast<const float*>(xs);
  const auto* wsp = static_cast<const float*>(ws);
  const auto* b = static_cast<const __nv_bfloat16*>(bias);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* a = static_cast<int*>(acc_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (m <= kMaxGemvRows) {
    if (m <= 1) return static_cast<int>(launch_gemv<1>(x, w, xsp, wsp, b, o, a, m, n, k, s));
    if (m <= 2) return static_cast<int>(launch_gemv<2>(x, w, xsp, wsp, b, o, a, m, n, k, s));
    if (m <= 4) return static_cast<int>(launch_gemv<4>(x, w, xsp, wsp, b, o, a, m, n, k, s));
    if (m <= 8) return static_cast<int>(launch_gemv<8>(x, w, xsp, wsp, b, o, a, m, n, k, s));
    return static_cast<int>(launch_gemv<16>(x, w, xsp, wsp, b, o, a, m, n, k, s));
  }
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  w4a8_tiled_kernel<<<grid, kTiledThreads, 0, s>>>(x, w, xsp, wsp, b, o, a, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
