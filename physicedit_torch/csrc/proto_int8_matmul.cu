// The int8 and W4 matmul probes of tools/: one templated tiled tensor-core
// kernel and one decode GEMV.
//
// Replaces the Pallas prototypes that the measurement tools in tools/ drive
// (their ports are physicedit_torch/tools/proto_*.py):
//   T9   tools/proto_int8_rate.py::pallas_mm (body _mm_kernel): acc "i32" is
//        int8 x [M, K] . int8 w -> int32, exact (kI8); acc "f32" the same
//        product on bf16 inputs with fp32 sums and a bf16 result (kBf16)
//   T10  tools/proto_prefill_blocks.py::i32_matmul (body _i32_kernel): W4A8
//        with the sign-extending unpack, lo = (b & 15) - 8, hi = b >> 4, into
//        one int32 accumulator (kW4Unpack; K3's unpack_w4)
//   T12  tools/proto_w4_unpack.py::w4a8_i8_matmul (body _w4a8_i8_kernel):
//        W4A8 with the AND-only unpack, t = b & 0x0F (lo + 8) and
//        h16 = b & 0xF0 (16 hi, a valid int8), into two accumulators,
//        combined as acc - rs + (acc16 >> 4) with rs = 8 rowsum(x_lo)
//        (kW4AndOnly; acc16 is a multiple of 16, so the shift is exact)
//   T11  tools/proto_w4_gemv.py::gemv_and_only (body _gemv_kernel): T12's
//        integer part over m <= 8 decode rows, int32 out
// The W4 forms end in the JAX epilogue, acc * x_scale * wsb[0] + wsb[1] in
// fp32, each step rounded (no FMA contraction), then fp32, bf16 or int8 (JAX's
// conversion: truncate toward 0 and saturate).
//
// Layouts (the port's, not the JAX tools'): x [M, K] row-major; T9's w is
// [N, K] and the W4 weights are K3's w4 [N, K/2] (csrc/mma_int8.cuh), so that
// one output column's k values are contiguous: B column-major, as mma.sync
// takes it.  Byte j of column n holds w[n, j] + 8 in its low nibble and
// w[n, j + K/2] in its high nibble.
//
// What bounds them on an H100:
//  - the tiled forms (T9 at M16384 K3072 N12288: 1.24e12 operations over
//    0.23 GB, T10 / T12 at the VL prefill and DiT image shapes): the tensor
//    cores, 1,979 TOP/s int8 and 989 TFLOP/s bf16.  Design: the mma.sync
//    tiling K3's tiled regime ran before its TMA + wgmma GEMM
//    (w4a8_matmul.cu): 128 x 128 output tiles, 8 warps of 32 x 64,
//    mma.sync m16n8k32 s8 (or m16n8k16 bf16, which takes the same 32 bytes of
//    k per product with the same fragment byte offsets); each step stages two
//    64-byte "planes" of k per row in shared memory (k and k + 64 bytes for
//    T9, k and k + K/2 for the W4 forms, whose single packed tile is unpacked
//    into the two planes), the next step's global loads issued before this
//    step's products.  The AND-only form carries a second accumulator array
//    (64 more registers).  Not done: wgmma, TMA, a multi-stage pipeline.
//  - the GEMV (T11, weights 0.5 byte each, 10-68 MB per call): reading the
//    weights at 3.35 TB/s.  Design: K3's GEMV regime: one warp per output
//    column, one 128-bit weight load per lane per step (32 weights), __dp4a
//    against the x_lo and x_hi halves, two accumulators per row.
#include "mma_bf16.cuh"
#include "mma_int8.cuh"

using namespace physicedit;

namespace {

// template arguments are ints so that they mangle as Li<n>E, which
// chip_smoke.py reads out of the ptxas report
constexpr int kI8 = 0, kBf16 = 1, kW4Unpack = 2, kW4AndOnly = 3;
constexpr int kOutF32 = 0, kOutBf16 = 1, kOutI8 = 2;  // the W4 forms' out_code

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kPlane = 64;            // bytes of k per plane per step
constexpr int kMmThreads = 256;
constexpr int kSmemRow = kPlane + 16;  // 80 bytes a row keeps a warp's fragment
                                       // loads on 32 distinct banks
constexpr int kGemvWarps = 8;
constexpr int kGemvRows = 8;           // the tool's padded decode rows

template <int kKind> struct Acc { using type = int; };
template <> struct Acc<kBf16> { using type = float; };

__device__ __forceinline__ void mma(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  mma_s8_16832(c, a, b0, b1);
}
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  mma_bf16_16816(c, a, b0, b1);
}

// The AND-only unpack of four packed bytes: lo + 8 and 16 * hi, each a byte.
__device__ __forceinline__ void unpack_and_only(uint32_t w, uint32_t& t, uint32_t& h16) {
  t = w & 0x0F0F0F0Fu;
  h16 = w & 0xF0F0F0F0u;
}

// The W4 epilogue: acc * x_scale * w_scale + w_bias, each step rounded in fp32.
__device__ __forceinline__ float w4_epilogue(int acc, float xs, float ws, float wb) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), wb);
}

// JAX's float -> int8: truncate toward 0, saturate.
__device__ __forceinline__ int8_t to_int8_sat(float v) {
  return static_cast<int8_t>(__float2int_rz(fminf(fmaxf(v, -128.f), 127.f)));
}

template <int kKind>
__global__ void __launch_bounds__(kMmThreads)
tiled_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
             const float* __restrict__ xs, const float* __restrict__ wsb,
             const int* __restrict__ rs, void* __restrict__ out, int* __restrict__ acc_out,
             int out_code, int m, int n, int k) {
  constexpr bool kW4 = kKind == kW4Unpack || kKind == kW4AndOnly;
  constexpr int kElem = kKind == kBf16 ? 2 : 1;  // bytes per x and w element
  using AccT = typename Acc<kKind>::type;
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
  // bytes: an x row, a w row (w4: K/2), the second plane's offset in an x row,
  // and the bytes of an x row that one step consumes
  const long a_pitch = (long)k * kElem;
  const long b_pitch = kW4 ? k / 2 : (long)k * kElem;
  const long plane1 = kW4 ? k / 2 : kPlane;
  const int step = kW4 ? kPlane : 2 * kPlane;
  const long steps_end = kW4 ? k / 2 : a_pitch;

  // Global -> register staging: each thread moves two 16-byte chunks of each
  // plane of x and of w (of the packed w4 tile for the W4 forms) per step.
  int4 rx_lo[2], rx_hi[2], rw_lo[2], rw_hi[2];
  auto load_global = [&](long j0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kMmThreads;
      const int r = c >> 2;
      const int cc = (c & 3) * 16;
      const int row = m0 + r;
      if (row < m) {
        const int8_t* xr = xq + row * a_pitch + j0 + cc;
        rx_lo[i] = __ldg(reinterpret_cast<const int4*>(xr));
        rx_hi[i] = __ldg(reinterpret_cast<const int4*>(xr + plane1));
      } else {
        rx_lo[i] = rx_hi[i] = make_int4(0, 0, 0, 0);
      }
      const int8_t* wr = w + (n0 + r) * b_pitch + j0 + cc;
      rw_lo[i] = __ldg(reinterpret_cast<const int4*>(wr));
      if constexpr (!kW4) rw_hi[i] = __ldg(reinterpret_cast<const int4*>(wr + kPlane));
    }
  };
  auto store_smem = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kMmThreads;
      const int off = (c >> 2) * kSmemRow + (c & 3) * 16;
      *reinterpret_cast<int4*>(a_lo + off) = rx_lo[i];
      *reinterpret_cast<int4*>(a_hi + off) = rx_hi[i];
      if constexpr (kW4) {
        const uint32_t p[4] = {static_cast<uint32_t>(rw_lo[i].x), static_cast<uint32_t>(rw_lo[i].y),
                               static_cast<uint32_t>(rw_lo[i].z), static_cast<uint32_t>(rw_lo[i].w)};
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (kKind == kW4Unpack) unpack_w4(p[q], lo[q], hi[q]);
          else unpack_and_only(p[q], lo[q], hi[q]);
        }
        *reinterpret_cast<uint4*>(b_lo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(b_hi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      } else {
        *reinterpret_cast<int4*>(b_lo + off) = rw_lo[i];
        *reinterpret_cast<int4*>(b_hi + off) = rw_hi[i];
      }
    }
  };

  AccT acc[2][8][4];
  int acc16[2][8][4];  // the AND-only form's high plane
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0;
        acc16[mt][nt][e] = 0;
      }

  load_global(0);
  for (long j0 = 0; j0 < steps_end; j0 += step) {
    store_smem();
    __syncthreads();
    if (j0 + step < steps_end) load_global(j0 + step);
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      const int8_t* as = plane ? a_hi : a_lo;
      const int8_t* bs = plane ? b_hi : b_lo;
#pragma unroll
      for (int ks = 0; ks < kPlane; ks += 32) {
        // 32 bytes of k: 32 int8 (m16n8k32) or 16 bf16 (m16n8k16), whose A
        // and B fragments sit at the same byte offsets
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
          if (kKind == kW4AndOnly && plane == 1) {
            mma_s8_16832(acc16[0][nt], af[0], b0, b1);
            mma_s8_16832(acc16[1][nt], af[1], b0, b1);
          } else {
            mma(acc[0][nt], af[0], b0, b1);
            mma(acc[1][nt], af[1], b0, b1);
          }
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
      float xsr = 0.f;
      int rsr = 0;
      if constexpr (kW4) xsr = xs[row];
      if constexpr (kKind == kW4AndOnly) rsr = rs[row];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = n0 + wn + nt * 8 + 2 * t;
        const long o = (long)row * n + col;
        const AccT a0 = acc[mt][nt][2 * half];
        const AccT a1 = acc[mt][nt][2 * half + 1];
        if constexpr (kKind == kI8) {
          *reinterpret_cast<int2*>(static_cast<int*>(out) + o) = make_int2(a0, a1);
        } else if constexpr (kKind == kBf16) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(a0, a1);
        } else {
          int v0 = a0, v1 = a1;
          if constexpr (kKind == kW4AndOnly) {
            v0 = a0 - rsr + (acc16[mt][nt][2 * half] >> 4);
            v1 = a1 - rsr + (acc16[mt][nt][2 * half + 1] >> 4);
          }
          if (acc_out != nullptr) *reinterpret_cast<int2*>(acc_out + o) = make_int2(v0, v1);
          const float f0 = w4_epilogue(v0, xsr, wsb[col], wsb[n + col]);
          const float f1 = w4_epilogue(v1, xsr, wsb[col + 1], wsb[n + col + 1]);
          if (out_code == kOutF32) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(f0, f1);
          } else if (out_code == kOutBf16) {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
                __floats2bfloat162_rn(f0, f1);
          } else {
            char2 pair;
            pair.x = to_int8_sat(f0);
            pair.y = to_int8_sat(f1);
            *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o) = pair;
          }
        }
      }
    }
  }
}

template <int kRows>
__global__ void __launch_bounds__(kGemvWarps * 32)
gemv_and_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w4,
                const int* __restrict__ rs, int* __restrict__ out, int m, int n, int k) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kGemvWarps + (threadIdx.x >> 5);
  if (col >= n) return;
  const int k2 = k >> 1;
  const int8_t* wcol = w4 + (long)col * k2;
  int acc[kRows], acc16[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = acc16[r] = 0;

  for (int j = lane * 16; j < k2; j += 32 * 16) {
    const int4 wv = __ldg(reinterpret_cast<const int4*>(wcol + j));
    uint32_t lo[4], hi[4];
    unpack_and_only(static_cast<uint32_t>(wv.x), lo[0], hi[0]);
    unpack_and_only(static_cast<uint32_t>(wv.y), lo[1], hi[1]);
    unpack_and_only(static_cast<uint32_t>(wv.z), lo[2], hi[2]);
    unpack_and_only(static_cast<uint32_t>(wv.w), lo[3], hi[3]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < m) {
        const int8_t* xr = xq + (long)r * k + j;
        const int4 xl = __ldg(reinterpret_cast<const int4*>(xr));
        const int4 xh = __ldg(reinterpret_cast<const int4*>(xr + k2));
        int a = acc[r], a16 = acc16[r];
        a = __dp4a(static_cast<int>(lo[0]), xl.x, a);
        a = __dp4a(static_cast<int>(lo[1]), xl.y, a);
        a = __dp4a(static_cast<int>(lo[2]), xl.z, a);
        a = __dp4a(static_cast<int>(lo[3]), xl.w, a);
        a16 = __dp4a(static_cast<int>(hi[0]), xh.x, a16);
        a16 = __dp4a(static_cast<int>(hi[1]), xh.y, a16);
        a16 = __dp4a(static_cast<int>(hi[2]), xh.z, a16);
        a16 = __dp4a(static_cast<int>(hi[3]), xh.w, a16);
        acc[r] = a;
        acc16[r] = a16;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int a = acc[r], a16 = acc16[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      a16 += __shfl_xor_sync(0xffffffffu, a16, off);
    }
    if (lane == r && r < m) out[(long)r * n + col] = a - rs[r] + (a16 >> 4);
  }
}

template <int kKind>
int launch_tiled(const void* x, const void* w, const void* xs, const void* wsb, const void* rs,
                 void* out, void* acc_out, int out_code, int m, int n, int k,
                 cudaStream_t stream) {
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  tiled_kernel<kKind><<<grid, kMmThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(wsb), static_cast<const int*>(rs),
      out, static_cast<int*>(acc_out), out_code, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows>
int launch_gemv(const void* x, const void* w, const void*, const void*, const void* rs, void* out,
                void*, int, int m, int n, int k, cudaStream_t stream) {
  if (m > kRows) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kGemvWarps - 1) / kGemvWarps);
  gemv_and_kernel<kRows><<<grid, kGemvWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const int*>(rs),
      static_cast<int*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] (int8; bf16 for variant 1), w [N, K] (int8; bf16 for variant 1) or
// w4 [N, K/2] (variants 2-4), all contiguous and 16-byte aligned.  x_scale
// fp32 [M] and wsb fp32 [2, N] (the W4 tiled forms), rs int32 [M] = 8 *
// rowsum(x[:, :K/2]) (variants 3 and 4), null otherwise.  out: int32 (0, 4),
// bf16 (1) or per out_code 0 fp32 / 1 bf16 / 2 int8 (2, 3), [M, N]; acc_out
// int32 [M, N] or null (2, 3: the combined integer accumulator).  The tiled
// forms take N % 128 == 0 and K % 128 == 0 (variants 0, 2, 3) or K % 64 == 0
// (variant 1); the GEMV M <= 8 and K % 32 == 0; the wrappers check it.  The
// variant ids are those of physicedit_torch/tools/_proto_int8.py's
// MATMUL_VARIANTS.
#define MM_ARGS x, w, xs, wsb, rs, out, acc_out, out_code, m, n, k, s
extern "C" int proto_int8_matmul(int variant, const void* x, const void* w, const void* xs,
                                 const void* wsb, const void* rs, void* out, void* acc_out,
                                 int out_code, int m, int n, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_tiled<kI8>(MM_ARGS);         // T9, acc "i32"
    case 1: return launch_tiled<kBf16>(MM_ARGS);       // T9, acc "f32"
    case 2: return launch_tiled<kW4Unpack>(MM_ARGS);   // T10
    case 3: return launch_tiled<kW4AndOnly>(MM_ARGS);  // T12
    case 4: return launch_gemv<kGemvRows>(MM_ARGS);    // T11
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef MM_ARGS
