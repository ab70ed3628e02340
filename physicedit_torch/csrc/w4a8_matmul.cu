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
//  - M > 16 (the DiT image and text streams, the VL prefill and prompt
//    encode, the ViT): the int8 tensor cores, 2 M N K operations against
//    M K + N K / 2 + 2 M N bytes (the DiT's fc1 at M = 16384: 1.24e12
//    operations, 0.63 ms at 1,979 TOP/s, over 0.47 GB).  Design: the Hopper
//    path of hopper_primitives.cuh, with the problem transposed,
//    out^T = unpack(w4) . x^T, so that the weights, unpacked in registers,
//    are wgmma's A operand and never go back to shared memory:
//      a persistent grid, one block of three warpgroups per SM, walks the
//      output tiles of 128 weight rows (output columns) x 128 x rows;
//      warpgroup 0, the producer (setmaxnreg.dec), one thread of which issues
//      per stage three TMA loads with the 128-byte swizzle: the x box at k
//      offset j0 and the one at K/2 + j0 of the same [M, K] map (128 rows x
//      128 bytes each), and the packed box of w4 [N, K/2] (128 rows x 128
//      bytes), into a ring of 3 stages of 48 KB that runs on from one tile
//      into the next;
//      warpgroups 1 and 2, the consumers (setmaxnreg.inc), own 64 weight rows
//      each: per stage each thread reads its A fragments of the packed box
//      (16 32-bit loads), unpacks them in registers into the low plane
//      (b & 15) - 8 and the high plane b >> 4 (unpack_w4), and issues eight
//      wgmma.mma_async m64n128k32 s32.s8.s8 products, four k-steps of each
//      plane, the low plane against the x box at j0 and the high plane
//      against the one at K/2 + j0.  The fragments are double-buffered, so
//      that a stage's products run while the next stage is unpacked
//      (wgmma.wait_group 1), and every consumer warp releases a stage once
//      its products are done.
//    Rows past M arrive as TMA's zeros and are never stored.  The epilogue
//    stages each warpgroup's int32 accumulators in a slab of its own (32
//    KB), XOR-swizzled so that neither the writes nor the reads conflict,
//    and writes out (and the optional int32 accumulators) row by row, 8
//    bytes a thread, while the producer already loads the next tile.  Tiles
//    are walked so that the smaller operand is the one re-read from L2:
//    weight tiles outer when the weights are the larger (the VL prefill's
//    gate_up, 68 MB), x tiles outer otherwise (the DiT image stream, whose x
//    is 50 MB).  Why the weights are not unpacked into shared memory and
//    both operands taken from there: the two planes written and read back
//    and the A reads of wgmma add half again to the shared-memory traffic
//    of a stage, past what the int8 products leave free (PERF.md §6).
// Both regimes end in the JAX epilogue order (mma_int8.cuh).  An optional
// int32 output receives the raw accumulators, so a check can hold them
// against an exact product.
#include "hopper_primitives.cuh"
#include "mma_bf16.cuh"
#include "mma_int8.cuh"

using namespace physicedit;
using namespace physicedit::hopper;

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

// ---- the tiled regime --------------------------------------------------------

constexpr int kBM = 128;            // x rows (output rows) per tile
constexpr int kBN = 128;            // weight rows (output columns) per tile
constexpr int kKStep = 128;         // packed bytes per stage: 128 low + 128 high k
constexpr int kStages = 3;
constexpr int kXBox = kBM * kKStep;            // one x box: 16 KB
constexpr int kWBox = kBN * kKStep;            // the packed box: 16 KB
constexpr int kStageBytes = 2 * kXBox + kWBox;
constexpr int kRing = kStages * kStageBytes;
constexpr int kSlabBytes = kBM * 64 * 4;       // a warpgroup's int32 tile: 32 KB
// the ring, the two slabs, the barriers and room to align the ring to 1 KB
// (the swizzle's period)
constexpr int kSmemTiled = kRing + 2 * kSlabBytes + 2 * kStages * 8 + 1024;
constexpr int kThreadsTiled = 384;  // the producer and two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Tile t of the grid's walk: x tiles outer (consecutive tiles share an x
// tile and walk the weights) or weight tiles outer.
__device__ __forceinline__ void tile_coords(int t, int m_tiles, int n_tiles, int x_outer,
                                            int& m0, int& n0) {
  m0 = (x_outer ? t / n_tiles : t % m_tiles) * kBM;
  n0 = (x_outer ? t % n_tiles : t / m_tiles) * kBN;
}

__global__ void __launch_bounds__(kThreadsTiled, 1)
w4a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, const float* __restrict__ xs,
                  const float* __restrict__ ws, const __nv_bfloat16* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int* __restrict__ acc_out, int m, int n,
                  int k, int m_tiles, int n_tiles, int x_outer) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t slabs = ring + kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (ring - raw) + kRing + 2 * kSlabBytes);
  uint64_t* empty = full + kStages;

  const int n_tiles_all = m_tiles * n_tiles;
  const int k2 = k >> 1;
  const int n_steps = k2 / kKStep;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;   // the ring position, continued from tile to tile
      for (int tile = blockIdx.x; tile < n_tiles_all; tile += gridDim.x) {
        int m0, n0;
        tile_coords(tile, m_tiles, n_tiles, x_outer, m0, n0);
        for (int j = 0; j < n_steps; ++j, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(&full[s], kStageBytes);
          const uint32_t dst = ring + s * kStageBytes;
          tma_load_2d(dst, &xmap, &full[s], j * kKStep, m0);
          tma_load_2d(dst + kXBox, &xmap, &full[s], k2 + j * kKStep, m0);
          tma_load_2d(dst + 2 * kXBox, &wmap, &full[s], j * kKStep, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;                  // consumer 0 or 1: weight rows 64 cw ..
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool signals = lane == 0;         // one arrive per warp
  // the thread's A rows: weight row 64 cw + 16 warp + g and that + 8, whose
  // 16-byte chunk c sits at chunk c ^ g of its 128-byte row (g = row % 8)
  const uint32_t a_row = (64 * cw + 16 * warp + g) * kKStep + 4 * t;
  const uint32_t slab = slabs + cw * kSlabBytes;
  // the epilogue's share of each tile: 4 weight rows (16 bytes of int32) of
  // x rows tid / 16 + 8 i
  const int ch = tid % 16, r_first = tid / 16;

  int acc[64];
  uint32_t frag[2][32];   // per stage: the low plane's 4 k-steps x 4, then the high plane's
  int it = 0;             // the ring position of the tile's first stage

  // Stage j of the tile: unpack its A fragments into f, issue its eight
  // products, wait for stage j - 1's (whose fragments are prev), release
  // stage j - 1.
  auto stage = [&](int j, uint32_t(&f)[32], uint32_t(&prev)[32]) {
    const int s = (it + j) % kStages;
    mbar_wait(&full[s], ((it + j) / kStages) & 1);
    const uint32_t base = ring + s * kStageBytes;
    const uint32_t w = base + 2 * kXBox + a_row;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t c0 = ((2 * ks) ^ g) * 16, c1 = ((2 * ks + 1) ^ g) * 16;
      unpack_w4(lds32(w + c0), f[4 * ks], f[16 + 4 * ks]);
      unpack_w4(lds32(w + 8 * kKStep + c0), f[4 * ks + 1], f[16 + 4 * ks + 1]);
      unpack_w4(lds32(w + c1), f[4 * ks + 2], f[16 + 4 * ks + 2]);
      unpack_w4(lds32(w + 8 * kKStep + c1), f[4 * ks + 3], f[16 + 4 * ks + 3]);
    }
    fence_regs(f);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_s8_rs(acc, f[4 * ks], f[4 * ks + 1], f[4 * ks + 2], f[4 * ks + 3],
                  sw128_desc(base + 32 * ks, 16, 1024));
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_s8_rs(acc, f[16 + 4 * ks], f[16 + 4 * ks + 1], f[16 + 4 * ks + 2],
                  f[16 + 4 * ks + 3], sw128_desc(base + kXBox + 32 * ks, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    fence_regs(prev);
    if (j > 0) {
      __syncwarp();
      if (signals) mbar_arrive(&empty[(it + j - 1) % kStages]);
    }
  };

  for (int tile = blockIdx.x; tile < n_tiles_all; tile += gridDim.x) {
    int m0, n0;
    tile_coords(tile, m_tiles, n_tiles, x_outer, m0, n0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int j = 0; j < n_steps; j += 2) {
      stage(j, frag[0], frag[1]);
      if (j + 1 < n_steps) stage(j + 1, frag[1], frag[0]);
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(frag[0]);
    fence_regs(frag[1]);
    __syncwarp();
    if (signals) mbar_arrive(&empty[(it + n_steps - 1) % kStages]);
    it += n_steps;

    // Epilogue, while the producer fills the ring for the next tile: the
    // warpgroup stages its accumulators in its slab (x row r, weight row c
    // of its 64 at int r * 64 + (c ^ 8 ((r / 2) % 4)), so that neither the
    // writes nor the reads conflict), then writes out row by row.  Its
    // scales and bias are read before the slab is free, their latency under
    // the barrier.
    const int col = n0 + 64 * cw + 4 * ch;
    const float4 wsc = *reinterpret_cast<const float4*>(ws + col);
    float b4[4] = {0.f, 0.f, 0.f, 0.f};
    if (bias != nullptr) {
      const uint2 braw = *reinterpret_cast<const uint2*>(bias + col);
      b4[0] = __uint_as_float(braw.x << 16);
      b4[1] = __uint_as_float(braw.x & 0xFFFF0000u);
      b4[2] = __uint_as_float(braw.y << 16);
      b4[3] = __uint_as_float(braw.y & 0xFFFF0000u);
    }
    float xsr[kBM / 8];
#pragma unroll
    for (int i = 0; i < kBM / 8; ++i) {
      const int row = m0 + r_first + 8 * i;
      xsr[i] = row < m ? xs[row] : 0.f;
    }
    named_sync(2 + cw, 128);   // the slab's previous tile has been read
#pragma unroll
    for (int nb = 0; nb < kBM / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * nb + 2 * t + (e & 1);          // x row within the tile
        const int c = 16 * warp + g + 8 * (e >> 1);       // weight row within the 64
        sts32(slab + (r * 64 + (c ^ (8 * ((r >> 1) & 3)))) * 4,
              static_cast<uint32_t>(acc[4 * nb + e]));
      }
    }
    named_sync(2 + cw, 128);
#pragma unroll
    for (int i = 0; i < kBM / 8; ++i) {
      const int r = r_first + 8 * i;
      const int row = m0 + r;
      if (row < m) {
        const uint4 v = lds128(slab + r * 256 + ((ch ^ (2 * ((r >> 1) & 3))) * 16));
        const int a[4] = {static_cast<int>(v.x), static_cast<int>(v.y), static_cast<int>(v.z),
                          static_cast<int>(v.w)};
        const float sc[4] = {wsc.x, wsc.y, wsc.z, wsc.w};
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // w4a8_epilogue's order, its bias read beforehand
          y[e] = __fmul_rn(__fmul_rn(__int2float_rn(a[e]), xsr[i]), sc[e]);
          if (bias != nullptr) y[e] = __fadd_rn(y[e], b4[e]);
        }
        const long o = (long)row * n + col;
        *reinterpret_cast<uint2*>(out + o) = make_uint2(pack_bf16(y[0], y[1]),
                                                        pack_bf16(y[2], y[3]));
        if (acc_out != nullptr) *reinterpret_cast<uint4*>(acc_out + o) = v;
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

int launch_tiled(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                 const __nv_bfloat16* bias, __nv_bfloat16* out, int* acc_out, int m, int n,
                 int k, cudaStream_t stream) {
  CUtensorMap xm, wm;
  const int k2 = k / 2;
  if (!make_map_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, k, m, k, kKStep, kBM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k2, n, k2, kKStep, kBN,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      w4a8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemTiled);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int m_tiles = (m + kBM - 1) / kBM, n_tiles = n / kBN;
  // re-read the smaller operand from L2: the weights (N K / 2 bytes) or x (M K)
  const int x_outer = (long)m * k < (long)n * k2 ? 0 : 1;
  const int blocks = m_tiles * n_tiles < sm_count() ? m_tiles * n_tiles : sm_count();
  w4a8_wgmma_kernel<<<blocks, kThreadsTiled, kSmemTiled, stream>>>(
      xm, wm, xs, ws, bias, out, acc_out, m, n, k, m_tiles, n_tiles, x_outer);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_q int8 [M, K], w4 int8 [N, K/2] (the packing above), x_scale fp32 [M],
// w_scale fp32 [N], bias bf16 [N] or null, out bf16 [M, N], acc_out int32
// [M, N] or null; all contiguous, x_q and w4 16-byte aligned (TMA).
// K/2 % 128 == 0 and N % 128 == 0 (the contract of the JAX kernel; the
// wrapper checks it).  Returns cudaGetLastError() after the launch.
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
  return launch_tiled(x, w, xsp, wsp, b, o, a, m, n, k, s);
}

// The dynamic shared memory of one block of the tiled regime, for the report
// beside ptxas's.
extern "C" int w4a8_matmul_smem_bytes() { return kSmemTiled; }
