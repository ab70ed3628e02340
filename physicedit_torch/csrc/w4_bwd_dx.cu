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
// g2 = bf16(fp32(g) * w_scale) is formed in the consumers' registers,
// rounded after the multiply as the JAX wrapper rounds it.
//
// What bounds it on an H100: 2 * M * N * K operations over the bytes of g
// (M * N * 2), w4 (N * K / 2) and dx (M * K * 2).  At the DiT's training
// shapes (M = 3,120 image or ~384 text tokens, K and N of 3072 to 12288)
// the image stream is far above the ~295 FLOP/byte ridge: the bf16 tensor
// cores (image fc1: 2.4e11 FLOP, 0.24 ms at 989 TFLOP/s).  Design: the
// Hopper path of hopper_primitives.cuh, one block of three warpgroups per
// dx tile of 128 rows x (128 low + 128 high) columns, a loop over N in
// stages of 64:
//   warpgroup 0 (setmaxnreg.dec): one thread issues per stage three TMA
//     loads into a ring of kStages: the g box [128 rows x 64 n] bf16 with
//     the 128-byte swizzle, the packed box [64 n x 128 j] bytes and the 64
//     w_scale values; warps 1-3 unpack each packed box, 16 bytes a thread
//     and item, into a ring of kSlots slots of bf16 weight
//     planes, [64 n x 64 j] boxes written by hand in the 128-byte swizzle
//     that wgmma's descriptor names (16-byte chunk c of row r at chunk
//     c ^ (r % 8)), two boxes of the low plane and two of the high, the
//     conversion a byte permute into 0x43 | nibble (bf16 128 + v, exact)
//     and one bf16x2 subtraction of 136; then fence.proxy.async, so that
//     wgmma sees the stores;
//   warpgroups 1 and 2 (setmaxnreg.inc) own 64 dx rows each: per stage each
//     thread reads its A fragments of the g box, scales them by the stage's
//     w_scale and rounds them to bf16 in registers (no pre-pass), releases
//     the stage, and issues four wgmma.mma_async m64n256k16 products with A
//     from registers and B the slot's four plane boxes, MN-major (the 256
//     accumulator columns are dx columns j0.. of the low plane, then j0.. of
//     the high).  The fragments are double-buffered (wgmma.wait_group 1), and
//     every consumer warp releases a slot once its products are done.
// Rows past M arrive as TMA's zeros and are never stored; each thread
// writes its bf16 pairs of both halves of dx in place.
#include "hopper_primitives.cuh"
#include "mma_bf16.cuh"

using namespace physicedit;
using namespace physicedit::hopper;

namespace {

constexpr int kBM = 128;                    // dx rows per block: 2 consumer warpgroups x 64
constexpr int kBJ = 128;                    // packed columns per block (x 2 planes)
constexpr int kBN = 64;                     // contraction (n) per stage
constexpr int kGBox = kBM * kBN * 2;        // the g box: 16 KB
constexpr int kPBox = kBN * kBJ;            // the packed box: 8 KB
constexpr int kScaleBox = kBN * 4;          // the stage's 64 w_scale values
constexpr int kStageTx = kGBox + kPBox + kScaleBox;
constexpr int kStageBytes = 25 * 1024;      // kStageTx, 1 KB-aligned
static_assert(kStageTx <= kStageBytes, "a stage's TMA bytes must fit its slot");
constexpr int kStages = 4;
constexpr int kPlaneBox = kBN * 64 * 2;     // [64 n x 64 j] bf16: 8 KB
constexpr int kSlotBytes = 4 * kPlaneBox;   // low j0.., low j0+64.., high j0.., high j0+64..
constexpr int kSlots = 3;
constexpr int kRing = kStages * kStageBytes;
constexpr int kBarriers = 2 * kStages + 2 * kSlots;
constexpr int kSmemBytes = kRing + kSlots * kSlotBytes + 8 * kBarriers + 1024;
constexpr int kThreadsBwd = 384;
constexpr int kConsumerWarps = 8;
constexpr int kUnpackThreads = 96;          // producer warps 1-3
constexpr int kUnpackItems = kBN * kBJ / 16;  // 16 packed bytes each
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// bf16x2 a - 136 (exact for the small integers here)
__device__ __forceinline__ uint32_t minus136(uint32_t a) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// Four packed bytes -> the low-plane weights (b & 15) - 8 and the high-plane
// ones b >> 4, each as two bf16 pairs (the lower byte in the low half).
__device__ __forceinline__ void unpack_w4_bf16(uint32_t p, uint32_t& lo01, uint32_t& lo23,
                                               uint32_t& hi01, uint32_t& hi23) {
  const uint32_t l = p & 0x0F0F0F0Fu;                        // (b & 15)
  const uint32_t h = ((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;  // (b >> 4) + 8
  lo01 = minus136(__byte_perm(l, 0x43434343u, 0x4140));
  lo23 = minus136(__byte_perm(l, 0x43434343u, 0x4342));
  hi01 = minus136(__byte_perm(h, 0x43434343u, 0x4140));
  hi23 = minus136(__byte_perm(h, 0x43434343u, 0x4342));
}

// bf16(fp32(g) * s) of a packed bf16 pair
__device__ __forceinline__ uint32_t scale_pair(uint32_t g, float2 s) {
  return pack_bf16(__uint_as_float(g << 16) * s.x, __uint_as_float(g & 0xFFFF0000u) * s.y);
}

__global__ void __launch_bounds__(kThreadsBwd, 1)
w4_bwd_dx_wgmma_kernel(const __grid_constant__ CUtensorMap gmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap smap, uint16_t* __restrict__ dx, int m,
                       int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t slots = ring + kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (ring - raw) + kRing +
                                               kSlots * kSlotBytes);
  uint64_t* empty = full + kStages;
  uint64_t* ufull = empty + kStages;
  uint64_t* uempty = ufull + kSlots;

  const int j0 = blockIdx.x * kBJ;
  const int m0 = blockIdx.y * kBM;
  const int k2 = k >> 1;
  const int n_steps = n / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps + kUnpackThreads);
    }
#pragma unroll
    for (int u = 0; u < kSlots; ++u) {
      mbar_init(&ufull[u], kUnpackThreads);
      mbar_init(&uempty[u], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kStageTx);
        const uint32_t dst = ring + s * kStageBytes;
        tma_load_2d(dst, &gmap, &full[s], j * kBN, m0);
        tma_load_2d(dst + kGBox, &wmap, &full[s], j0, j * kBN);
        tma_load_2d(dst + kGBox + kPBox, &smap, &full[s], j * kBN, 0);
      }
    } else if (threadIdx.x >= 32) {
      const int ut = threadIdx.x - 32;
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % kStages, u = j % kSlots;
        mbar_wait(&full[s], (j / kStages) & 1);
        mbar_wait(&uempty[u], ((j / kSlots) & 1) ^ 1);
        const uint32_t packed = ring + s * kStageBytes + kGBox;
        const uint32_t slot = slots + u * kSlotBytes;
        // item q: n row r, packed bytes 16 c .. 16 c + 15 -> two 16-byte
        // chunks (8 weights each) of each plane.  Not unrolled: within the
        // producer's 40 registers an unrolled loop spills.
#pragma unroll 1
        for (int q = ut; q < kUnpackItems; q += kUnpackThreads) {
          const int r = q / (kBJ / 16), c = q % (kBJ / 16);
          const uint4 p = lds128(packed + r * kBJ + 16 * c);
          uint4 lo0, hi0, lo1, hi1;
          unpack_w4_bf16(p.x, lo0.x, lo0.y, hi0.x, hi0.y);
          unpack_w4_bf16(p.y, lo0.z, lo0.w, hi0.z, hi0.w);
          unpack_w4_bf16(p.z, lo1.x, lo1.y, hi1.x, hi1.y);
          unpack_w4_bf16(p.w, lo1.z, lo1.w, hi1.z, hi1.w);
          // chunks 2 (c % 4) and that + 1 of plane box c / 4, row r
          const uint32_t row = slot + (c / 4) * kPlaneBox + r * 128;
          const uint32_t off0 = ((2 * (c % 4)) ^ (r % 8)) * 16;
          const uint32_t off1 = ((2 * (c % 4) + 1) ^ (r % 8)) * 16;
          sts128(row + off0, lo0);
          sts128(row + off1, lo1);
          sts128(row + 2 * kPlaneBox + off0, hi0);
          sts128(row + 2 * kPlaneBox + off1, hi1);
        }
        fence_proxy_async();
        mbar_arrive(&ufull[u]);
        mbar_arrive(&empty[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;                  // consumer 0 or 1: dx rows 64 cw ..
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool signals = lane == 0;         // one arrive per warp
  // the thread's A rows in the g box: 64 cw + 16 warp + g and that + 8,
  // whose 16-byte chunk c sits at chunk c ^ g of its 128-byte row
  const uint32_t a_row = (64 * cw + 16 * warp + g) * (kBN * 2) + 4 * t;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t frag[2][16];   // per stage: 4 k-steps x the 4 A registers

  // Stage j: build its A fragments in f, release the g stage, issue its
  // four products, wait for stage j - 1's (whose fragments are prev),
  // release stage j - 1's slot.
  auto stage = [&](int j, uint32_t(&f)[16], uint32_t(&prev)[16]) {
    const int s = j % kStages, u = j % kSlots;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t a = ring + s * kStageBytes + a_row;
    const uint32_t wsj = ring + s * kStageBytes + kGBox + kPBox + 8 * t;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t c0 = ((2 * ks) ^ g) * 16, c1 = ((2 * ks + 1) ^ g) * 16;
      const uint2 s0r = lds64(wsj + 64 * ks), s8r = lds64(wsj + 64 * ks + 32);
      const float2 s0 = make_float2(__uint_as_float(s0r.x), __uint_as_float(s0r.y));
      const float2 s8 = make_float2(__uint_as_float(s8r.x), __uint_as_float(s8r.y));
      f[4 * ks] = scale_pair(lds32(a + c0), s0);
      f[4 * ks + 1] = scale_pair(lds32(a + 1024 + c0), s0);
      f[4 * ks + 2] = scale_pair(lds32(a + c1), s8);
      f[4 * ks + 3] = scale_pair(lds32(a + 1024 + c1), s8);
    }
    __syncwarp();
    if (signals) mbar_arrive(&empty[s]);
    mbar_wait(&ufull[u], (j / kSlots) & 1);
    const uint32_t slot = slots + u * kSlotBytes;
    fence_regs(f);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_bf16_rs_n256(acc, f[4 * ks], f[4 * ks + 1], f[4 * ks + 2], f[4 * ks + 3],
                         sw128_desc(slot + ks * 2048, kPlaneBox, 1024));
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    fence_regs(prev);
    if (j > 0) {
      __syncwarp();
      if (signals) mbar_arrive(&uempty[(j - 1) % kSlots]);
    }
  };
  for (int j = 0; j < n_steps; j += 2) {
    stage(j, frag[0], frag[1]);
    if (j + 1 < n_steps) stage(j + 1, frag[1], frag[0]);
  }
  wgmma_wait_all();
  fence_regs(acc);
  fence_regs(frag[0]);
  fence_regs(frag[1]);

  // acc[4 c + 2 i + e] is dx row 16 warp + g + 8 i of the warpgroup's 64,
  // column 8 c + 2 t + e of the 256: j0 + that of the low half for c < 16,
  // K/2 + j0 + that - 128 of the high half after
  const int r0 = m0 + 64 * cw + 16 * warp + g;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = (c < 16 ? j0 : k2 + j0 - 128) + 8 * c + 2 * t;
    if (r0 < m)
      *reinterpret_cast<uint32_t*>(dx + (long)r0 * k + col) = pack_bf16(acc[4 * c], acc[4 * c + 1]);
    if (r0 + 8 < m)
      *reinterpret_cast<uint32_t*>(dx + (long)(r0 + 8) * k + col) =
          pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

}  // namespace

// g bf16 [M, N], w4 int8 [N, K/2] (K3's packing), w_scale fp32 [N], dx bf16
// [M, K]; all contiguous, g, w4 and w_scale 16-byte aligned (TMA).  K/2 % 128 == 0
// and N % 128 == 0 (the contract of the JAX kernel; the wrapper checks it).
// Returns cudaGetLastError().
extern "C" int w4_bwd_dx_bf16(const void* g, const void* w4, const void* w_scale, void* dx,
                              int m, int n, int k, void* stream) {
  CUtensorMap gm, wm, sm;
  const int k2 = k / 2;
  if (!make_map_2d(&gm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, g, n, m, 2ull * n, kBN, kBM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w4, k2, n, k2, kBJ, kBN,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&sm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w_scale, n, 1, 4ull * n, kBN, 1,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      w4_bwd_dx_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(k2 / kBJ, (m + kBM - 1) / kBM);
  w4_bwd_dx_wgmma_kernel<<<grid, kThreadsBwd, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      gm, wm, sm, static_cast<uint16_t*>(dx), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of one block, for the report beside ptxas's.
extern "C" int w4_bwd_dx_smem_bytes() { return kSmemBytes; }
