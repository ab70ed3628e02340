// The int8 and W4 matmul probes of tools/: T9's persistent TMA + wgmma GEMM,
// T12's W4 GEMM on K3's TMA + wgmma loop, T10's mma.sync tiled kernel and one
// decode GEMV.
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
//        (w4_and_wgmma_kernel; acc16 is a multiple of 16, so the shift is
//        exact)
//   T11  tools/proto_w4_gemv.py::gemv_and_only (body _gemv_kernel): T12's
//        integer part over m <= 8 decode rows, int32 out
// The W4 forms end in the JAX epilogue, acc * x_scale * wsb[0] + wsb[1] in
// fp32, each step rounded (no FMA contraction), then fp32, bf16 or int8 (JAX's
// conversion: truncate toward 0 and saturate).
//
// Layouts (the port's, not the JAX tools'): x [M, K] row-major; T9's w is
// [N, K] and the W4 weights are K3's w4 [N, K/2] (csrc/mma_int8.cuh), so that
// one output column's k values are contiguous: both operands K-major, as
// int8 wgmma and mma.sync take them.  Byte j of column n holds w[n, j] + 8 in
// its low nibble and w[n, j + K/2] in its high nibble.
//
// What bounds them on an H100:
//  - T9 at M16384 K3072 N12288: 1.24e12 operations, 0.63 ms at 1,979 TOP/s
//    int8 and 1.25 ms at 989 TFLOP/s bf16; it moves 0.89 GB (i32, 0.81 GB of
//    it the int32 output, 0.27 ms at 3.35 TB/s) or 0.58 GB (f32).  Design
//    (gemm_wgmma_kernel): a persistent grid, one block of three warpgroups
//    per SM, walks 128 x 256 output tiles, 16 x-row tiles at a time so that
//    the operands the running blocks share stay in L2; warpgroup 0, the
//    producer (setmaxnreg.dec), one thread of which issues per stage two TMA
//    loads with the 128-byte swizzle, the x box (128 rows x 128 bytes of k)
//    and the w box (256 rows x 128 bytes), into a ring of 4 stages of 48 KB
//    that runs on from one tile into the next; warpgroups 1 and 2, the
//    consumers (setmaxnreg.inc), own 64 x rows each and issue per stage four
//    wgmma.mma_async m64n256k32 s32.s8.s8 (or m64n256k16 f32.bf16.bf16)
//    products with A and B both read from shared memory through
//    descriptors, 128 accumulators a thread; a stage's products run while the
//    next stage is waited for (wgmma.wait_group 1), and every consumer warp
//    releases a stage once its products are done.  The two forms differ only
//    in the product: a stage is 128 bytes of k either way (128 int8 or 64
//    bf16), the maps are byte maps.  Epilogue, while the producer already
//    fills the ring for the next tile: each consumer writes its 64 x 256
//    accumulators in passes into a 16 KB slab of its own with the 128-byte
//    swizzle (conflict-free), and one of its threads hands each pass to a
//    TMA store, which drains under the next pass and the next tile's
//    products; a pass waits only until the previous one has been read out
//    of the slab.  Against stores from registers (4 bytes a thread for
//    bf16, half sectors) this took f32 from 1.79 to 1.54 ms on an H100 and
//    left i32 where it was (PERF.md §6).  Rows past M and w rows past N
//    arrive as TMA's zeros and are not stored (the output map's bounds).
//  - T12 at the DiT image stream's fc1 (M16384 K3072 N12288): the tensor
//    cores, 1.24e12 int8 operations, 0.63 ms at 1,979 TOP/s, against 0.47 GB
//    moved.  Design (w4_and_wgmma_kernel): K3's tiled regime
//    (w4a8_matmul.cu::w4a8_wgmma_kernel, whose design comment holds), out^T
//    = planes(w4) . x^T on a persistent grid of one block of three
//    warpgroups per SM, the producer's thread issuing per stage the x box at
//    j0, the one at K/2 + j0 and the packed box (128 rows x 128 bytes each,
//    128-byte swizzle) into a 3-stage ring, each consumer warpgroup owning 64
//    weight rows.  What differs: the unpack is one AND a 32-bit word per
//    plane, b & 0x0F0F0F0F (lo + 8) and b & 0xF0F0F0F0 (16 hi), and the
//    planes go into two int32 accumulators of 64 registers a thread, the low
//    against the x box at j0, the high against the one at K/2 + j0.  The
//    products go in one commit group per plane, not per stage as K3's: a
//    stage loads its 16 packed words once, ANDs out the low plane, issues
//    its four wgmma m64n128k32 s32.s8.s8, waits until the previous stage's
//    high group is done (wgmma.wait_group 1; that stage is then released),
//    ANDs out the high plane and issues its group, and waits until its own
//    low group is done; so a warpgroup always has one group in flight while
//    it unpacks the next, with 48 fragment registers beside the 128
//    accumulators.  On an H100 this ran every DiT and VL shape faster than
//    the same kernel with K3's per-stage double buffer of both planes (64
//    fragment registers, which fit too), and faster than K3 (PERF.md §6).
//    Where K/2 is
//    no multiple of the 128-byte stage (K = 384), the packed box of the last
//    stage reads TMA's zeros past K/2, which both planes take as weight 0.
//    Epilogue: acc + (acc16 >> 4) in registers (exact), then K3's XOR-
//    swizzled slab and row-wise stores (4 output columns a thread: 16, 8 or
//    4 bytes for fp32, bf16, int8), with rs subtracted and the JAX epilogue
//    applied per row after the slab; the optional int32 result beside it.
//  - T10 at the VL prefill shapes: the tensor cores.  Design: the mma.sync
//    tiling K3's tiled regime ran before its TMA + wgmma GEMM: 128 x 128
//    output tiles, 8 warps of 32 x 64, mma.sync m16n8k32 s8; each step
//    stages two 64-byte "planes" of k per row in shared memory (k and
//    k + K/2, the single packed tile unpacked into the two planes), the next
//    step's global loads issued before this step's products.  Not done:
//    wgmma, TMA, a multi-stage pipeline.
//  - the GEMV (T11, weights 0.5 byte each, 10-68 MB per call): reading the
//    weights at 3.35 TB/s.  Design: K3's GEMV regime: one warp per output
//    column, one 128-bit weight load per lane per step (32 weights), __dp4a
//    against the x_lo and x_hi halves, two accumulators per row.
#include <type_traits>

#include "hopper_primitives.cuh"
#include "mma_bf16.cuh"
#include "mma_int8.cuh"

using namespace physicedit;
namespace hp = physicedit::hopper;

namespace {

// template arguments are ints so that they mangle as Li<n>E, which
// chip_smoke.py reads out of the ptxas report
constexpr int kI8 = 0, kBf16 = 1, kW4Unpack = 2;
constexpr int kOutF32 = 0, kOutBf16 = 1, kOutI8 = 2;  // the W4 forms' out_code

// ---- T9: the persistent TMA + wgmma GEMM --------------------------------------

constexpr int kGemmBM = 128;                   // x rows (output rows) per tile, 64 a consumer
constexpr int kGemmBN = 256;                   // w rows (output columns) per tile
constexpr int kGemmKBytes = 128;               // bytes of k per stage: one swizzled row
constexpr int kGemmStages = 4;
constexpr int kGemmXBox = kGemmBM * kGemmKBytes;          // 16 KB
constexpr int kGemmStageBytes = kGemmXBox + kGemmBN * kGemmKBytes;   // + the w box: 48 KB
constexpr int kGemmRing = kGemmStages * kGemmStageBytes;
// The epilogue's slab, one per consumer: boxes of 64 rows x 128 bytes with
// the 128-byte swizzle, kGemmSlabBoxes of them a pass (i32: 64 columns,
// bf16: 128 columns of the consumer's 64 x 256)
constexpr int kGemmBoxBytes = 64 * 128;
constexpr int kGemmSlabBoxes = 2;
constexpr int kGemmSlabBytes = kGemmSlabBoxes * kGemmBoxBytes;   // 16 KB
// the ring, the two slabs, the barriers and room to align the ring to 1 KB
// (the swizzle's period)
constexpr int kGemmSmem = kGemmRing + 2 * kGemmSlabBytes + 2 * kGemmStages * 8 + 1024;
constexpr int kGemmThreads = 384;              // the producer and two consumer warpgroups
constexpr int kGemmConsumerWarps = 8;
constexpr int kGemmGroupM = 16;                // x-row tiles per group of the walk
constexpr int kGemmProducerRegs = 40;
constexpr int kGemmConsumerRegs = 232;

// Tile t of the walk: groups of kGemmGroupM x-row tiles, within a group the
// x-row tile fastest, so that the blocks running at once share a few x and w
// tiles in L2 (16 x 128 rows of x and about 132 / 16 x 256 rows of w).
__device__ __forceinline__ void gemm_tile(int t, int m_tiles, int n_tiles, int& m0, int& n0) {
  const int per_group = kGemmGroupM * n_tiles;
  const int first = t / per_group * kGemmGroupM;
  const int rows = min(m_tiles - first, kGemmGroupM);
  const int r = t % per_group;
  m0 = (first + r % rows) * kGemmBM;
  n0 = r / rows * kGemmBN;
}

template <int kKind>
__global__ void __launch_bounds__(kGemmThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap omap, int m, int k_bytes, int n_bytes,
                  int m_tiles, int n_tiles) {
  using AccT = typename std::conditional<kKind == kI8, int, float>::type;
  constexpr int kElemBytes = kKind == kI8 ? 4 : 2;   // of the output
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hp::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  const uint32_t slabs = ring + kGemmRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (ring - raw) + kGemmRing +
                                               2 * kGemmSlabBytes);
  uint64_t* empty = full + kGemmStages;

  const int n_tiles_all = m_tiles * n_tiles;
  const int n_steps = k_bytes / kGemmKBytes;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kGemmStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kGemmConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kGemmProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;   // the ring position, continued from tile to tile
      for (int tile = blockIdx.x; tile < n_tiles_all; tile += gridDim.x) {
        int m0, n0;
        gemm_tile(tile, m_tiles, n_tiles, m0, n0);
        for (int j = 0; j < n_steps; ++j, ++it) {
          const int s = it % kGemmStages;
          hp::mbar_wait(&empty[s], ((it / kGemmStages) & 1) ^ 1);
          hp::mbar_expect_tx(&full[s], kGemmStageBytes);
          const uint32_t dst = ring + s * kGemmStageBytes;
          hp::tma_load_2d(dst, &xmap, &full[s], j * kGemmKBytes, m0);
          hp::tma_load_2d(dst + kGemmXBox, &wmap, &full[s], j * kGemmKBytes, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kGemmConsumerRegs));
  const int cw = wg - 1;                  // consumer 0 or 1: x rows 64 cw ..
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const bool signals = lane == 0;         // one arrive per warp
  const bool leader = threadIdx.x % 128 == 0;   // issues the consumer's TMA stores
  const uint32_t slab = slabs + cw * kGemmSlabBytes;

  AccT acc[128];
  int it = 0;             // the ring position of the tile's first stage
  for (int tile = blockIdx.x; tile < n_tiles_all; tile += gridDim.x) {
    int m0, n0;
    gemm_tile(tile, m_tiles, n_tiles, m0, n0);
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    for (int j = 0; j < n_steps; ++j) {
      const int s = (it + j) % kGemmStages;
      hp::mbar_wait(&full[s], ((it + j) / kGemmStages) & 1);
      const uint32_t a = ring + s * kGemmStageBytes + cw * 64 * kGemmKBytes;
      const uint32_t b = ring + s * kGemmStageBytes + kGemmXBox;
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {   // 32 bytes of k each: k32 int8, k16 bf16
        const uint64_t da = hp::sw128_desc(a + 32 * ks, 16, 1024);
        const uint64_t db = hp::sw128_desc(b + 32 * ks, 16, 1024);
        if constexpr (kKind == kI8) hp::wgmma_s8_ss_n256(acc, da, db);
        else hp::wgmma_bf16_ss_n256(acc, da, db);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();   // stage j - 1's products are done
      hp::fence_regs(acc);
      if (j > 0) {
        __syncwarp();
        if (signals) hp::mbar_arrive(&empty[(it + j - 1) % kGemmStages]);
      }
    }
    hp::wgmma_wait_all();
    hp::fence_regs(acc);
    __syncwarp();
    if (signals) hp::mbar_arrive(&empty[(it + n_steps - 1) % kGemmStages]);
    it += n_steps;

    // Epilogue, while the producer fills the ring for the next tile: the
    // consumer's 64 x 256 accumulators go out in passes through its slab,
    // each pass a TMA store of kGemmSlabBoxes boxes that runs on under the
    // next pass and the next tile's products.  acc[4 nb + 2 i + e] is row
    // 16 warp + g + 8 i of the consumer's 64, column 8 nb + 2t + e of the
    // tile: bytes (8 nb + 2t) * kElemBytes of the tile's row, 16-byte chunk
    // c of a box row at chunk c ^ (row % 8) = c ^ g, so that a warp's writes
    // fill whole 128-byte lines of distinct banks.  Rows past M and columns
    // past N are not stored (the map's bounds).
    constexpr int kPassBytes = kGemmSlabBoxes * 128;            // of a tile row
    constexpr int kPasses = kGemmBN * kElemBytes / kPassBytes;  // i32 4, bf16 2
    constexpr int kBlocksPerPass = 32 / kPasses;                // of the 32 nb
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (leader) hp::bulk_wait_read<0>();   // the slab's last pass has been read
      hp::named_sync(1 + cw, 128);
#pragma unroll
      for (int i = 0; i < kBlocksPerPass; ++i) {
        const int nb = p * kBlocksPerPass + i;
        const int byte = (8 * nb + 2 * t) * kElemBytes - p * kPassBytes;
        const uint32_t at = slab + byte / 128 * kGemmBoxBytes + (16 * warp + g) * 128 +
                            ((byte % 128 / 16) ^ g) * 16 + byte % 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // rows g and g + 8: 1 KB apart, the same swizzle
          const AccT a0 = acc[4 * nb + 2 * h], a1 = acc[4 * nb + 2 * h + 1];
          if constexpr (kKind == kI8)
            hp::sts64(at + h * 1024, static_cast<uint32_t>(a0), static_cast<uint32_t>(a1));
          else
            hp::sts32(at + h * 1024, pack_bf16(a0, a1));
        }
      }
      hp::fence_proxy_async();   // the writes are visible to the TMA store
      hp::named_sync(1 + cw, 128);
      if (leader) {
#pragma unroll
        for (int box = 0; box < kGemmSlabBoxes; ++box) {
          const int col_byte = n0 * kElemBytes + p * kPassBytes + box * 128;
          if (col_byte < n_bytes && m0 + 64 * cw < m)
            hp::tma_store_2d(&omap, slab + box * kGemmBoxBytes, col_byte, m0 + 64 * cw);
        }
        hp::bulk_commit();
      }
    }
  }
  if (leader) hp::bulk_wait_all();   // the stores are done before the block exits
}

// ---- the W4 forms' shared pieces ------------------------------------------------

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

// ---- T12: the AND-only W4 GEMM on K3's TMA + wgmma loop -------------------------

constexpr int kAndBM = 128;                    // x rows (output rows) per tile
constexpr int kAndBN = 128;                    // weight rows (output columns) per tile, 64 a consumer
constexpr int kAndKStep = 128;                 // packed bytes per stage: 128 low + 128 high k
constexpr int kAndStages = 3;
constexpr int kAndXBox = kAndBM * kAndKStep;   // one x box: 16 KB
constexpr int kAndStageBytes = 2 * kAndXBox + kAndBN * kAndKStep;   // + the packed box: 48 KB
constexpr int kAndRing = kAndStages * kAndStageBytes;
constexpr int kAndSlabBytes = kAndBM * 64 * 4;  // a consumer's int32 tile: 32 KB
// the ring, the two slabs, the barriers and room to align the ring to 1 KB
constexpr int kAndSmem = kAndRing + 2 * kAndSlabBytes + 2 * kAndStages * 8 + 1024;

// Tile t of the walk: x tiles outer (consecutive tiles share an x tile and
// walk the weights) or weight tiles outer, as K3's.
__device__ __forceinline__ void and_tile(int t, int m_tiles, int n_tiles, int x_outer, int& m0,
                                         int& n0) {
  m0 = (x_outer ? t / n_tiles : t % m_tiles) * kAndBM;
  n0 = (x_outer ? t % n_tiles : t / m_tiles) * kAndBN;
}

__global__ void __launch_bounds__(kGemmThreads, 1)
w4_and_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ xs,
                    const float* __restrict__ wsb, const int* __restrict__ rs,
                    void* __restrict__ out, int* __restrict__ acc_out, int out_code, int m, int n,
                    int k, int m_tiles, int n_tiles, int x_outer) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = hp::smem_u32(smem_raw);
  const uint32_t ring = (raw_base + 1023u) & ~1023u;
  const uint32_t slabs = ring + kAndRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (ring - raw_base) + kAndRing +
                                               2 * kAndSlabBytes);
  uint64_t* empty = full + kAndStages;

  const int n_tiles_all = m_tiles * n_tiles;
  const int k2 = k >> 1;
  const int n_steps = (k2 + kAndKStep - 1) / kAndKStep;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kAndStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kGemmConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kGemmProducerRegs));
    if (threadIdx.x == 0) {
      int it = 0;   // the ring position, continued from tile to tile
      for (int tile = blockIdx.x; tile < n_tiles_all; tile += gridDim.x) {
        int m0, n0;
        and_tile(tile, m_tiles, n_tiles, x_outer, m0, n0);
        for (int j = 0; j < n_steps; ++j, ++it) {
          const int s = it % kAndStages;
          hp::mbar_wait(&empty[s], ((it / kAndStages) & 1) ^ 1);
          hp::mbar_expect_tx(&full[s], kAndStageBytes);
          const uint32_t dst = ring + s * kAndStageBytes;
          hp::tma_load_2d(dst, &xmap, &full[s], j * kAndKStep, m0);
          hp::tma_load_2d(dst + kAndXBox, &xmap, &full[s], k2 + j * kAndKStep, m0);
          hp::tma_load_2d(dst + 2 * kAndXBox, &wmap, &full[s], j * kAndKStep, n0);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kGemmConsumerRegs));
  const int cw = wg - 1;                  // consumer 0 or 1: weight rows 64 cw ..
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool signals = lane == 0;         // one arrive per warp
  // the thread's A rows: weight row 64 cw + 16 warp + g and that + 8, whose
  // 16-byte chunk c sits at chunk c ^ g of its 128-byte row (g = row % 8)
  const uint32_t a_row = (64 * cw + 16 * warp + g) * kAndKStep + 4 * t;
  const uint32_t slab = slabs + cw * kAndSlabBytes;
  // the epilogue's share of each tile: 4 weight rows (16 bytes of int32) of
  // x rows tid / 16 + 8 i
  const int ch = tid % 16, r_first = tid / 16;

  int acc[64], acc16[64];   // the low plane's sums and the high plane's
  uint32_t packed[16];      // a stage's A fragments, packed: 4 k-steps x 4
  uint32_t lo[16], hi[16];  // the two planes' fragments
  int it = 0;               // the ring position of the tile's first stage

  // Stage j of the tile: the low plane's products, then (once stage j - 1's
  // high products are done, and that stage released) the high plane's.
  auto stage = [&](int j) {
    const int s = (it + j) % kAndStages;
    hp::mbar_wait(&full[s], ((it + j) / kAndStages) & 1);
    const uint32_t base = ring + s * kAndStageBytes;
    const uint32_t w = base + 2 * kAndXBox + a_row;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t c0 = ((2 * ks) ^ g) * 16, c1 = ((2 * ks + 1) ^ g) * 16;
      packed[4 * ks] = hp::lds32(w + c0);
      packed[4 * ks + 1] = hp::lds32(w + 8 * kAndKStep + c0);
      packed[4 * ks + 2] = hp::lds32(w + c1);
      packed[4 * ks + 3] = hp::lds32(w + 8 * kAndKStep + c1);
    }
    // lo was last read by stage j - 1's low products, done by its last wait
#pragma unroll
    for (int i = 0; i < 16; ++i) lo[i] = packed[i] & 0x0F0F0F0Fu;
    hp::fence_regs(lo);
    hp::fence_regs(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_s8_rs(acc, lo[4 * ks], lo[4 * ks + 1], lo[4 * ks + 2], lo[4 * ks + 3],
                      hp::sw128_desc(base + 32 * ks, 16, 1024));
    hp::wgmma_commit();
    hp::wgmma_wait<1>();   // stage j - 1's high products are done: hi is free
    hp::fence_regs(acc16);
    hp::fence_regs(hi);
    if (j > 0) {
      __syncwarp();
      if (signals) hp::mbar_arrive(&empty[(it + j - 1) % kAndStages]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) hi[i] = packed[i] & 0xF0F0F0F0u;
    hp::fence_regs(hi);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_s8_rs(acc16, hi[4 * ks], hi[4 * ks + 1], hi[4 * ks + 2], hi[4 * ks + 3],
                      hp::sw128_desc(base + kAndXBox + 32 * ks, 16, 1024));
    hp::wgmma_commit();
    hp::wgmma_wait<1>();   // stage j's low products are done: lo is free
    hp::fence_regs(acc);
    hp::fence_regs(lo);
  };

  for (int tile = blockIdx.x; tile < n_tiles_all; tile += gridDim.x) {
    int m0, n0;
    and_tile(tile, m_tiles, n_tiles, x_outer, m0, n0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = acc16[i] = 0;
    for (int j = 0; j < n_steps; ++j) stage(j);
    hp::wgmma_wait_all();
    hp::fence_regs(acc);
    hp::fence_regs(acc16);
    hp::fence_regs(hi);
    __syncwarp();
    if (signals) hp::mbar_arrive(&empty[(it + n_steps - 1) % kAndStages]);
    it += n_steps;

    // Epilogue, while the producer fills the ring for the next tile: the
    // planes combined (acc16 is a multiple of 16: the shift is exact; rs is
    // subtracted per row below, integer sums in any order being exact), the
    // warpgroup stages them in its slab (x row r, weight row c of its 64 at
    // int r * 64 + (c ^ 8 ((r / 2) % 4)), so that neither the writes nor the
    // reads conflict), then writes out row by row.  Scales, biases and row
    // sums are read before the slab is free, their latency under the
    // barrier.
    const int col = n0 + 64 * cw + 4 * ch;
    const float4 wsc = *reinterpret_cast<const float4*>(wsb + col);
    const float4 wbc = *reinterpret_cast<const float4*>(wsb + n + col);
    float xsr[kAndBM / 8];
    int rsr[kAndBM / 8];
#pragma unroll
    for (int i = 0; i < kAndBM / 8; ++i) {
      const int row = m0 + r_first + 8 * i;
      xsr[i] = row < m ? xs[row] : 0.f;
      rsr[i] = row < m ? rs[row] : 0;
    }
    hp::named_sync(2 + cw, 128);   // the slab's previous tile has been read
#pragma unroll
    for (int nb = 0; nb < kAndBM / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * nb + 2 * t + (e & 1);          // x row within the tile
        const int c = 16 * warp + g + 8 * (e >> 1);       // weight row within the 64
        hp::sts32(slab + (r * 64 + (c ^ (8 * ((r >> 1) & 3)))) * 4,
                  static_cast<uint32_t>(acc[4 * nb + e] + (acc16[4 * nb + e] >> 4)));
      }
    }
    hp::named_sync(2 + cw, 128);
    const float sc[4] = {wsc.x, wsc.y, wsc.z, wsc.w};
    const float bc[4] = {wbc.x, wbc.y, wbc.z, wbc.w};
#pragma unroll
    for (int i = 0; i < kAndBM / 8; ++i) {
      const int r = r_first + 8 * i;
      const int row = m0 + r;
      if (row < m) {
        const uint4 u = hp::lds128(slab + r * 256 + ((ch ^ (2 * ((r >> 1) & 3))) * 16));
        const int v[4] = {static_cast<int>(u.x) - rsr[i], static_cast<int>(u.y) - rsr[i],
                          static_cast<int>(u.z) - rsr[i], static_cast<int>(u.w) - rsr[i]};
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = w4_epilogue(v[e], xsr[i], sc[e], bc[e]);
        const long o = (long)row * n + col;
        if (out_code == kOutF32) {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + o) =
              make_float4(y[0], y[1], y[2], y[3]);
        } else if (out_code == kOutBf16) {
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + o) =
              make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
        } else {
          *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(out) + o) =
              static_cast<uint8_t>(to_int8_sat(y[0])) |
              static_cast<uint32_t>(static_cast<uint8_t>(to_int8_sat(y[1]))) << 8 |
              static_cast<uint32_t>(static_cast<uint8_t>(to_int8_sat(y[2]))) << 16 |
              static_cast<uint32_t>(static_cast<uint8_t>(to_int8_sat(y[3]))) << 24;
        }
        if (acc_out != nullptr)
          *reinterpret_cast<int4*>(acc_out + o) = make_int4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// ---- T10: the mma.sync tiling; T11: the GEMV ----------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kPlane = 64;            // bytes of k per plane per step
constexpr int kMmThreads = 256;
constexpr int kSmemRow = kPlane + 16;  // 80 bytes a row keeps a warp's fragment
                                       // loads on 32 distinct banks
constexpr int kGemvWarps = 8;
constexpr int kGemvRows = 8;           // the tool's padded decode rows

template <int kKind>
__global__ void __launch_bounds__(kMmThreads)
tiled_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
             const float* __restrict__ xs, const float* __restrict__ wsb,
             void* __restrict__ out, int* __restrict__ acc_out,
             int out_code, int m, int n, int k) {
  static_assert(kKind == kW4Unpack, "T9 runs gemm_wgmma_kernel, T12 w4_and_wgmma_kernel");
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
  // bytes: an x row, a w4 row, the second plane's offset in an x row, and
  // the bytes of an x row that one step consumes
  const long a_pitch = (long)k;
  const long b_pitch = k / 2;
  const long plane1 = k / 2;
  const int step = kPlane;
  const long steps_end = k / 2;

  // Global -> register staging: each thread moves two 16-byte chunks of each
  // plane of x and of the packed w4 tile per step.
  int4 rx_lo[2], rx_hi[2], rw_lo[2];
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
    }
  };
  auto store_smem = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kMmThreads;
      const int off = (c >> 2) * kSmemRow + (c & 3) * 16;
      *reinterpret_cast<int4*>(a_lo + off) = rx_lo[i];
      *reinterpret_cast<int4*>(a_hi + off) = rx_hi[i];
      const uint32_t p[4] = {static_cast<uint32_t>(rw_lo[i].x), static_cast<uint32_t>(rw_lo[i].y),
                             static_cast<uint32_t>(rw_lo[i].z), static_cast<uint32_t>(rw_lo[i].w)};
      uint32_t lo[4], hi[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) unpack_w4(p[q], lo[q], hi[q]);
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
        uint32_t af[2][4];   // 32 bytes of k: m16n8k32
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
        const long o = (long)row * n + col;
        const int v0 = acc[mt][nt][2 * half];
        const int v1 = acc[mt][nt][2 * half + 1];
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

// T9 on x [M, K] and w [N, K], both K-major, into out [M, N]: byte maps
// over the rows' bytes, boxes of 128 bytes x 128 x rows, x 256 w rows and x
// 64 out rows.
template <int kKind>
int launch_gemm(const void* x, const void* w, const void*, const void*, const void*, void* out,
                void*, int, int m, int n, int k, cudaStream_t stream) {
  if (m == 0) return 0;
  const uint64_t k_bytes = static_cast<uint64_t>(k) * (kKind == kBf16 ? 2 : 1);
  const uint64_t n_bytes = static_cast<uint64_t>(n) * (kKind == kBf16 ? 2 : 4);
  CUtensorMap xm, wm, om;
  if (!hp::make_map_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, k_bytes, m, k_bytes, kGemmKBytes,
                       kGemmBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::make_map_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k_bytes, n, k_bytes, kGemmKBytes,
                       kGemmBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::make_map_2d(&om, CU_TENSOR_MAP_DATA_TYPE_UINT8, out, n_bytes, m, n_bytes, 128, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = gemm_wgmma_kernel<kKind>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemmSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int m_tiles = (m + kGemmBM - 1) / kGemmBM, n_tiles = (n + kGemmBN - 1) / kGemmBN;
  const int blocks = m_tiles * n_tiles < hp::sm_count() ? m_tiles * n_tiles : hp::sm_count();
  kernel<<<blocks, kGemmThreads, kGemmSmem, stream>>>(
      xm, wm, om, m, static_cast<int>(k_bytes), static_cast<int>(n_bytes), m_tiles, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kKind>
int launch_tiled(const void* x, const void* w, const void* xs, const void* wsb, const void*,
                 void* out, void* acc_out, int out_code, int m, int n, int k,
                 cudaStream_t stream) {
  const dim3 grid(n / kBN, (m + kBM - 1) / kBM);
  tiled_kernel<kKind><<<grid, kMmThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(wsb), out,
      static_cast<int*>(acc_out), out_code, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// T12 on x [M, K] and w4 [N, K/2]: byte maps, boxes of 128 bytes x 128 rows.
// Tiles are walked so that the smaller operand is the one re-read from L2.
int launch_w4_and(const void* x, const void* w, const void* xs, const void* wsb, const void* rs,
                  void* out, void* acc_out, int out_code, int m, int n, int k,
                  cudaStream_t stream) {
  const int k2 = k / 2;
  CUtensorMap xm, wm;
  if (!hp::make_map_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, k, m, k, kAndKStep, kAndBM,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::make_map_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k2, n, k2, kAndKStep, kAndBN,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      w4_and_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAndSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int m_tiles = (m + kAndBM - 1) / kAndBM, n_tiles = n / kAndBN;
  const int x_outer = (long)m * k < (long)n * k2 ? 0 : 1;
  const int blocks = m_tiles * n_tiles < hp::sm_count() ? m_tiles * n_tiles : hp::sm_count();
  w4_and_wgmma_kernel<<<blocks, kGemmThreads, kAndSmem, stream>>>(
      xm, wm, static_cast<const float*>(xs), static_cast<const float*>(wsb),
      static_cast<const int*>(rs), out, static_cast<int*>(acc_out), out_code, m, n, k, m_tiles,
      n_tiles, x_outer);
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
// w4 [N, K/2] (variants 2-4), all contiguous and 16-byte aligned (variants
// 0, 1 and 3 read x and w through TMA).  x_scale fp32 [M] and wsb fp32 [2,
// N] (the W4 tiled forms), rs int32 [M] = 8 * rowsum(x[:, :K/2]) (variants 3
// and 4), null otherwise.  out: int32 (0, 4), bf16 (1) or per out_code 0
// fp32 / 1 bf16 / 2 int8 (2, 3), [M, N]; acc_out int32 [M, N] or null (2, 3:
// the combined integer accumulator).  T9 and the W4 tiled forms take
// N % 128 == 0 and K % 128 == 0 (variants 0, 2, 3) or K % 64 == 0 (variant
// 1); the GEMV M <= 8 and K % 32 == 0; the wrappers check it.  The variant
// ids are those of physicedit_torch/tools/_proto_int8.py's VARIANTS.
#define MM_ARGS x, w, xs, wsb, rs, out, acc_out, out_code, m, n, k, s
extern "C" int proto_int8_matmul(int variant, const void* x, const void* w, const void* xs,
                                 const void* wsb, const void* rs, void* out, void* acc_out,
                                 int out_code, int m, int n, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_gemm<kI8>(MM_ARGS);          // T9, acc "i32"
    case 1: return launch_gemm<kBf16>(MM_ARGS);        // T9, acc "f32"
    case 2: return launch_tiled<kW4Unpack>(MM_ARGS);   // T10
    case 3: return launch_w4_and(MM_ARGS);             // T12
    case 4: return launch_gemv<kGemvRows>(MM_ARGS);    // T11
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef MM_ARGS

// The dynamic shared memory of one block of T9's and of T12's GEMM, for the
// report beside ptxas's.
extern "C" int proto_int8_matmul_gemm_smem_bytes() { return kGemmSmem; }
extern "C" int proto_int8_matmul_w4_and_smem_bytes() { return kAndSmem; }
