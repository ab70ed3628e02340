// The int8 and W4 matmul probes of tools/: T9's persistent TMA + wgmma GEMM,
// T10's and T12's W4 GEMMs on K3's TMA + wgmma loop and T11's decode GEMV,
// a TMA-fed tensor-core (mma.sync) product.
//
// Replaces the Pallas prototypes that the measurement tools in tools/ drive
// (their ports are physicedit_torch/tools/proto_*.py):
//   T9   tools/proto_int8_rate.py::pallas_mm (body _mm_kernel): acc "i32" is
//        int8 x [M, K] . int8 w -> int32, exact (kI8); acc "f32" the same
//        product on bf16 inputs with fp32 sums and a bf16 result (kBf16)
//   T10  tools/proto_prefill_blocks.py::i32_matmul (body _i32_kernel): W4A8
//        with the sign-extending unpack, lo = (b & 15) - 8, hi = b >> 4, into
//        one int32 accumulator (w4_wgmma_kernel<kW4Unpack>; K3's unpack_w4)
//   T12  tools/proto_w4_unpack.py::w4a8_i8_matmul (body _w4a8_i8_kernel):
//        W4A8 with the AND-only unpack, t = b & 0x0F (lo + 8) and
//        h16 = b & 0xF0 (16 hi, a valid int8), into two accumulators,
//        combined as acc - rs + (acc16 >> 4) with rs = 8 rowsum(x_lo)
//        (w4_wgmma_kernel<kW4And>; acc16 is a multiple of 16, so the shift
//        is exact)
//   T11  tools/proto_w4_gemv.py::gemv_and_only (body _gemv_kernel): T12's
//        integer part over m <= 8 decode rows, int32 out (gemv_mma_kernel)
// The W4 GEMMs end in the JAX epilogue, acc * x_scale * wsb[0] + wsb[1] in
// fp32, each step rounded (no FMA contraction), then fp32, bf16 or int8 (JAX's
// conversion: truncate toward 0 and saturate).
//
// Layouts (the port's, not the JAX tools'): x [M, K] row-major; T9's w is
// [N, K] and the W4 weights are K3's w4 [N, K/2] (csrc/mma_int8.cuh), so that
// one output column's k values are contiguous: both operands K-major, as
// int8 wgmma and mma.sync take them.  Byte j of column n holds w[n, j] + 8 in its low
// nibble and w[n, j + K/2] in its high nibble.
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
//  - T12 at the DiT image stream's fc1 (M16384 K3072 N12288) and T10 at the
//    VL prefill's gate+up (M1536 K3584 N37888, 0.21 ms): the tensor cores,
//    2 M N K int8 operations (T12 1.24e12, 0.63 ms at 1,979 TOP/s, against
//    0.47 GB moved).  Design (w4_wgmma_kernel, one template for both): K3's
//    tiled regime (w4a8_matmul.cu::w4a8_wgmma_kernel, whose design comment
//    holds), out^T = planes(w4) . x^T on a persistent grid of one block of
//    three warpgroups per SM, the producer's thread issuing per stage the
//    box of x's low half at j0, the one of its high half at j0 and the
//    packed box (128 rows x 128 bytes each, 128-byte swizzle) into a 3-stage
//    ring, each consumer warpgroup owning 64 weight rows.  x's halves have a
//    map each, K/2 bytes wide with a row pitch of K, so that where K/2 is no
//    multiple of the 128-byte stage (K = 384) the last stage reads zeros
//    past K/2 in x as in the packed box: T10's unpack turns a zero byte into
//    lo = -8, which must meet an x of 0.  The products go in one commit
//    group per plane, not per stage as K3's: a stage loads its 16 packed
//    words once, unpacks the low plane, issues its four wgmma m64n128k32
//    s32.s8.s8, waits until the previous stage's high group is done
//    (wgmma.wait_group 1; that stage is then released), unpacks the high
//    plane and issues its group, and waits until its own low group is done;
//    so a warpgroup always has one group in flight while it unpacks the
//    next, with 48 fragment registers beside the accumulators.  T12's
//    unpack is one AND a 32-bit word per plane, b & 0x0F0F0F0F (lo + 8) and
//    b & 0xF0F0F0F0 (16 hi), into two int32 accumulators of 64 registers a
//    thread; T10's is K3's, and both its planes' groups go into one
//    accumulator (successive wgmma of one shape into the same registers
//    are ordered by the hardware).  On an H100 T12 ran every DiT and VL
//    shape faster than the same kernel with K3's per-stage double buffer of
//    both planes, and faster than K3; T10, K3's own product on this loop,
//    ran 0.78-0.87x K3 at the DiT's image-stream shapes and the VL
//    prefill's gate+up, and faster than with that double buffer or with a
//    256-wide x tile (PERF.md §6).  Epilogue: T12's acc +
//    (acc16 >> 4) in registers (exact), T10's acc, then K3's XOR-swizzled
//    slab and row-wise stores (4 output columns a thread: 16, 8 or 4 bytes
//    for fp32, bf16, int8), T12's rs subtracted per row, the JAX epilogue
//    applied per row after the slab; the optional int32 result beside it.
//  - T11 (weights 0.5 byte each, 10-68 MB a call; m8 K3584 N37888: 68 MB,
//    0.0206 ms at 3.35 TB/s): reading the weights.  The old design (a warp
//    a column, dp4a) ran at 0.22-0.27 of that: for every 16 weight bytes a
//    lane loaded it re-read 8 x rows x 32 bytes through L1 (1.09 GB of L1
//    traffic a call at that shape) and spent 64 dp4a (2.7e8 a call).
//    Design (gemv_mma_kernel): A and B swapped, out^T [N, 8] = planes(w4)
//    [N, K] . x^T [K, 8], the weights as the 16-row A operand of int8
//    mma.sync m16n8k32 from registers (T12's fragment path: 16 packed words
//    a stage, one AND a plane) and x's 8 rows as its 8-wide B from shared
//    memory, so that the products leave the integer pipe and x the load
//    path.  A block owns 128 weight rows, 16 a consumer warp; its producer
//    warp keeps a ring of 3 stages of 18 KB in flight with TMA (the packed
//    box, 128 rows x 128 bytes, and the 8-row boxes of x's two halves, rows
//    past m as zeros), three blocks an SM: up to 162 KB in flight per SM.
//    Balanced work: the K stages are split over a cluster of up to 8 blocks
//    (the launcher's split: about six blocks an SM at every shape, 888
//    blocks at gate+up, 224 at down, 352 at qkv), each block sums its
//    stages, subtracts 8 rowsum(x_lo) of the x it staged (so rs needs no
//    launch of its own) and leaves its 128 x 8 part in shared memory, and
//    the cluster's rank 0 adds the parts through distributed shared memory
//    and stores: no atomics, no workspace, and the same bits at every call.
//    On an H100 wgmma m64n8k32 (the weights of a warpgroup as A) ran 1-3 %
//    slower than mma.sync in the same loop, and two blocks an SM with a
//    5-stage ring ran the qkv shape in 0.0142 ms against 0.0104 (PERF.md §6).
#include <type_traits>

#include "hopper_primitives.cuh"
#include "mma_bf16.cuh"
#include "mma_int8.cuh"

using namespace physicedit;
namespace hp = physicedit::hopper;

namespace {

// template arguments are ints so that they mangle as Li<n>E, which
// chip_smoke.py reads out of the ptxas report
constexpr int kI8 = 0, kBf16 = 1;                // T9's kind
constexpr int kW4Unpack = 2, kW4And = 3;        // the W4 GEMMs' unpack (T10, T12)
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

// The low and the high plane of four packed bytes, as an int8 product's A: T10's
// sign-extending unpack is K3's unpack_w4, lo = (b & 15) - 8 and hi = b >> 4
// (about 4 and 6 integer operations a word); the AND-only one of T12 and T11
// is one AND a plane, t = b & 0x0F (lo + 8) and h16 = b & 0xF0 (16 hi).
template <int kUnpack>
__device__ __forceinline__ uint32_t low_plane(uint32_t w) {
  if constexpr (kUnpack == kW4And) return w & 0x0F0F0F0Fu;
  uint32_t lo, hi;
  unpack_w4(w, lo, hi);
  return lo;
}

template <int kUnpack>
__device__ __forceinline__ uint32_t high_plane(uint32_t w) {
  if constexpr (kUnpack == kW4And) return w & 0xF0F0F0F0u;
  uint32_t lo, hi;
  unpack_w4(w, lo, hi);
  return hi;
}

// The W4 epilogue: acc * x_scale * w_scale + w_bias, each step rounded in fp32.
__device__ __forceinline__ float w4_epilogue(int acc, float xs, float ws, float wb) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws), wb);
}

// JAX's float -> int8: truncate toward 0, saturate.
__device__ __forceinline__ int8_t to_int8_sat(float v) {
  return static_cast<int8_t>(__float2int_rz(fminf(fmaxf(v, -128.f), 127.f)));
}

// ---- T10 and T12: the W4 GEMMs on K3's TMA + wgmma loop --------------------------

constexpr int kW4BM = 128;                     // x rows (output rows) per tile
constexpr int kW4BN = 128;                     // weight rows (output columns) per tile, 64 a consumer
constexpr int kW4KStep = 128;                  // packed bytes per stage: 128 low + 128 high k
constexpr int kW4Stages = 3;
constexpr int kW4XBox = kW4BM * kW4KStep;      // one x box: 16 KB
constexpr int kW4StageBytes = 2 * kW4XBox + kW4BN * kW4KStep;   // + the packed box: 48 KB
constexpr int kW4Ring = kW4Stages * kW4StageBytes;
constexpr int kW4SlabBytes = kW4BM * 64 * 4;   // a consumer's int32 tile: 32 KB
// the ring, the two slabs, the barriers and room to align the ring to 1 KB
constexpr int kW4Smem = kW4Ring + 2 * kW4SlabBytes + 2 * kW4Stages * 8 + 1024;

// Tile t of the walk: x tiles outer (consecutive tiles share an x tile and
// walk the weights) or weight tiles outer, as K3's.
__device__ __forceinline__ void w4_tile(int t, int m_tiles, int n_tiles, int x_outer, int& m0,
                                        int& n0) {
  m0 = (x_outer ? t / n_tiles : t % m_tiles) * kW4BM;
  n0 = (x_outer ? t % n_tiles : t / m_tiles) * kW4BN;
}

// The tile's epilogue, while the producer fills the ring for the next tile:
// the warpgroup stages its int32 sums value(i) (accumulator i) in its slab (x
// row r, weight row c of its 64 at int r * 64 + (c ^ 8 ((r / 2) % 4)), so
// that neither the writes nor the reads conflict), then writes out row by
// row, 4 output columns a thread (16, 8 or 4 bytes for fp32, bf16, int8),
// with rs subtracted per row where kRowSums (integer sums in any order are
// exact) and the JAX epilogue applied; the optional int32 result beside it.
// Scales, biases and row sums are read before the slab is free, their
// latency under the barrier.
template <bool kRowSums, class Value>
__device__ __forceinline__ void w4_tile_epilogue(Value value, uint32_t slab, const float* xs,
                                                 const float* wsb, const int* rs, void* out,
                                                 int* acc_out, int out_code, int m, int n,
                                                 int m0, int n0, int cw) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, g = tid % 32 / 4, t = tid % 4;
  // the thread's share: 4 weight rows (16 bytes of int32) of x rows tid / 16 + 8 i
  const int ch = tid % 16, r_first = tid / 16;
  const int col = n0 + 64 * cw + 4 * ch;
  const float4 wsc = *reinterpret_cast<const float4*>(wsb + col);
  const float4 wbc = *reinterpret_cast<const float4*>(wsb + n + col);
  float xsr[kW4BM / 8];
  int rsr[kW4BM / 8];
#pragma unroll
  for (int i = 0; i < kW4BM / 8; ++i) {
    const int row = m0 + r_first + 8 * i;
    xsr[i] = row < m ? xs[row] : 0.f;
    rsr[i] = kRowSums && row < m ? rs[row] : 0;
  }
  hp::named_sync(2 + cw, 128);   // the slab's previous tile has been read
#pragma unroll
  for (int nb = 0; nb < kW4BM / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * nb + 2 * t + (e & 1);          // x row within the tile
      const int c = 16 * warp + g + 8 * (e >> 1);       // weight row within the 64
      hp::sts32(slab + (r * 64 + (c ^ (8 * ((r >> 1) & 3)))) * 4,
                static_cast<uint32_t>(value(4 * nb + e)));
    }
  }
  hp::named_sync(2 + cw, 128);
  const float sc[4] = {wsc.x, wsc.y, wsc.z, wsc.w};
  const float bc[4] = {wbc.x, wbc.y, wbc.z, wbc.w};
#pragma unroll
  for (int i = 0; i < kW4BM / 8; ++i) {
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

// kUnpack: kW4Unpack (T10: one accumulator, no row sums) or kW4And (T12: two
// accumulators, acc - rs + (acc16 >> 4)).  xlo_map and xhi_map are x's two
// halves, each K/2 bytes wide, so that a K/2 that ends inside the last
// 128-byte stage reads zeros past it in both.
template <int kUnpack>
__global__ void __launch_bounds__(kGemmThreads, 1)
w4_wgmma_kernel(const __grid_constant__ CUtensorMap xlo_map,
                const __grid_constant__ CUtensorMap xhi_map,
                const __grid_constant__ CUtensorMap wmap, const float* __restrict__ xs,
                const float* __restrict__ wsb, const int* __restrict__ rs,
                void* __restrict__ out, int* __restrict__ acc_out, int out_code, int m, int n,
                int k, int m_tiles, int n_tiles, int x_outer) {
  constexpr bool kAnd = kUnpack == kW4And;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = hp::smem_u32(smem_raw);
  const uint32_t ring = (raw_base + 1023u) & ~1023u;
  const uint32_t slabs = ring + kW4Ring;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (ring - raw_base) + kW4Ring +
                                               2 * kW4SlabBytes);
  uint64_t* empty = full + kW4Stages;

  const int n_tiles_all = m_tiles * n_tiles;
  const int n_steps = ((k >> 1) + kW4KStep - 1) / kW4KStep;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kW4Stages; ++s) {
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
        w4_tile(tile, m_tiles, n_tiles, x_outer, m0, n0);
        for (int j = 0; j < n_steps; ++j, ++it) {
          const int s = it % kW4Stages;
          hp::mbar_wait(&empty[s], ((it / kW4Stages) & 1) ^ 1);
          hp::mbar_expect_tx(&full[s], kW4StageBytes);
          const uint32_t dst = ring + s * kW4StageBytes;
          hp::tma_load_2d(dst, &xlo_map, &full[s], j * kW4KStep, m0);
          hp::tma_load_2d(dst + kW4XBox, &xhi_map, &full[s], j * kW4KStep, m0);
          hp::tma_load_2d(dst + 2 * kW4XBox, &wmap, &full[s], j * kW4KStep, n0);
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
  const uint32_t a_row = (64 * cw + 16 * warp + g) * kW4KStep + 4 * t;
  const uint32_t slab = slabs + cw * kW4SlabBytes;

  // the low plane's sums and, for T12, the high plane's; T10 sums both
  // planes into acc (acc16 unused)
  int acc[64], acc16[64];
  int (&acc_hi)[64] = kAnd ? acc16 : acc;
  uint32_t packed[16];      // a stage's A fragments, packed: 4 k-steps x 4
  uint32_t lo[16], hi[16];  // the two planes' fragments
  int it = 0;               // the ring position of the tile's first stage

  // Stage j of the tile: the low plane's products, then (once stage j - 1's
  // high products are done, and that stage released) the high plane's.
  auto stage = [&](int j) {
    const int s = (it + j) % kW4Stages;
    hp::mbar_wait(&full[s], ((it + j) / kW4Stages) & 1);
    const uint32_t base = ring + s * kW4StageBytes;
    const uint32_t w = base + 2 * kW4XBox + a_row;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t c0 = ((2 * ks) ^ g) * 16, c1 = ((2 * ks + 1) ^ g) * 16;
      packed[4 * ks] = hp::lds32(w + c0);
      packed[4 * ks + 1] = hp::lds32(w + 8 * kW4KStep + c0);
      packed[4 * ks + 2] = hp::lds32(w + c1);
      packed[4 * ks + 3] = hp::lds32(w + 8 * kW4KStep + c1);
    }
    // lo was last read by stage j - 1's low products, done by its last wait
#pragma unroll
    for (int i = 0; i < 16; ++i) lo[i] = low_plane<kUnpack>(packed[i]);
    hp::fence_regs(lo);
    hp::fence_regs(acc);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_s8_rs(acc, lo[4 * ks], lo[4 * ks + 1], lo[4 * ks + 2], lo[4 * ks + 3],
                      hp::sw128_desc(base + 32 * ks, 16, 1024));
    hp::wgmma_commit();
    hp::wgmma_wait<1>();   // stage j - 1's high products are done: hi is free
    if constexpr (kAnd) hp::fence_regs(acc16);
    hp::fence_regs(hi);
    if (j > 0) {
      __syncwarp();
      if (signals) hp::mbar_arrive(&empty[(it + j - 1) % kW4Stages]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) hi[i] = high_plane<kUnpack>(packed[i]);
    hp::fence_regs(hi);
    hp::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      hp::wgmma_s8_rs(acc_hi, hi[4 * ks], hi[4 * ks + 1], hi[4 * ks + 2], hi[4 * ks + 3],
                      hp::sw128_desc(base + kW4XBox + 32 * ks, 16, 1024));
    hp::wgmma_commit();
    hp::wgmma_wait<1>();   // stage j's low products are done: lo is free
    hp::fence_regs(acc);
    hp::fence_regs(lo);
  };

  for (int tile = blockIdx.x; tile < n_tiles_all; tile += gridDim.x) {
    int m0, n0;
    w4_tile(tile, m_tiles, n_tiles, x_outer, m0, n0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = acc_hi[i] = 0;
    for (int j = 0; j < n_steps; ++j) stage(j);
    hp::wgmma_wait_all();
    hp::fence_regs(acc);
    if constexpr (kAnd) hp::fence_regs(acc16);
    hp::fence_regs(hi);
    __syncwarp();
    if (signals) hp::mbar_arrive(&empty[(it + n_steps - 1) % kW4Stages]);
    it += n_steps;
    // T12's planes combined: acc16 is a multiple of 16, so the shift is exact
    if constexpr (kAnd)
      w4_tile_epilogue<true>([&](int i) { return acc[i] + (acc16[i] >> 4); }, slab, xs, wsb,
                             rs, out, acc_out, out_code, m, n, m0, n0, cw);
    else
      w4_tile_epilogue<false>([&](int i) { return acc[i]; }, slab, xs, wsb, rs, out, acc_out,
                              out_code, m, n, m0, n0, cw);
  }
}

// ---- T11: the AND-only W4 GEMV, a TMA-fed tensor-core product -----------------

constexpr int kGemvRows = 8;                   // x rows: mma.sync's N
constexpr int kGemvBN = 128;                   // weight rows (output columns) a block, 16 a warp
constexpr int kGemvKStep = 128;                // packed bytes a stage
constexpr int kGemvStages = 3;
constexpr int kGemvWBox = kGemvBN * kGemvKStep;                       // 16 KB
constexpr int kGemvXBox = kGemvRows * kGemvKStep;                     // 1 KB
constexpr int kGemvStageBytes = kGemvWBox + 2 * kGemvXBox;            // 18 KB
constexpr int kGemvPartBytes = kGemvRows * kGemvBN * 4;               // the block's sums: 4 KB
constexpr int kGemvThreads = 288;              // eight consumer warps and the producer warp
constexpr int kGemvMaxSplit = 8;               // the portable cluster size
// the ring, the partial sums, the row sums, the barriers and room to align
// the ring to 1 KB; three blocks an SM
constexpr int kGemvSmem =
    kGemvStages * kGemvStageBytes + kGemvPartBytes + kGemvRows * 4 + 2 * kGemvStages * 8 + 1024;

// Block b: weight rows 128 (b / split) .., k-stages [rank S / split, (rank +
// 1) S / split) of the S = ceil(K / 256) stages, rank = b % split its rank
// in a cluster of `split` blocks, which sum their parts through
// distributed shared memory.
__global__ void __launch_bounds__(kGemvThreads, 3)
gemv_mma_kernel(const __grid_constant__ CUtensorMap xlo_map,
                const __grid_constant__ CUtensorMap xhi_map,
                const __grid_constant__ CUtensorMap wmap, int* __restrict__ out, int m, int n,
                int k, int split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = hp::smem_u32(smem_raw);
  const uint32_t ring = (raw_base + 1023u) & ~1023u;
  const uint32_t part = ring + kGemvStages * kGemvStageBytes;   // int [8 x rows][128]
  const uint32_t row_sums = part + kGemvPartBytes;              // int [8]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + (row_sums + kGemvRows * 4 - raw_base));
  uint64_t* empty = full + kGemvStages;

  const uint32_t rank = hp::cluster_ctarank();
  const int n0 = blockIdx.x / split * kGemvBN;
  const int n_steps = ((k >> 1) + kGemvKStep - 1) / kGemvKStep;
  const int j_begin = rank * n_steps / split, j_end = (rank + 1) * n_steps / split;
  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kGemvStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kGemmConsumerWarps);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_id == kGemmConsumerWarps) {   // the producer warp: one thread issues the loads
    if (lane == 0) {
      for (int j = j_begin, it = 0; j < j_end; ++j, ++it) {
        const int s = it % kGemvStages;
        hp::mbar_wait(&empty[s], ((it / kGemvStages) & 1) ^ 1);
        hp::mbar_expect_tx(&full[s], kGemvStageBytes);
        const uint32_t dst = ring + s * kGemvStageBytes;
        hp::tma_load_2d(dst, &wmap, &full[s], j * kGemvKStep, n0);
        hp::tma_load_2d(dst + kGemvWBox, &xlo_map, &full[s], j * kGemvKStep, 0);
        hp::tma_load_2d(dst + kGemvWBox + kGemvXBox, &xhi_map, &full[s], j * kGemvKStep, 0);
      }
    }
    __syncwarp();
  } else {
    const int g = lane / 4, t = lane % 4;
    // the thread's A rows: weight row 16 warp_id + g and that + 8, whose
    // 16-byte chunk c sits at chunk c ^ g of its 128-byte row (g = row % 8),
    // and its B column: x row g, the same chunks
    const uint32_t a_row = (16 * warp_id + g) * kGemvKStep + 4 * t;
    const uint32_t b_row = kGemvWBox + g * kGemvKStep + 4 * t;
    int acc[4] = {0, 0, 0, 0}, acc16[4] = {0, 0, 0, 0};   // the two planes' sums
    int xsum = 0;   // the sum of x_lo's row warp_id over this lane's word of each stage
    uint32_t lo[16], hi[16];
    for (int j = j_begin, it = 0; j < j_end; ++j, ++it) {
      const int s = it % kGemvStages;
      hp::mbar_wait(&full[s], (it / kGemvStages) & 1);
      const uint32_t base = ring + s * kGemvStageBytes;
      const uint32_t w = base + a_row;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t c0 = ((2 * ks) ^ g) * 16, c1 = ((2 * ks + 1) ^ g) * 16;
        const uint32_t p[4] = {hp::lds32(w + c0), hp::lds32(w + 8 * kGemvKStep + c0),
                               hp::lds32(w + c1), hp::lds32(w + 8 * kGemvKStep + c1)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          lo[4 * ks + q] = low_plane<kW4And>(p[q]);
          hi[4 * ks + q] = high_plane<kW4And>(p[q]);
        }
      }
      // a swizzled row keeps its 128 bytes, so a row's sum is its words' sum
      xsum = __dp4a(static_cast<int>(hp::lds32(base + kGemvWBox + warp_id * kGemvKStep +
                                               4 * lane)),
                    0x01010101, xsum);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {   // B: k 4t.. and 16 + 4t.. of x row g
        const uint32_t xb = base + b_row;
        const uint32_t c0 = ((2 * ks) ^ g) * 16, c1 = ((2 * ks + 1) ^ g) * 16;
        mma_s8_16832(acc, &lo[4 * ks], hp::lds32(xb + c0), hp::lds32(xb + c1));
        mma_s8_16832(acc16, &hi[4 * ks], hp::lds32(xb + kGemvXBox + c0),
                     hp::lds32(xb + kGemvXBox + c1));
      }
      __syncwarp();
      if (lane == 0) hp::mbar_arrive(&empty[s]);
    }
    // 8 rowsum(x_lo) over this block's stages: warp w holds x row w's
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) xsum += __shfl_xor_sync(0xffffffffu, xsum, off);
    if (lane == 0) hp::sts32(row_sums + 4 * warp_id, static_cast<uint32_t>(8 * xsum));
    hp::named_sync(1, kGemmConsumerWarps * 32);
    // the block's part: acc - rs + (acc16 >> 4) (acc16 sums multiples of 16,
    // so the shift is exact), x row r, weight row c at int r * 128 + c
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 2 * t + (e & 1), c = 16 * warp_id + g + 8 * (e >> 1);
      hp::sts32(part + 4 * (r * kGemvBN + c),
                static_cast<uint32_t>(acc[e] - static_cast<int>(hp::lds32(row_sums + 4 * r)) +
                                      (acc16[e] >> 4)));
    }
  }
  hp::cluster_sync();   // every block's part is written
  if (rank == 0 && warp_id < kGemmConsumerWarps) {
    for (int i = threadIdx.x; i < kGemvRows * kGemvBN; i += kGemmConsumerWarps * 32) {
      const int r = i / kGemvBN, c = i % kGemvBN;
      if (r < m && n0 + c < n) {
        int sum = 0;
        for (int q = 0; q < split; ++q)
          sum += static_cast<int>(hp::ld_cluster_u32(part + 4 * i, q));
        out[(long)r * n + n0 + c] = sum;
      }
    }
  }
  hp::cluster_sync();   // no block leaves while rank 0 still reads its part
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

// T10 and T12 on x [M, K] and w4 [N, K/2]: byte maps of x's two halves (K/2
// bytes wide, row pitch K) and of w4, boxes of 128 bytes x 128 rows.  Tiles
// are walked so that the smaller operand is the one re-read from L2.
template <int kUnpack>
int launch_w4(const void* x, const void* w, const void* xs, const void* wsb, const void* rs,
              void* out, void* acc_out, int out_code, int m, int n, int k, cudaStream_t stream) {
  const int k2 = k / 2;
  CUtensorMap xlo, xhi, wm;
  if (!hp::make_map_2d(&xlo, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, k2, m, k, kW4KStep, kW4BM,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::make_map_2d(&xhi, CU_TENSOR_MAP_DATA_TYPE_UINT8, static_cast<const int8_t*>(x) + k2,
                       k2, m, k, kW4KStep, kW4BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::make_map_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k2, n, k2, kW4KStep, kW4BN,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = w4_wgmma_kernel<kUnpack>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kW4Smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int m_tiles = (m + kW4BM - 1) / kW4BM, n_tiles = n / kW4BN;
  const int x_outer = (long)m * k < (long)n * k2 ? 0 : 1;
  const int blocks = m_tiles * n_tiles < hp::sm_count() ? m_tiles * n_tiles : hp::sm_count();
  kernel<<<blocks, kGemmThreads, kW4Smem, stream>>>(
      xlo, xhi, wm, static_cast<const float*>(xs), static_cast<const float*>(wsb),
      static_cast<const int*>(rs), out, static_cast<int*>(acc_out), out_code, m, n, k, m_tiles,
      n_tiles, x_outer);
  return static_cast<int>(cudaGetLastError());
}

// T11 on x [m <= 8, K] and w4 [N, K/2]: the maps of T10's with 8-row x boxes
// (rows past m and columns past K/2 arrive as zeros, as do weight rows past
// N).  K is split over a cluster of `split` blocks so that the grid holds
// about six blocks an SM at every shape (three run at once on each), and no
// block has fewer than one stage.
int launch_gemv(const void* x, const void* w, const void*, const void*, const void*, void* out,
                void*, int, int m, int n, int k, cudaStream_t stream) {
  if (m > kGemvRows) return static_cast<int>(cudaErrorInvalidValue);
  const int k2 = k / 2;
  CUtensorMap xlo, xhi, wm;
  if (!hp::make_map_2d(&xlo, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, k2, m, k, kGemvKStep, kGemvRows,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::make_map_2d(&xhi, CU_TENSOR_MAP_DATA_TYPE_UINT8, static_cast<const int8_t*>(x) + k2,
                       k2, m, k, kGemvKStep, kGemvRows, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hp::make_map_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, k2, n, k2, kGemvKStep, kGemvBN,
                       CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGemvSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (n + kGemvBN - 1) / kGemvBN;
  const int n_steps = (k2 + kGemvKStep - 1) / kGemvKStep;
  int split = (6 * hp::sm_count() + tiles - 1) / tiles;
  split = split < kGemvMaxSplit ? split : kGemvMaxSplit;
  split = split < n_steps ? split : n_steps;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles * split);
  config.blockDim = dim3(kGemvThreads);
  config.dynamicSmemBytes = kGemvSmem;
  config.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&config, gemv_mma_kernel, xlo, xhi, wm,
                                                  static_cast<int*>(out), m, n, k, split);
  if (launched != cudaSuccess) return static_cast<int>(launched);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [M, K] (int8; bf16 for variant 1), w [N, K] (int8; bf16 for variant 1) or
// w4 [N, K/2] (variants 2-4), all contiguous and 16-byte aligned (every
// variant reads x and w through TMA).  x_scale fp32 [M] and wsb fp32 [2, N]
// (the W4 tiled forms), rs int32 [M] = 8 * rowsum(x[:, :K/2]) (variant 3;
// variant 4 computes it itself), null otherwise.  out: int32 (0, 4), bf16
// (1) or per out_code 0 fp32 / 1 bf16 / 2 int8 (2, 3), [M, N]; acc_out int32
// [M, N] or null (2, 3: the combined integer accumulator).  T9 and the W4
// tiled forms take N % 128 == 0 and K % 128 == 0 (variants 0, 2, 3) or K %
// 64 == 0 (variant 1); the GEMV M <= 8, any N and K % 32 == 0; the wrappers
// check it.  The variant ids are those of
// physicedit_torch/tools/_proto_int8.py's VARIANTS.
#define MM_ARGS x, w, xs, wsb, rs, out, acc_out, out_code, m, n, k, s
extern "C" int proto_int8_matmul(int variant, const void* x, const void* w, const void* xs,
                                 const void* wsb, const void* rs, void* out, void* acc_out,
                                 int out_code, int m, int n, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_gemm<kI8>(MM_ARGS);        // T9, acc "i32"
    case 1: return launch_gemm<kBf16>(MM_ARGS);      // T9, acc "f32"
    case 2: return launch_w4<kW4Unpack>(MM_ARGS);    // T10
    case 3: return launch_w4<kW4And>(MM_ARGS);       // T12
    case 4: return launch_gemv(MM_ARGS);             // T11
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef MM_ARGS

// The dynamic shared memory of one block of T9's GEMM, of T10's and T12's and
// of T11's GEMV, for the report beside ptxas's.
extern "C" int proto_int8_matmul_gemm_smem_bytes() { return kGemmSmem; }
extern "C" int proto_int8_matmul_w4_smem_bytes() { return kW4Smem; }
extern "C" int proto_int8_matmul_gemv_smem_bytes() { return kGemvSmem; }
