// The Hopper attention mainloop shared by K1 (fixedmax_attention.cu), K2
// (gqa_causal_attention.cu), K7 / K1' scaled (fixedmax_attention_bias.cu),
// K10 / K10b (online_attention.cu), the prototypes T1-T3, T5, T7 and T8
// (proto_fixedmax_attention.cu) and T4 (proto_int8qk_attention.cu): head_dim
// 128, bf16 P and V, fp32 output accumulators; Q K^T in bf16 with fp32 S, or
// (a Policy whose Score is int: T4) in int8 with exact int32 S.
// Its primitives (mbarriers, TMA, wgmma, named barriers, cp.async:
// hopper_primitives.cuh) also build K8's two backward passes
// (fixedmax_attention_bwd.cu).
//
// One block of three warpgroups (384 threads) per 128-row q tile:
//   warpgroup 0, the producer, gives its registers back (setmaxnreg.dec);
//     one thread issues the TMA loads (Q once, then K and V tiles of 128
//     keys into a ring of kStages stages), and warp 1 writes each K stage's
//     128-bit key-liveness word (key < S_k and the key mask);
//   warpgroups 1 and 2, the consumers, take more registers
//     (setmaxnreg.inc) and own 64 query rows each.
// A consumer walks the key tiles in phases: phase j issues O += P(j-1) V(j-1)
// (A = P from registers, B = V from shared memory, MN-major) and
// S(j) = Q K(j)^T (both operands K-major in shared memory) as wgmma.mma_async
// m64n128k16 products (int8: m64n128k32), waits for both, releases V(j-1) and K(j), and turns
// S(j) into P(j) in registers through the kernel's Policy (K1, K7: fixed-max
// exp2; K2, K10: the online softmax, K2's with the causal mask).  The two consumers
// take turns (ping-pong) through two named barriers, so one warpgroup's
// softmax runs while the other's products own the tensor cores.
//
// Shared memory: Q 32 KB + kStages x (K 32 KB + V 32 KB), each tile two TMA
// boxes of [128 rows x 64 d] bf16 with the 128-byte swizzle that wgmma's
// descriptors name (layout type 1), so nothing is transposed or re-staged.
// An int8 Q or K tile is one box of [128 rows x 128 d] bytes (16 KB).
// Barriers: one mbarrier for Q; per stage a full barrier (the TMA's bytes;
// K's also the liveness word's arrive) and an empty barrier for K and for V
// separately, so that K(j+1) can land while V(j) is still read.  Every
// consumer warp arrives on an empty barrier once it is done with the stage
// (its wgmma waited for, its read of the liveness word behind a __syncwarp):
// wgmma.wait_group and a warp's loads order nothing across the warpgroup, so
// one arrive per warpgroup would let the producer overwrite a word that a
// late warp has not read yet.
//
// The tensor maps are built on the host each call (hopper_primitives.cuh)
// and passed as __grid_constant__ kernel parameters.
#pragma once

#include <type_traits>

#include "hopper_primitives.cuh"
#include "mma_bf16.cuh"

namespace physicedit {
namespace hopper {

constexpr int kTile = 128;                   // q rows per block, keys per stage
constexpr int kStages = 2;
constexpr int kBlockThreads = 384;
constexpr int kBoxBytes = kTile * 64 * 2;    // one TMA box: 128 rows x 64 d, 16 KB
constexpr int kTileBytes = 2 * kBoxBytes;    // 128 rows x 128 d, 32 KB
constexpr int kTileBytesI8 = kTile * 128;    // int8 Q or K: one box, 128 rows x 128 d, 16 KB
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;           // 40 x 128 + 232 x 256 <= 65536
constexpr int kConsumerWarps = 8;            // two consumer warpgroups

// kQkBytes: the bytes of a Q or K tile, kTileBytes (bf16) or kTileBytesI8.
template <int kQkBytes>
struct __align__(1024) SharedStorageT {
  uint8_t q[kQkBytes];
  uint8_t k[kStages][kQkBytes];
  uint8_t v[kStages][kTileBytes];
  uint32_t live[kStages][4];                 // bit c of word w: key 32 w + c of the tile
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};
using SharedStorage = SharedStorageT<kTileBytes>;
using SharedStorageI8 = SharedStorageT<kTileBytesI8>;

// Dynamic shared memory per block: the storage plus room to align it to 1 KB
// (the 128-byte swizzle repeats every 1024 bytes).
constexpr int kSmemBytes = static_cast<int>(sizeof(SharedStorage)) + 1024;
constexpr int kSmemBytesI8 = static_cast<int>(sizeof(SharedStorageI8)) + 1024;

template <class Storage = SharedStorage>
__device__ __forceinline__ Storage& shared_storage() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  return *reinterpret_cast<Storage*>(smem_raw + (((base + 1023u) & ~1023u) - base));
}

// Dynamic shared memory a Policy asks for beyond the storage (K7's bias
// slots): it starts 1 KB-aligned right after the storage, so a kernel that
// asks for none (K1, K2) keeps kSmemBytes.
template <class Storage = SharedStorage>
__device__ __forceinline__ uint32_t extra_smem_u32() {
  return smem_u32(&shared_storage<Storage>()) + static_cast<uint32_t>(sizeof(Storage));
}

#define PE_WGMMA_D64                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),            \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), \
      "+f"(d[63])

#define PE_WGMMA_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128]^T, A and B K-major in shared
// memory.  Accumulator layout (warp w of the warpgroup, g = lane / 4,
// t = lane % 4): d[4 n + 2 i + j] is row 16 w + g + 8 i, column 8 n + 2 t + j.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PE_WGMMA_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PE_WGMMA_D64
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A from registers (the layout of
// mma.sync's m16n8k16 A fragment per warp: a0 rows g / cols 2t.., a1 rows
// g+8, a2 cols 2t+8.., a3 both), B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PE_WGMMA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : PE_WGMMA_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

#define PE_WGMMA_D32                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),            \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64]^T, A and B K-major in shared
// memory (the backward's score products over 64-row stream tiles).
// Accumulator layout as wgmma_ss's with n < 8: d[4 n + 2 i + j] is row
// 16 w + g + 8 i, column 8 n + 2 t + j.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PE_WGMMA_D32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef PE_WGMMA_D32
#undef PE_WGMMA_D64
#undef PE_WGMMA_REGS64

// S = Q K^T over d = 128: 8 k-steps of 16; the two 64-d boxes of each tile
// lie kBoxBytes apart, and a k-step inside a box is 32 bytes along the row.
__device__ __forceinline__ void qk_product(float (&s)[64], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const uint32_t off = (ks >> 2) * kBoxBytes + (ks & 3) * 32;
    wgmma_ss(s, sw128_desc(q_rows + off, 16, 1024), sw128_desc(k_tile + off, 16, 1024),
             ks > 0);
  }
}

// S = Q K^T over d = 128 in int8, exact in int32: 4 k-steps of 32 bytes along
// the single 128-byte box row of each tile.
__device__ __forceinline__ void qk_product(int (&s)[64], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_s8_ss(s, sw128_desc(q_rows + 32 * ks, 16, 1024), sw128_desc(k_tile + 32 * ks, 16, 1024),
                ks > 0);
}

// O += P V over 128 keys: 8 k-steps of 16 keys (2048 bytes of V each); V is
// MN-major, its two 64-d boxes kBoxBytes apart (the leading byte offset).
// p[i] holds P's columns as packed bf16 pairs: p[4 ks + r] is the A fragment
// register r of k-step ks.
__device__ __forceinline__ void pv_product(float (&o)[64], const uint32_t (&p)[32],
                                           uint32_t v_tile) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    wgmma_rs(o, p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3],
             sw128_desc(v_tile + ks * 2048, kBoxBytes, 1024));
  }
}

// The same over 64 rows of B (4 k-steps), B a 64-row tile whose two 64-d
// boxes lie kBoxBytes / 2 apart: the backward's dS.K, P^T.g and dS^T.q'.
__device__ __forceinline__ void pv_product64(float (&o)[64], const uint32_t (&p)[16],
                                             uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    wgmma_rs(o, p[4 * ks], p[4 * ks + 1], p[4 * ks + 2], p[4 * ks + 3],
             sw128_desc(b_tile + ks * 2048, kBoxBytes / 2, 1024));
  }
}

// S[64 x 64] = A B^T over d = 128, A 64 rows of a 128-row tile (its boxes
// kBoxBytes apart), B a 64-row tile (boxes kBoxBytes / 2 apart).
__device__ __forceinline__ void qk_product64(float (&s)[32], uint32_t a_rows, uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const uint32_t in_box = (ks & 3) * 32;
    wgmma_ss64(s, sw128_desc(a_rows + (ks >> 2) * kBoxBytes + in_box, 16, 1024),
               sw128_desc(b_tile + (ks >> 2) * (kBoxBytes / 2) + in_box, 16, 1024), ks > 0);
  }
}

// The wgmma accumulator viewed as mma.sync's [16][4] C fragments (the same
// layout: d[4 n + e] is fragment n, element e), for store_rows.
__device__ __forceinline__ const float (&as_rows(const float (&d)[64]))[16][4] {
  return *reinterpret_cast<const float(*)[16][4]>(&d);
}

// 2^x on the special-function unit, subnormal results flushed to 0 (exp2f
// adds a range test and two multiplies per call to keep them).
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool all_live(uint4 word) {
  return (word.x & word.y & word.z & word.w) == 0xffffffffu;
}

// ---- a head-shared fp32 bias staged in shared memory (K7, K10b) -----------

// Each consumer warp's own 8 KB: its 16 q rows x 128 keys of the tile, fp32.
constexpr int kBiasSlotBytes = kConsumerWarps * 16 * kTile * 4;   // 64 KB

// The bias rows of one batch row, [S_q, S_k] fp32 with a row pitch, staged
// tile by tile in each consumer warp's slots past SharedStorage.  The warp
// copies tile j + 1's rows with cp.async right after its softmax has read
// tile j's (release), and waits for them at the start of softmax(j + 1)
// (wait): the copies have a whole phase (both consumers' products) to land.
// Only the warp reads what it copied, so a __syncwarp on each side of the
// reads is the whole handshake, and the producer warpgroup is unchanged.
// Row r, key c sits at float r * 128 + (c ^ 8 (r % 4)) of the warp's 8 KB,
// so that a 16-byte copy of 4 keys stays whole and both the copies (8 lanes
// x 16 B) and the reads (16 lanes x 8 B: rows g, keys 8 nb + 2t) hit 32
// distinct banks.  A warp instruction copies a whole row (512 B, four full
// lines, cp.async.cg: no L1 allocation) with 16-byte copies where `wide`
// (pitch and batch stride multiples of 4 floats, base 16-byte aligned), or
// 128 B with 4-byte ones otherwise; keys past S_k are zero-filled, a row
// past S_q reads the last row (never written out).  TMA cannot take the
// bias: its row pitch S_k x 4 bytes is a multiple of 16 only when
// S_k % 4 == 0, and text lengths make S_k arbitrary.
struct BiasSlots {
  const float* rows;      // this batch row's bias rows
  long pitch;             // floats from one row to the next
  bool wide;
  int sq, sk;
  int rw;                 // the warp's first q row (set by begin)
  uint32_t wslot;         // shared address of the warp's 16 x 128 tile
  uint32_t rslot;         // the thread's read address: row g, key 2t, unswizzled

  __device__ __forceinline__ void prefetch(int j) const {
    const int lane = threadIdx.x % 32;
    const int k0 = j * kTile;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float* src = rows + (long)min(rw + r, sq - 1) * pitch;
      const uint32_t dst = wslot + r * 512;
      if (wide) {
        const int key = k0 + 4 * lane;
        const int n = min(max(sk - key, 0), 4);
        cp_async_16(dst + ((4 * lane) ^ (8 * (r % 4))) * 4, n ? src + key : src, 4 * n);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + 32 * c + lane;
          cp_async_4(dst + ((32 * c + lane) ^ (8 * (r % 4))) * 4, key < sk ? src + key : src,
                     key < sk ? 4u : 0u);
        }
      }
    }
    cp_async_commit();
  }

  // Once per consumer thread: q_row is the q row of its first accumulator
  // row; starts the copies of tile 0.
  __device__ __forceinline__ void begin(int q_row, int t) {
    const int g = (threadIdx.x % 32) / 4;
    rw = q_row - g;
    wslot = extra_smem_u32() + (threadIdx.x / 32 - 4) * 8192;
    rslot = wslot + g * 512 + 8 * t;
    prefetch(0);
  }

  // Before the reads of a tile: the warp's copies are visible to every lane.
  __device__ __forceinline__ void wait() const {
    cp_async_wait_all();
    __syncwarp();
  }

  // Rows g (b0) and g + 8 (b1), keys 8 nb + 2t and + 1 of the staged tile.
  __device__ __forceinline__ void read(int nb, float2& b0, float2& b1) const {
    const uint32_t at = rslot + 32 * (nb ^ ((threadIdx.x / 4) % 4));
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(b0.x), "=f"(b0.y) : "r"(at));
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(b1.x), "=f"(b1.y) : "r"(at + 8 * 512));
  }

  // After the reads of tile j: every lane has read its slots; start tile j + 1.
  __device__ __forceinline__ void release(int j, int n_tiles) const {
    __syncwarp();
    if (j + 1 < n_tiles) prefetch(j + 1);
  }
};

// ---- the mainloop ----------------------------------------------------------

// Policy supplies, for one block:
//   using Score = int;                 optional: int8 Q and K tiles, Q K^T in
//                                      int8 into int32 S (float without it:
//                                      bf16 tiles, fp32 S); s below is a
//                                      Score array
//   int n_tiles;                       key tiles to walk (>= 1)
//   void load_q(uint32_t dst, uint64_t* bar);   TMA of the q tile (two boxes)
//   void load_k(uint32_t dst, int j, uint64_t* bar), load_v(...): tile j
//   bool live(int key);                 key < S_k and not masked
//   void softmax(float (&s)[64], uint4 live, int j, float (&o)[64],
//                uint32_t (&p)[32], int row, int t);
//                                      S(j) -> P(j) in place; may rescale o
//   void epilogue(const float (&o)[64], int row, int t);
//   void begin(int row, int t);        once per consumer thread before the
//                                      loop (K1, K2, K10: empty; K7 and K10b
//                                      start the first bias tile's copies)
//   static constexpr uint32_t kExtraKBytes;   the size of the policy's own
//                                      slot per stage, past SharedStorage,
//                                      that load_k may fill beside the K
//                                      tile (the prototypes' key bias; 0 for
//                                      K1, K2, K7 and K10)
//   uint32_t extra_k_bytes(int j);     the bytes load_k copies into the slot
//                                      for tile j (0 or kExtraKBytes; asked
//                                      only where kExtraKBytes > 0): they
//                                      complete on k_full with the tile's
//   void read_stage(int stage, int j, float (&s)[64]);
//                                      reads the slot once S(j) is waited
//                                      for and before the warp releases the
//                                      stage, into registers or into S(j)
//                                      itself (K1, K2, K7, K10: empty), so
//                                      the producer's next copy into it
//                                      cannot overtake a read made later, in
//                                      the softmax
// where row is the query row of the thread's first accumulator row (the
// second is row + 8) and t = lane % 4.
template <class Policy>
__device__ __forceinline__ uint32_t extra_k_bytes(const Policy& pol, int j) {
  if constexpr (Policy::kExtraKBytes == 0) return 0;
  else return pol.extra_k_bytes(j);
}

// The Policy's Score: float unless it names one.
template <class Policy, class = void>
struct ScoreOf {
  using type = float;
};
template <class Policy>
struct ScoreOf<Policy, std::void_t<typename Policy::Score>> {
  using type = typename Policy::Score;
};

template <class Policy>
__device__ __forceinline__ void attention_mainloop(Policy& pol) {
  using Score = typename ScoreOf<Policy>::type;
  constexpr bool kI8 = std::is_same<Score, int>::value;
  constexpr int kQkBytes = kI8 ? kTileBytesI8 : kTileBytes;
  using Storage = SharedStorageT<kQkBytes>;
  Storage& sm = shared_storage<Storage>();
  const int wg = threadIdx.x / 128;
  const int n = pol.n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 2);   // the TMA thread's expect_tx and warp 1's word
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], kConsumerWarps);  // one arrive per consumer warp
      mbar_init(&sm.v_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(&sm.q_full, kQkBytes);
      pol.load_q(smem_u32(sm.q), &sm.q_full);
      for (int j = 0; j < n; ++j) {
        const int s = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        mbar_wait(&sm.k_empty[s], ph ^ 1);
        mbar_expect_tx(&sm.k_full[s], kQkBytes + extra_k_bytes(pol, j));
        pol.load_k(smem_u32(sm.k[s]), j, &sm.k_full[s]);
        mbar_wait(&sm.v_empty[s], ph ^ 1);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        pol.load_v(smem_u32(sm.v[s]), j, &sm.v_full[s]);
      }
    } else if (warp == 1) {
      for (int j = 0; j < n; ++j) {
        const int s = j % kStages;
        mbar_wait(&sm.k_empty[s], ((j / kStages) & 1) ^ 1);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = __ballot_sync(0xffffffffu, pol.live(j * kTile + 32 * i + lane));
        if (lane == 0) {
          *reinterpret_cast<uint4*>(sm.live[s]) = make_uint4(w[0], w[1], w[2], w[3]);
          mbar_arrive(&sm.k_full[s]);  // release: the word is visible to the waiters
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;                  // consumer 0 or 1: q rows 64 cw ..
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int row = cw * 64 + warp * 16 + lane / 4;   // within the q tile
  const bool signals = lane == 0;                   // one arrive per warp
  const int my_bar = 1 + cw, other_bar = 2 - cw;    // named barriers 1, 2
  const uint32_t q_rows = smem_u32(sm.q) + cw * 64 * 128;   // 64 rows x 128 B per box

  float o[64];
  Score s[64];
  uint32_t p[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    o[i] = 0.f;
    s[i] = Score(0);
  }

  pol.begin(row, t);
  if (cw == 1) named_arrive(1, 256);   // consumer 0 goes first
  mbar_wait(&sm.q_full, 0);

  // phase 0: S(0)
  mbar_wait(&sm.k_full[0], 0);
  named_sync(my_bar, 256);
  wgmma_fence();
  qk_product(s, q_rows, smem_u32(sm.k[0]));
  wgmma_commit();
  named_arrive(other_bar, 256);
  wgmma_wait_all();
  fence_regs(s);
  uint4 live = *reinterpret_cast<const uint4*>(sm.live[0]);
  pol.read_stage(0, 0, s);
  __syncwarp();   // every lane's reads of the stage are done before the warp releases it
  if (signals) mbar_arrive(&sm.k_empty[0]);
  pol.softmax(s, live, 0, o, p, row, t);

  // phases 1 .. n-1: O += P(j-1) V(j-1) and S(j)
  for (int j = 1; j < n; ++j) {
    const int sk = j % kStages, sv = (j - 1) % kStages;
    mbar_wait(&sm.k_full[sk], (j / kStages) & 1);
    mbar_wait(&sm.v_full[sv], ((j - 1) / kStages) & 1);
    named_sync(my_bar, 256);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    pv_product(o, p, smem_u32(sm.v[sv]));
    qk_product(s, q_rows, smem_u32(sm.k[sk]));
    wgmma_commit();
    named_arrive(other_bar, 256);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(s);
    if (signals) mbar_arrive(&sm.v_empty[sv]);
    live = *reinterpret_cast<const uint4*>(sm.live[sk]);
    pol.read_stage(sk, j, s);
    __syncwarp();
    if (signals) mbar_arrive(&sm.k_empty[sk]);
    pol.softmax(s, live, j, o, p, row, t);
  }

  // last phase: O += P(n-1) V(n-1)
  const int sv = (n - 1) % kStages;
  mbar_wait(&sm.v_full[sv], ((n - 1) / kStages) & 1);
  named_sync(my_bar, 256);
  fence_regs(o);
  fence_regs(p);
  wgmma_fence();
  pv_product(o, p, smem_u32(sm.v[sv]));
  wgmma_commit();
  // consumer 1's last turn hands over to nobody: consumer 0 has finished
  if (cw == 0) named_arrive(other_bar, 256);
  wgmma_wait_all();
  fence_regs(o);
  if (signals) mbar_arrive(&sm.v_empty[sv]);
  pol.epilogue(o, row, t);
}

// ---- host: tensor maps -----------------------------------------------------

// A bf16 (or uint8) tensor map of `rank` dims (innermost first: d = 128,
// then the others), strides in bytes for dims 1.., and boxes of 128 bytes
// of d (64 bf16, 128 bytes) x box_rows rows along `row_dim` (1 elsewhere),
// 128-byte swizzle, zero fill out of bounds.
inline bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint64_t* strides, int row_dim, int box_rows = kTile,
                     CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint32_t box[5] = {type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 128u : 64u, 1, 1, 1, 1};
  cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  box[row_dim] = static_cast<cuuint32_t>(box_rows);
  return fn(map, type, rank, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor maps of q [B*N, S_q, 128] and k, v [B*N, S_k, 128] (bf16,
// contiguous), boxes of 128 rows; false if cuTensorMapEncodeTiled refuses one.
inline bool make_bnsd_maps(CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm, const void* q,
                           const void* k, const void* v, int batch_heads, int sq, int sk) {
  const cuuint64_t bn = static_cast<cuuint64_t>(batch_heads);
  const cuuint64_t qdims[3] = {kHeadDim, static_cast<cuuint64_t>(sq), bn};
  const cuuint64_t kdims[3] = {kHeadDim, static_cast<cuuint64_t>(sk), bn};
  const cuuint64_t qstr[2] = {kHeadDim * 2, static_cast<cuuint64_t>(sq) * kHeadDim * 2};
  const cuuint64_t kstr[2] = {kHeadDim * 2, static_cast<cuuint64_t>(sk) * kHeadDim * 2};
  return make_map(qm, q, 3, qdims, qstr, 1) && make_map(km, k, 3, kdims, kstr, 1) &&
         make_map(vm, v, 3, kdims, kstr, 1);
}

// Launch kKernel, a kernel with K7's signature (K7 / K1' scaled and
// K10 / K10b: q/k/v maps, the bias with its batch stride, row pitch and
// `wide`, the key mask, out, heads, S_q, S_k, scale), over q [B*N, S_q, 128]
// and k, v [B*N, S_k, 128].  The grid is (heads, q tiles, batch) with the
// bias, the head fastest so that the head-blocks of one (batch, q tile) run
// side by side and read the same bias rows from L2, and (q tiles, heads,
// batch) without, as K1's.  The bias rows take 16-byte copies where the
// pitch, stride and base allow (BiasSlots::wide).
template <auto kKernel, bool kHasBias>
int launch_bias_kernel(const void* q, const void* k, const void* v, const float* bias,
                       long long batch_stride, long long row_pitch, const void* key_mask,
                       void* out, int batch, int heads, int sq, int sk, float scale,
                       cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!make_bnsd_maps(&qm, &km, &vm, q, k, v, batch * heads, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = kSmemBytes + (kHasBias ? kBiasSlotBytes : 0);
  static const cudaError_t attr =
      cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int wide = row_pitch % 4 == 0 && batch_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const unsigned q_tiles = (sq + kTile - 1) / kTile;
  const dim3 grid = kHasBias ? dim3(heads, q_tiles, batch) : dim3(q_tiles, heads, batch);
  kKernel<<<grid, kBlockThreads, smem, stream>>>(
      qm, km, vm, bias, static_cast<long>(batch_stride), static_cast<long>(row_pitch), wide,
      static_cast<const uint8_t*>(key_mask), static_cast<uint16_t*>(out), heads, sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper
}  // namespace physicedit
