// The bf16 fixed-max attention prototypes of tools/ as one entry point over
// two kernels, bf16, head_dim 128.
//
// Replaces the Pallas prototypes that the measurement tools in tools/ drive
// (their ports are physicedit_torch/tools/proto_*.py):
//   T7  tools/proto_fixedmax.py::fixedmax_bnsd (body _kernel)
//   T8  tools/proto_fixedmax2.py::fixedmax2_bnsd (body _kernel)
//   T2  tools/proto_attn_fast.py::attn_nobias (body _kernel_nobias)
//   T3  tools/proto_attn_fast.py::attn_nmask (body _kernel_nmask)
//   T1  tools/proto_attn_bf16s.py::_call with the bodies _bf16s_kernel (v1),
//       _nobias_kernel (v2, the function of T2 on a prescaled q),
//       _expnosum_kernel (v3) and _noexp_kernel (v4)
//   T5  tools/proto_attn_interleave.py::attn_interleaved (body _kernel)
// Each is K1's fixed-max forward (fixedmax_attention.cu) with compile-time
// switches; with c = log2(e) / sqrt(d), per key tile:
//   kInScale   s = fp32(q k^T) * c in fp32 (else q arrives as q' = q * c)
//   kBias      kBiasF32: s + key_bias[b, key] for key < bias_keys (T7 passes
//              S_k; T8 and T5 only their text prefix: a key past it takes no
//              bias, whatever the bias holds there); kBiasBf16 (T1 v1): the
//              score and its sum with the bias rounded to bf16, and exp2
//              taken as JAX takes it on bf16, exp(ln 2 * x) in bf16:
//              p = bf16(exp(bf16(x * bf16(ln 2))))
//   kClamp     min(., 100) before exp2
//   kExp       p = exp2(.) (T1 v4: p = the score)
//   kRowSum    l = sum(p) in fp32 (T1 v3 and v4: none)
//   kNorm      kRecip: out = acc * (1 / l), no floor, so a row with l == 0
//              comes out NaN (T7, T8, T5); kFloor: out = acc / max(l - nm, 1e-30),
//              nm the masked-key count of the row's batch (T3; 0 for T1 v1,
//              T2), so such a row comes out 0; kUnnormalised: out = acc
//   kOverlap   QK^T of tile j + 1 issued before the softmax of tile j (T8's
//              sub-tile split; the mma.sync loop only); the function does not
//              change
// P is rounded to bf16 before the product with V; acc is fp32.  Keys past
// S_k take no weight and rows past S_q are not written.
//
// What bounds them on an H100: the tensor cores, as K1 (at B=2, N=24,
// S=8448: 4 B N S^2 D = 1.75e12 FLOP, 1.77 ms at 989 TFLOP/s).
//
// Which loop runs which instantiation (the entry point's variant ids):
//   3-9 (T2 both scales, T3, T1 v1-v4, T5): proto_hopper_kernel, a
//     ProtoPolicy on K1's Hopper mainloop (hopper_attention.cuh: TMA into a
//     2-stage ring of 128-key K and V tiles, wgmma m64n128k16 for both
//     products, a producer warpgroup and two ping-ponged consumer warpgroups
//     of 64 q rows, grid (q tiles, heads, batch)).  The softmax of each
//     switch runs in the consumer's fp32 S registers, as K1's: exp2 is one
//     ex2.approx.ftz, a tile whose 128 keys are all live skips the liveness
//     test, and l is reduced across the 4 threads of a row once, in the
//     epilogue.  Keys past S_k arrive as TMA's zeros and the liveness word
//     (key < S_k) zeroes them; none of these takes a key mask (T3's masked
//     keys arrive as zeroed K and V rows).  No clamp and no overlap switch:
//     none of them clamps, and the ping-pong already runs one warpgroup's
//     exp2 under the other's products, so T5's two ids (its JAX tool's
//     sub = 1 and sub > 1) launch one instantiation.  The key bias (T1 v1,
//     T5) is one float per key, shared by the tile's 128 rows: its 512 bytes
//     ride the K stage's TMA (one bulk copy on the stage's full barrier, into
//     a slot past the mainloop's storage; the wrapper pads the bias with
//     zeros to whole tiles and from bias_keys on), and it is read in the
//     mainloop's read_stage hook, before the warp releases the stage: read
//     later, in the softmax, the producer's next copy into that slot could
//     overtake it.  T1 v1 copies every tile's bias and keeps the 32 keys of
//     a thread's columns in 16 registers as bf16 pairs (the values are
//     bf16).  T5 copies only the tiles below bias_keys (the stage's expected
//     bytes are per tile) and adds the bias to S in read_stage itself, in
//     fp32, so that no bias register stays live into the softmax; its
//     epilogue multiplies by 1 / l (__frcp_rn) with no floor.  Numerics
//     against the plain version: p below 2^-126 flushes to 0 (as K1's), and
//     v1's exp(z) is ex2.approx.ftz(z * log2(e)) in fp32, rounded to bf16:
//     within a few fp32 ulps of exp(z) before that rounding, so a p differs
//     from bf16(exp(z)) by one bf16 ulp only where exp(z) lies that close to
//     a rounding boundary of bf16.
//   0-2 (T7, T8): proto_kernel, a mma.sync loop (one block of 4 warps per
//     64-row q tile, the warp's 16 query rows as mma.sync A fragments in
//     registers, K/V tiles of 64 keys staged in shared memory, P kept in
//     registers between the two products).  The key bias of a tile is
//     staged beside it (64 floats); a tile past the bias prefix skips the
//     add.  The overlap switch keeps two score tiles in registers and a
//     second K buffer in shared memory (three tiles, 52 KB, as dynamic
//     shared memory): K of tile j + 1 is resident while V of tile j is, so
//     the warp issues the next tile's QK^T mma before this tile's exp2.  Not
//     done for these: TMA, wgmma, a multi-stage pipeline.
#include "hopper_attention.cuh"

using namespace physicedit;
namespace hp = physicedit::hopper;

namespace {

constexpr float kClampValue = 100.f;
constexpr float kLn2Bf16 = 0.69140625f;      // ln 2 rounded to bf16
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = kBlockK * kRowStride;  // bf16 per staged K or V tile

// template arguments are ints (not enums) so that they mangle as Li<n>E, which
// chip_smoke.py reads out of the ptxas report
constexpr int kNoBias = 0, kBiasF32 = 1, kBiasBf16 = 2;
constexpr int kRecip = 0, kFloor = 1, kUnnormalised = 2;

// The key bias of tile [k0, k0 + 64) in shared memory, 0 from key n_bias on.
__device__ __forceinline__ void stage_bias(float* bias_s, const float* bb, int k0, int n_bias) {
  if (threadIdx.x < kBlockK) {
    const int key = k0 + threadIdx.x;
    bias_s[threadIdx.x] = key < n_bias ? bb[key] : 0.f;
  }
}

// One tile's raw scores S become P in place, and the row sums grow.  C
// fragment element (j, e) is row g (e < 2) or g + 8, tile column
// 8j + 2t + (e & 1); columns from n_live on are keys past S_k.
template <bool kInScale, int kBias, bool kClamp, bool kExp, bool kRowSum>
__device__ __forceinline__ void scores_to_p(float s[8][4], const float* bias_s, bool with_bias,
                                            int n_live, float scale, int t, float& l_g,
                                            float& l_g8) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * j + 2 * t + (e & 1);
      float x = s[j][e];
      if constexpr (kInScale) x = __fmul_rn(x, scale);
      if constexpr (kBias == kBiasF32) {
        if (with_bias) x = __fadd_rn(x, bias_s[c]);
      }
      if constexpr (kClamp) x = fminf(x, kClampValue);
      if constexpr (kExp) x = exp2f(x);
      if (c >= n_live) x = 0.f;
      s[j][e] = x;
      if constexpr (kRowSum) {
        if (e < 2) l_g += x; else l_g8 += x;
      }
    }
  }
}

// kRecip multiplies by f = 1 / l; kFloor divides by f = max(l - nm, 1e-30).
template <int kNorm>
__device__ __forceinline__ float finish(float a, float f) {
  if constexpr (kNorm == kRecip) return __fmul_rn(a, f);
  if constexpr (kNorm == kFloor) return __fdiv_rn(a, f);
  return a;
}

template <bool kInScale, int kBias, bool kClamp, bool kExp, bool kRowSum, int kNorm,
          bool kOverlap>
__global__ void __launch_bounds__(kThreads)
proto_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, const float* __restrict__ key_bias,
             const float* __restrict__ n_masked, uint16_t* __restrict__ out, int n_heads,
             int sq, int sk, int bias_keys, float scale) {
  static_assert(kBias != kBiasBf16, "the bf16 score chain (T1 v1) runs on the Hopper loop");
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* const ks0 = smem;
  uint16_t* const ks1 = smem + kTile;  // the overlap's second K buffer
  uint16_t* const vs = smem + (kOverlap ? 2 : 1) * kTile;
  float* const bias_s = reinterpret_cast<float*>(vs + kTile);

  const int q0 = blockIdx.x * kBlockQ;
  const long bh = (long)blockIdx.z * n_heads + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;

  // Stage the q tile through the K buffer into registers.
  load_tile(ks0, q + bh * sq * kHeadDim, kHeadDim, q0, sq);
  __syncthreads();
  uint32_t qa[8][4];
  load_q_fragments(qa, ks0, wr, g, t);
  __syncthreads();

  float acc[16][4];
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;
  float l_g = 0.f, l_g8 = 0.f;

  const uint16_t* kb = k + bh * sk * kHeadDim;
  const uint16_t* vb = v + bh * sk * kHeadDim;
  // a null bias (bias_keys = 0) reads none
  const bool has_bias = kBias != kNoBias && key_bias != nullptr;
  const float* bb = has_bias ? key_bias + (long)blockIdx.z * sk : nullptr;
  const int n_bias = has_bias ? min(bias_keys, sk) : 0;

  if constexpr (!kOverlap) {
    for (int k0 = 0; k0 < sk; k0 += kBlockK) {
      load_tile(ks0, kb, kHeadDim, k0, sk);
      load_tile(vs, vb, kHeadDim, k0, sk);
      if (k0 < n_bias) stage_bias(bias_s, bb, k0, n_bias);
      __syncthreads();

      float s[8][4];
      qk_tile(s, qa, ks0, g, t);
      scores_to_p<kInScale, kBias, kClamp, kExp, kRowSum>(s, bias_s, k0 < n_bias, sk - k0,
                                                         scale, t, l_g, l_g8);
      pv_tile(acc, s, vs, g, t);
      __syncthreads();
    }
  } else {
    // K of tile j lives in buffer j & 1; V and the bias of tile j in vs and bias_s
    load_tile(ks0, kb, kHeadDim, 0, sk);
    load_tile(vs, vb, kHeadDim, 0, sk);
    if (kBlockK < sk) load_tile(ks1, kb, kHeadDim, kBlockK, sk);
    if (0 < n_bias) stage_bias(bias_s, bb, 0, n_bias);
    __syncthreads();

    float s[8][4], s_next[8][4];
    qk_tile(s, qa, ks0, g, t);
    for (int k0 = 0, j = 0; k0 < sk; k0 += kBlockK, ++j) {
      const bool more = k0 + kBlockK < sk;
      // QK^T of tile j + 1: tensor-core work independent of the softmax of tile j
      if (more) qk_tile(s_next, qa, (j & 1) ? ks0 : ks1, g, t);
      scores_to_p<kInScale, kBias, kClamp, kExp, kRowSum>(s, bias_s, k0 < n_bias, sk - k0,
                                                         scale, t, l_g, l_g8);
      pv_tile(acc, s, vs, g, t);
      __syncthreads();
      if (more) {
        const int k1 = k0 + kBlockK;
        load_tile(vs, vb, kHeadDim, k1, sk);
        if (k1 + kBlockK < sk) load_tile((j & 1) ? ks1 : ks0, kb, kHeadDim, k1 + kBlockK, sk);
        if (k1 < n_bias) stage_bias(bias_s, bb, k1, n_bias);
        __syncthreads();
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jj][e] = s_next[jj][e];
      }
    }
  }

  if constexpr (kRowSum) {
    l_g = quad_sum(l_g);
    l_g8 = quad_sum(l_g8);
  }
  float f_g = 1.f, f_g8 = 1.f;
  if constexpr (kNorm == kRecip) {
    f_g = __frcp_rn(l_g);
    f_g8 = __frcp_rn(l_g8);
  }
  if constexpr (kNorm == kFloor) {
    const float nm = n_masked != nullptr ? n_masked[blockIdx.z] : 0.f;
    f_g = fmaxf(__fsub_rn(l_g, nm), 1e-30f);
    f_g8 = fmaxf(__fsub_rn(l_g8, nm), 1e-30f);
  }
  const int rg = q0 + wr + g;
  const int rg8 = rg + 8;
  uint16_t* const o_g = out + (bh * sq + rg) * kHeadDim;
  uint16_t* const o_g8 = out + (bh * sq + rg8) * kHeadDim;
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) {
    const int c = 8 * jd + 2 * t;
    if (rg < sq)
      *reinterpret_cast<uint32_t*>(o_g + c) =
          pack_bf16(finish<kNorm>(acc[jd][0], f_g), finish<kNorm>(acc[jd][1], f_g));
    if (rg8 < sq)
      *reinterpret_cast<uint32_t*>(o_g8 + c) =
          pack_bf16(finish<kNorm>(acc[jd][2], f_g8), finish<kNorm>(acc[jd][3], f_g8));
  }
}

template <bool kInScale, int kBias, bool kClamp, bool kExp, bool kRowSum, int kNorm,
          bool kOverlap>
int launch(const void* q, const void* k, const void* v, const void* key_bias,
           const void* n_masked, void* out, int batch, int heads, int sq, int sk,
           int bias_keys, float scale, cudaStream_t stream) {
  const auto kernel = proto_kernel<kInScale, kBias, kClamp, kExp, kRowSum, kNorm, kOverlap>;
  const int smem = (kOverlap ? 3 : 2) * kTile * sizeof(uint16_t) + kBlockK * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const float*>(key_bias),
      static_cast<const float*>(n_masked), static_cast<uint16_t*>(out), heads, sq, sk,
      bias_keys, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- the Hopper instantiations: a ProtoPolicy on hopper_attention.cuh ----

template <bool kInScale, int kBias, bool kExp, bool kRowSum, int kNorm>
struct ProtoPolicy {
  // T7's bias follows the in-kernel scale; read_stage adds it to the raw S
  static_assert(!(kInScale && kBias == kBiasF32), "an fp32 key bias takes a prescaled q");
  static constexpr bool kHasBias = kBias != kNoBias;
  // the key bias of a tile: its 128 floats, copied beside K into the stage's slot
  static constexpr uint32_t kExtraKBytes = kHasBias ? hp::kTile * sizeof(float) : 0;

  const CUtensorMap* qmap;
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  const float* bias;      // this batch row's key bias, [n_tiles * 128], or null
  int n_bias_tiles;       // tiles whose bias is copied: all (T1 v1), below bias_keys (T5)
  uint16_t* out;          // this (batch, head)'s [S_q, 128]
  int q0, bh, sq, sk, n_tiles;
  float scale;            // kInScale
  float n_masked;         // kFloor: the masked-key count of this batch row
  float l0, l1;           // row-sum partials of the thread's rows
  uint32_t kb[16];        // kBiasBf16: the tile's bias at keys 8 n + 2t, + 1 (bf16 pairs)

  __device__ static uint32_t bias_slot(int stage) {
    return hp::extra_smem_u32() + stage * kExtraKBytes;
  }
  __device__ uint32_t extra_k_bytes(int j) const { return j < n_bias_tiles ? kExtraKBytes : 0; }
  __device__ void load_q(uint32_t dst, uint64_t* bar) const {
    hp::tma_load_3d(dst, qmap, bar, 0, q0, bh);
    hp::tma_load_3d(dst + hp::kBoxBytes, qmap, bar, 64, q0, bh);
  }
  __device__ void load_k(uint32_t dst, int j, uint64_t* bar) const {
    hp::tma_load_3d(dst, kmap, bar, 0, j * hp::kTile, bh);
    hp::tma_load_3d(dst + hp::kBoxBytes, kmap, bar, 64, j * hp::kTile, bh);
    if constexpr (kHasBias) {
      if (j < n_bias_tiles)
        hp::bulk_load_1d(bias_slot(j % hp::kStages), bias + (long)j * hp::kTile, kExtraKBytes,
                         bar);
    }
  }
  __device__ void load_v(uint32_t dst, int j, uint64_t* bar) const {
    hp::tma_load_3d(dst, vmap, bar, 0, j * hp::kTile, bh);
    hp::tma_load_3d(dst + hp::kBoxBytes, vmap, bar, 64, j * hp::kTile, bh);
  }
  __device__ bool live(int key) const { return key < sk; }
  __device__ void begin(int, int) const {}

  // The stage's bias at keys 8 n + 2t and + 1 (t = lane % 4): kBiasBf16
  // keeps it in kb, packed (the values are bf16, so the pack is exact), for
  // the softmax's bf16 chain; kBiasF32 adds it to S(j) here, in fp32, on the
  // tiles below bias_keys (s + b, as the plain version), so no bias register
  // stays live into the softmax.
  __device__ void read_stage(int stage, int j, float (&s)[64]) {
    if constexpr (kBias == kBiasBf16) {
      const uint32_t at = bias_slot(stage) + 8 * (threadIdx.x % 4);
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        float x, y;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x), "=f"(y) : "r"(at + 32 * n));
        kb[n] = pack_bf16(x, y);
      }
    } else if constexpr (kBias == kBiasF32) {
      if (j < n_bias_tiles) {
        const uint32_t at = bias_slot(stage) + 8 * (threadIdx.x % 4);
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          float x, y;
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(x), "=f"(y) : "r"(at + 32 * n));
          s[4 * n] = __fadd_rn(s[4 * n], x);
          s[4 * n + 1] = __fadd_rn(s[4 * n + 1], y);
          s[4 * n + 2] = __fadd_rn(s[4 * n + 2], x);
          s[4 * n + 3] = __fadd_rn(s[4 * n + 3], y);
        }
      }
    }
  }

  // S -> P per switch, zero where not live (kTest), the row sums, P packed
  // to bf16.  Element 4 nb + e is row g (e < 2) or g + 8, key
  // 8 nb + 2t + (e & 1); elements 2i and 2i + 1 are P's pair p[i].
  template <bool kTest>
  __device__ __forceinline__ void p_tile(float (&s)[64], uint4 word, uint32_t (&p)[32], int t) {
    const uint32_t w[4] = {word.x >> (2 * t), word.y >> (2 * t), word.z >> (2 * t),
                           word.w >> (2 * t)};
    if constexpr (kBias == kBiasBf16) {
      // T1 v1 on the pairs (keys 8 nb + 2t and + 1), each value a bf16:
      // x = bf16(s); bf16(x + b) and bf16(x * bf16(ln 2)) as packed bf16
      // ops, which round the exact sum and product once, as the fp32 add
      // and multiply (exact for two bf16 values, or within far less than
      // half a bf16 ulp of the larger addend) rounded to bf16 do; the exp
      // in fp32, rounded to bf16 as P's pair.
      const __nv_bfloat162 ln2 = __float2bfloat162_rn(kLn2Bf16);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int nb = i / 2;
        __nv_bfloat162 x = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
        x = __hmul2(__hadd2(x, *reinterpret_cast<const __nv_bfloat162*>(&kb[nb])), ln2);
        const uint32_t z = *reinterpret_cast<const uint32_t*>(&x);
        uint32_t pp = pack_bf16(hp::ex2_ftz(__fmul_rn(__uint_as_float(z << 16), kLog2e)),
                                hp::ex2_ftz(__fmul_rn(__uint_as_float(z & 0xffff0000u), kLog2e)));
        if (kTest) {
          const uint32_t bits = w[nb / 4] >> (8 * (nb % 4));
          pp &= ((bits & 1u) ? 0x0000ffffu : 0u) | ((bits & 2u) ? 0xffff0000u : 0u);
        }
        p[i] = pp;
        float& l = i % 2 == 0 ? l0 : l1;
        l += __uint_as_float(pp << 16);
        l += __uint_as_float(pp & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * nb + e];
          if constexpr (kInScale) x = __fmul_rn(x, scale);
          if constexpr (kExp) x = hp::ex2_ftz(x);
          if (kTest && !((w[nb / 4] >> (8 * (nb % 4) + (e & 1))) & 1u)) x = 0.f;
          s[4 * nb + e] = x;
          if constexpr (kRowSum) {
            if (e < 2) l0 += x; else l1 += x;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }
  }

  __device__ void softmax(float (&s)[64], uint4 word, int, float (&)[64], uint32_t (&p)[32], int,
                          int t) {
    if (hp::all_live(word)) p_tile<false>(s, word, p, t);
    else p_tile<true>(s, word, p, t);
  }

  __device__ void epilogue(const float (&o)[64], int row, int t) const {
    float f0 = 1.f, f1 = 1.f;
    if constexpr (kNorm == kRecip) {   // no floor: a row with l == 0 comes out NaN
      f0 = __frcp_rn(quad_sum(l0));
      f1 = __frcp_rn(quad_sum(l1));
    }
    if constexpr (kNorm == kFloor) {
      f0 = fmaxf(__fsub_rn(quad_sum(l0), n_masked), 1e-30f);
      f1 = fmaxf(__fsub_rn(quad_sum(l1), n_masked), 1e-30f);
    }
    const int r0 = q0 + row, r1 = r0 + 8;
    uint16_t* const o0 = out + (long)r0 * kHeadDim;
    uint16_t* const o1 = out + (long)r1 * kHeadDim;
#pragma unroll
    for (int jd = 0; jd < 16; ++jd) {
      const int c = 8 * jd + 2 * t;
      if (r0 < sq)
        *reinterpret_cast<uint32_t*>(o0 + c) =
            pack_bf16(finish<kNorm>(o[4 * jd], f0), finish<kNorm>(o[4 * jd + 1], f0));
      if (r1 < sq)
        *reinterpret_cast<uint32_t*>(o1 + c) =
            pack_bf16(finish<kNorm>(o[4 * jd + 2], f1), finish<kNorm>(o[4 * jd + 3], f1));
    }
  }
};

template <bool kInScale, int kBias, bool kExp, bool kRowSum, int kNorm>
__global__ void __launch_bounds__(hp::kBlockThreads, 1)
proto_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ key_bias,
                    const float* __restrict__ n_masked, uint16_t* __restrict__ out, int n_heads,
                    int sq, int sk, int bias_keys, float scale) {
  using Policy = ProtoPolicy<kInScale, kBias, kExp, kRowSum, kNorm>;
  const int bh = blockIdx.z * n_heads + blockIdx.y;
  const int n_tiles = (sk + hp::kTile - 1) / hp::kTile;
  const bool has_bias = Policy::kHasBias && key_bias != nullptr;
  // T1 v1 reads every tile's bias; T5 those below bias_keys (the wrapper
  // zeroes the padded bias from bias_keys on inside the last of them)
  const int n_bias_tiles = !has_bias ? 0
                           : kBias == kBiasBf16 ? n_tiles
                           : (min(bias_keys, sk) + hp::kTile - 1) / hp::kTile;
  Policy pol{&qmap, &kmap, &vmap,
             has_bias ? key_bias + (long)blockIdx.z * n_tiles * hp::kTile : nullptr,
             n_bias_tiles, out + (long)bh * sq * kHeadDim,
             (int)blockIdx.x * hp::kTile, bh, sq, sk, n_tiles, scale,
             n_masked != nullptr ? n_masked[blockIdx.z] : 0.f, 0.f, 0.f, {}};
  hp::attention_mainloop<Policy>(pol);
}

template <bool kInScale, int kBias, bool kExp, bool kRowSum, int kNorm>
constexpr int hopper_smem_bytes() {
  return hp::kSmemBytes +
         hp::kStages * ProtoPolicy<kInScale, kBias, kExp, kRowSum, kNorm>::kExtraKBytes;
}

// The same arguments as launch(); bias_keys picks the tiles whose bias is
// copied (the wrapper zeroes the padded bias from bias_keys on).
template <bool kInScale, int kBias, bool kExp, bool kRowSum, int kNorm>
int launch_hopper(const void* q, const void* k, const void* v, const void* key_bias,
                  const void* n_masked, void* out, int batch, int heads, int sq, int sk,
                  int bias_keys, float scale, cudaStream_t stream) {
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (sk <= 0 || (kBias == kBiasBf16 && key_bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!hp::make_bnsd_maps(&qm, &km, &vm, q, k, v, batch * heads, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = proto_hopper_kernel<kInScale, kBias, kExp, kRowSum, kNorm>;
  constexpr int smem = hopper_smem_bytes<kInScale, kBias, kExp, kRowSum, kNorm>();
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + hp::kTile - 1) / hp::kTile, heads, batch);
  kernel<<<grid, hp::kBlockThreads, smem, stream>>>(
      qm, km, vm, static_cast<const float*>(key_bias), static_cast<const float*>(n_masked),
      static_cast<uint16_t*>(out), heads, sq, sk, bias_keys, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16, contiguous
// (and 16-byte aligned for ids 3-9: TMA).  key_bias fp32 or null: for ids
// 0-2 [B, Sk], the keys [0, bias_keys) taking it; for ids 5 (bf16 values, not
// null), 8 and 9 [B, ceil(Sk / 128) * 128], zero from bias_keys on (the
// Hopper loop reads whole 128-key tiles).  n_masked [B] fp32 or null; scale
// = log2(e) / sqrt(128) in fp32.  The variant ids are those of
// physicedit_torch/tools/_proto_attention.py's VARIANTS; the template
// arguments are launch's <kInScale, kBias, kClamp, kExp, kRowSum, kNorm,
// kOverlap> (the mma.sync loop) and launch_hopper's <kInScale, kBias, kExp,
// kRowSum, kNorm> (the Hopper mainloop).
#define PROTO_ARGS q, k, v, key_bias, n_masked, out, batch, heads, sq, sk, bias_keys, scale, s
extern "C" int proto_fixedmax_attention_bf16(int variant, const void* q, const void* k,
                                             const void* v, const void* key_bias,
                                             const void* n_masked, void* out, int batch,
                                             int heads, int sq, int sk, int bias_keys,
                                             float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<true, kBiasF32, true, true, true, kRecip, false>(PROTO_ARGS);    // T7
    case 1: return launch<false, kBiasF32, true, true, true, kRecip, false>(PROTO_ARGS);   // T8
    case 2: return launch<false, kBiasF32, true, true, true, kRecip, true>(PROTO_ARGS);    // T8, overlap
    case 3: return launch_hopper<true, kNoBias, true, true, kFloor>(PROTO_ARGS);           // T2, inscale
    case 4: return launch_hopper<false, kNoBias, true, true, kFloor>(PROTO_ARGS);          // T2 = T1 v2; T3
    case 5: return launch_hopper<false, kBiasBf16, true, true, kFloor>(PROTO_ARGS);        // T1 v1
    case 6: return launch_hopper<false, kNoBias, true, false, kUnnormalised>(PROTO_ARGS);  // T1 v3
    case 7: return launch_hopper<false, kNoBias, false, false, kUnnormalised>(PROTO_ARGS); // T1 v4
    case 8: return launch_hopper<false, kBiasF32, true, true, kRecip>(PROTO_ARGS);         // T5
    case 9: return launch_hopper<false, kBiasF32, true, true, kRecip>(PROTO_ARGS);  // T5, sub > 1
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef PROTO_ARGS

// The dynamic shared memory of a Hopper instantiation's block, for the report
// beside ptxas's: without a key bias (ids 3, 4, 6, 7) and with one (ids 5, 8
// and 9: one 512-byte slot per stage, bf16 or fp32 values alike).
static_assert(hopper_smem_bytes<false, kBiasBf16, true, true, kFloor>() ==
              hopper_smem_bytes<false, kBiasF32, true, true, kRecip>());
extern "C" int proto_fixedmax_attention_smem_bytes() {
  return hopper_smem_bytes<false, kNoBias, true, true, kFloor>();
}
extern "C" int proto_fixedmax_attention_bias_smem_bytes() {
  return hopper_smem_bytes<false, kBiasBf16, true, true, kFloor>();
}
