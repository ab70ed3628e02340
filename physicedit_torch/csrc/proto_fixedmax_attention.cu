// The bf16 fixed-max attention prototypes of tools/ as one entry point over
// one kernel, bf16, head_dim 128.
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
//   kBias      kBiasF32: s + key_bias[b, key] for key < bias_keys, after the
//              scale (T7 passes S_k; T8 and T5 only their text prefix: a key
//              past it takes no bias, whatever the bias holds there);
//              kBiasBf16 (T1 v1): the score and its sum with the bias
//              rounded to bf16, and exp2 taken as JAX takes it on bf16,
//              exp(ln 2 * x) in bf16: p = bf16(exp(bf16(x * bf16(ln 2))))
//   kClamp     min(., 100) after the scale and the bias, before exp2 (T7, T8)
//   kExp       p = exp2(.) (T1 v4: p = the score)
//   kRowSum    l = sum(p) in fp32 (T1 v3 and v4: none)
//   kNorm      kRecip: out = acc * (1 / l), no floor, so a row with l == 0
//              comes out NaN (T7, T8, T5); kFloor: out = acc / max(l - nm, 1e-30),
//              nm the masked-key count of the row's batch (T3; 0 for T1 v1,
//              T2), so such a row comes out 0; kUnnormalised: out = acc
// P is rounded to bf16 before the product with V; acc is fp32.  Keys past
// S_k take no weight and rows past S_q are not written.
//
// What bounds them on an H100: the tensor cores, as K1 (at B=2, N=24,
// S=8448: 4 B N S^2 D = 1.75e12 FLOP, 1.77 ms at 989 TFLOP/s).
//
// The kernel, proto_hopper_kernel, is a ProtoPolicy on K1's Hopper mainloop
// (hopper_attention.cuh: TMA into a 2-stage ring of 128-key K and V tiles,
// wgmma m64n128k16 for both products, a producer warpgroup and two
// ping-ponged consumer warpgroups of 64 q rows, grid (q tiles, heads,
// batch)).  The softmax of each switch runs in the consumer's fp32 S
// registers, as K1's: exp2 is one ex2.approx.ftz, a tile whose 128 keys are
// all live skips the liveness test, and l is reduced across the 4 threads
// of a row once, in the epilogue.  Keys past S_k arrive as TMA's zeros and
// the liveness word (key < S_k) zeroes them; none of these takes a key mask
// (T3's masked keys arrive as zeroed K and V rows).  No overlap switch: the
// ping-pong already runs one warpgroup's exp2 under the other's products,
// so the two ids of T8 and of T5 (their JAX tools' sub = 1 and sub > 1)
// launch one instantiation each.  The key bias (T1 v1, T5, T7, T8) is one
// float per key, shared by the tile's 128 rows: its 512 bytes ride the K
// stage's TMA (one bulk copy on the stage's full barrier, into a slot past
// the mainloop's storage; the wrapper pads the bias with zeros to whole
// tiles and from bias_keys on), and it is read in the mainloop's read_stage
// hook, before the warp releases the stage: read later, in the softmax, the
// producer's next copy into that slot could overtake it.  T1 v1 copies
// every tile's bias and keeps the 32 keys of a thread's columns in 16
// registers as bf16 pairs (the values are bf16).  The fp32 bias is copied
// only for the tiles below bias_keys (the stage's expected bytes are per
// tile; T7's bias_keys is S_k, so every tile) and added to S in read_stage
// itself, so that no bias register stays live into the softmax; with the
// in-kernel scale (T7) read_stage first multiplies every tile's S by c, so
// the order is the plain version's: s * c, + bias, clamp, exp2, each op
// rounded on its own (no FMA).  Their epilogue multiplies by 1 / l
// (__frcp_rn) with no floor.  Numerics against the plain version: p below
// 2^-126 flushes to 0 (as K1's), and v1's exp(z) is ex2.approx.ftz(z *
// log2(e)) in fp32, rounded to bf16: within a few fp32 ulps of exp(z)
// before that rounding, so a p differs from bf16(exp(z)) by one bf16 ulp
// only where exp(z) lies that close to a rounding boundary of bf16.
#include "hopper_attention.cuh"

using namespace physicedit;
namespace hp = physicedit::hopper;

namespace {

constexpr float kClampValue = 100.f;
constexpr float kLn2Bf16 = 0.69140625f;      // ln 2 rounded to bf16
constexpr float kLog2e = 1.4426950408889634f;

// template arguments are ints (not enums) so that they mangle as Li<n>E, which
// chip_smoke.py reads out of the ptxas report
constexpr int kNoBias = 0, kBiasF32 = 1, kBiasBf16 = 2;
constexpr int kRecip = 0, kFloor = 1, kUnnormalised = 2;

// kRecip multiplies by f = 1 / l; kFloor divides by f = max(l - nm, 1e-30).
template <int kNorm>
__device__ __forceinline__ float finish(float a, float f) {
  if constexpr (kNorm == kRecip) return __fmul_rn(a, f);
  if constexpr (kNorm == kFloor) return __fdiv_rn(a, f);
  return a;
}

template <bool kInScale, int kBias, bool kClamp, bool kExp, bool kRowSum, int kNorm>
struct ProtoPolicy {
  static_assert(kBias != kBiasBf16 || (!kInScale && !kClamp),
                "the bf16 score chain (T1 v1) takes a prescaled q and no clamp");
  static constexpr bool kHasBias = kBias != kNoBias;
  // T7: read_stage scales S, then adds the bias; p_tile does not scale again
  static constexpr bool kScaleInRead = kInScale && kBias == kBiasF32;
  // the key bias of a tile: its 128 floats, copied beside K into the stage's slot
  static constexpr uint32_t kExtraKBytes = kHasBias ? hp::kTile * sizeof(float) : 0;

  const CUtensorMap* qmap;
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  const float* bias;      // this batch row's key bias, [n_tiles * 128], or null
  int n_bias_tiles;       // tiles whose bias is copied: all (T1 v1), below bias_keys (fp32)
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
  // stays live into the softmax.  With the in-kernel scale, S(j) is scaled
  // here first, on every tile (the bias follows the scale).
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
      if constexpr (kScaleInRead) {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] = __fmul_rn(s[i], scale);
      }
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
          if constexpr (kInScale && !kScaleInRead) x = __fmul_rn(x, scale);
          if constexpr (kClamp) x = fminf(x, kClampValue);
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

template <bool kInScale, int kBias, bool kClamp, bool kExp, bool kRowSum, int kNorm>
__global__ void __launch_bounds__(hp::kBlockThreads, 1)
proto_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const float* __restrict__ key_bias,
                    const float* __restrict__ n_masked, uint16_t* __restrict__ out, int n_heads,
                    int sq, int sk, int bias_keys, float scale) {
  using Policy = ProtoPolicy<kInScale, kBias, kClamp, kExp, kRowSum, kNorm>;
  const int bh = blockIdx.z * n_heads + blockIdx.y;
  const int n_tiles = (sk + hp::kTile - 1) / hp::kTile;
  const bool has_bias = Policy::kHasBias && key_bias != nullptr;
  // T1 v1 reads every tile's bias; the fp32 bias those below bias_keys (the
  // wrapper zeroes the padded bias from bias_keys on inside the last of them)
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

template <bool kInScale, int kBias, bool kClamp, bool kExp, bool kRowSum, int kNorm>
constexpr int hopper_smem_bytes() {
  return hp::kSmemBytes +
         hp::kStages * ProtoPolicy<kInScale, kBias, kClamp, kExp, kRowSum, kNorm>::kExtraKBytes;
}

// bias_keys picks the tiles whose fp32 bias is copied (the wrapper zeroes
// the padded bias from bias_keys on).
template <bool kInScale, int kBias, bool kClamp, bool kExp, bool kRowSum, int kNorm>
int launch_hopper(const void* q, const void* k, const void* v, const void* key_bias,
                  const void* n_masked, void* out, int batch, int heads, int sq, int sk,
                  int bias_keys, float scale, cudaStream_t stream) {
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (sk <= 0 || (kBias == kBiasBf16 && key_bias == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!hp::make_bnsd_maps(&qm, &km, &vm, q, k, v, batch * heads, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = proto_hopper_kernel<kInScale, kBias, kClamp, kExp, kRowSum, kNorm>;
  constexpr int smem = hopper_smem_bytes<kInScale, kBias, kClamp, kExp, kRowSum, kNorm>();
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

// q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16,
// contiguous and 16-byte aligned (TMA).  key_bias fp32 or null:
// [B, ceil(Sk / 128) * 128], zero from bias_keys on (the loop reads whole
// 128-key tiles); for id 5 bf16 values, not null.  n_masked [B] fp32 or
// null; scale = log2(e) / sqrt(128) in fp32.  The variant ids are those of
// physicedit_torch/tools/_proto_attention.py's VARIANTS; the template
// arguments are launch_hopper's <kInScale, kBias, kClamp, kExp, kRowSum,
// kNorm>.
#define PROTO_ARGS q, k, v, key_bias, n_masked, out, batch, heads, sq, sk, bias_keys, scale, s
extern "C" int proto_fixedmax_attention_bf16(int variant, const void* q, const void* k,
                                             const void* v, const void* key_bias,
                                             const void* n_masked, void* out, int batch,
                                             int heads, int sq, int sk, int bias_keys,
                                             float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch_hopper<true, kBiasF32, true, true, true, kRecip>(PROTO_ARGS);    // T7
    case 1: return launch_hopper<false, kBiasF32, true, true, true, kRecip>(PROTO_ARGS);   // T8
    case 2: return launch_hopper<false, kBiasF32, true, true, true, kRecip>(PROTO_ARGS);   // T8, sub > 1
    case 3: return launch_hopper<true, kNoBias, false, true, true, kFloor>(PROTO_ARGS);    // T2, inscale
    case 4: return launch_hopper<false, kNoBias, false, true, true, kFloor>(PROTO_ARGS);   // T2 = T1 v2; T3
    case 5: return launch_hopper<false, kBiasBf16, false, true, true, kFloor>(PROTO_ARGS); // T1 v1
    case 6: return launch_hopper<false, kNoBias, false, true, false, kUnnormalised>(PROTO_ARGS);  // T1 v3
    case 7: return launch_hopper<false, kNoBias, false, false, false, kUnnormalised>(PROTO_ARGS); // T1 v4
    case 8: return launch_hopper<false, kBiasF32, false, true, true, kRecip>(PROTO_ARGS);  // T5
    case 9: return launch_hopper<false, kBiasF32, false, true, true, kRecip>(PROTO_ARGS);  // T5, sub > 1
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef PROTO_ARGS

// The dynamic shared memory of an instantiation's block, for the report
// beside ptxas's: without a key bias (ids 3, 4, 6, 7) and with one (ids 0-2,
// 5, 8 and 9: one 512-byte slot per stage, bf16 or fp32 values alike).
static_assert(hopper_smem_bytes<false, kBiasBf16, false, true, true, kFloor>() ==
              hopper_smem_bytes<true, kBiasF32, true, true, true, kRecip>());
extern "C" int proto_fixedmax_attention_smem_bytes() {
  return hopper_smem_bytes<false, kNoBias, false, true, true, kFloor>();
}
extern "C" int proto_fixedmax_attention_bias_smem_bytes() {
  return hopper_smem_bytes<false, kBiasBf16, false, true, true, kFloor>();
}
