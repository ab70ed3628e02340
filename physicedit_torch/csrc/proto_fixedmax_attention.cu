// The bf16 fixed-max attention prototypes of tools/ as one templated kernel,
// bf16, head_dim 128.
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
//              and T5's sub-tile split); the function does not change
// P is rounded to bf16 before the product with V; acc is fp32.  Keys past
// S_k take no weight and rows past S_q are not written.
//
// What bounds it on an H100: the tensor cores, as K1 (at B=2, N=24, S=8448:
// 4 B N S^2 D = 1.75e12 FLOP, 1.77 ms at 989 TFLOP/s).  Design: K1's (one
// block of 4 warps per 64-row q tile, the warp's 16 query rows as mma.sync A
// fragments in registers, K/V tiles of 64 keys staged in shared memory, P
// kept in registers between the two products).  The key bias of a tile is
// staged beside it (64 floats); a tile past the bias prefix skips the add.
// The overlap switch keeps two score tiles in registers and a second K
// buffer in shared memory (three tiles, 52 KB, as dynamic shared memory): K
// of tile j + 1 is resident while V of tile j is, so the warp issues the
// next tile's QK^T mma before this tile's exp2, and the tensor cores work
// while the exp2 and the row sums do.  Not done: TMA, wgmma, a multi-stage
// copy pipeline.
#include "mma_bf16.cuh"

using namespace physicedit;

namespace {

constexpr float kClampValue = 100.f;
constexpr float kLn2Bf16 = 0.69140625f;      // ln 2 rounded to bf16
constexpr int kTile = kBlockK * kRowStride;  // bf16 per staged K or V tile

// template arguments are ints (not enums) so that they mangle as Li<n>E, which
// chip_smoke.py reads out of the ptxas report
constexpr int kNoBias = 0, kBiasF32 = 1, kBiasBf16 = 2;
constexpr int kRecip = 0, kFloor = 1, kUnnormalised = 2;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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
      if constexpr (kBias == kBiasBf16) {
        x = round_bf16(x);
        if (with_bias) x = round_bf16(__fadd_rn(x, bias_s[c]));
        x = round_bf16(expf(round_bf16(__fmul_rn(x, kLn2Bf16))));
      } else {
        if constexpr (kInScale) x = __fmul_rn(x, scale);
        if constexpr (kBias == kBiasF32) {
          if (with_bias) x = __fadd_rn(x, bias_s[c]);
        }
        if constexpr (kClamp) x = fminf(x, kClampValue);
        if constexpr (kExp) x = exp2f(x);
      }
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
  static_assert(kBias != kBiasBf16 || (!kInScale && !kClamp && kExp && kRowSum),
                "the bf16 score chain is T1 v1's: prescaled q, no clamp");
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
  // a null bias (T5 with bias_keys = 0) reads none
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

}  // namespace

// q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16, contiguous.
// key_bias [B, Sk] fp32 (bf16 values for variant 5) or null; n_masked [B] fp32
// or null; bias_keys: the keys [0, bias_keys) take the bias; scale =
// log2(e) / sqrt(128) in fp32.  The variant ids are those of
// physicedit_torch/tools/_proto_attention.py's VARIANTS; the template
// arguments are <kInScale, kBias, kClamp, kExp, kRowSum, kNorm, kOverlap>.
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
    case 3: return launch<true, kNoBias, false, true, true, kFloor, false>(PROTO_ARGS);    // T2, inscale
    case 4: return launch<false, kNoBias, false, true, true, kFloor, false>(PROTO_ARGS);   // T2 = T1 v2; T3
    case 5: return launch<false, kBiasBf16, false, true, true, kFloor, false>(PROTO_ARGS); // T1 v1
    case 6: return launch<false, kNoBias, false, true, false, kUnnormalised, false>(PROTO_ARGS);  // T1 v3
    case 7: return launch<false, kNoBias, false, false, false, kUnnormalised, false>(PROTO_ARGS); // T1 v4
    case 8: return launch<false, kBiasF32, false, true, true, kRecip, false>(PROTO_ARGS);  // T5
    case 9: return launch<false, kBiasF32, false, true, true, kRecip, true>(PROTO_ARGS);   // T5, overlap
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
#undef PROTO_ARGS
