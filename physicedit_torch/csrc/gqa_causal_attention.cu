// K2: causal grouped-query attention of the Qwen2.5-VL prefill and prompt
// encode, bf16, head_dim 128.
//
// Replaces physicedit_tpu/kernels/flash_attention.py::_gqa_causal_kernel
// (called through _gqa_causal_bnsd and gqa_causal_flash from
// models/qwen_vl.py::_prefill_attention).  Query head h reads K/V head
// h / (N / KV); K/V are never repeated.  Causality is by absolute position
// and a key padding mask excludes padded keys, so left- and right-padded
// batches both work.  Qwen has no q/k norm, so the logits are unbounded and
// the softmax keeps a running max (online softmax, in exp2 units, with
// log2(e) / sqrt(d) folded into the fp32 scores).  Masked positions get
// p = 0 explicitly: with the running max still at -1e30, exp2(s - m) would
// weigh them by 1.  A query row with no live key (a left-pad row) has l == 0
// and comes out as exactly 0; the caller discards such rows.
//
// What bounds it on an H100: the tensor cores once S is a few hundred
// (2 * 2 * B*N*S^2*D / 2 FLOP under the causal mask against
// (B*S*(N + 2*KV)*D) * 2 bytes).  Design: the Hopper mainloop of
// hopper_attention.cuh (TMA, wgmma, a producer and two ping-ponged consumer
// warpgroups) over 4-D tensor maps (D, heads, S, B) that read the inputs in
// their [B, S, heads, D] layout (no transposes).  Tiles wholly above the
// diagonal are never loaded; only the diagonal tile pays for the per-element
// causal test, and a tile below it whose keys are all live skips the
// liveness test; p = exp2(s * log2(e)/sqrt(d) - m) is one FFMA and one
// ex2.approx.ftz (a weight below 2^-126 of the row max flushes to 0).  The
// grid issues the heaviest q tiles first (q tile index = the slowest grid
// dimension, reversed) so the triangle leaves no SMs idle in the last wave.
// The q heads of a group share their K/V head through L2 (3 MB of K/V at
// S = 1536).  Not done yet: sharing one K/V tile across the q heads of a
// group in shared memory.
#include "hopper_attention.cuh"

using namespace physicedit;
using namespace physicedit::hopper;

namespace {

constexpr float kMasked = -1e30f;
constexpr float kScale = 1.4426950408889634f * 0.08838834764831845f;  // log2(e) / sqrt(128)

struct GqaCausalPolicy {
  const CUtensorMap* qmap;
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  const uint8_t* mask;    // this batch row's [S] (1 = live), or null
  uint16_t* out;          // [B, S, N, 128]
  int q0, h, kvh, b, seq, n_heads, n_tiles;
  float m0, m1, l0, l1;   // running max (exp2 units) and row-sum partials of the thread's rows

  __device__ void load_q(uint32_t dst, uint64_t* bar) const {
    tma_load_4d(dst, qmap, bar, 0, h, q0, b);
    tma_load_4d(dst + kBoxBytes, qmap, bar, 64, h, q0, b);
  }
  __device__ void load_k(uint32_t dst, int j, uint64_t* bar) const {
    tma_load_4d(dst, kmap, bar, 0, kvh, j * kTile, b);
    tma_load_4d(dst + kBoxBytes, kmap, bar, 64, kvh, j * kTile, b);
  }
  __device__ void load_v(uint32_t dst, int j, uint64_t* bar) const {
    tma_load_4d(dst, vmap, bar, 0, kvh, j * kTile, b);
    tma_load_4d(dst + kBoxBytes, vmap, bar, 64, kvh, j * kTile, b);
  }
  __device__ bool live(int key) const {
    return key < seq && (mask == nullptr || mask[key] != 0);
  }
  __device__ void begin(int, int) const {}
  static constexpr uint32_t kExtraKBytes = 0;
  __device__ void read_stage(int, int, float (&)[64]) const {}

  // One tile of the online softmax on raw scores s: kTest 0 (every key
  // live: a tile below the diagonal whose keys are all live), 1 (the
  // liveness word) or 2 (the word and the causal test of the diagonal tile).
  // A masked score becomes kMasked and its p exactly 0.
  template <int kTest>
  __device__ __forceinline__ void online_tile(float (&s)[64], uint4 word, int k0, int row,
                                              float (&o)[64], uint32_t (&p)[32], int t) {
    if (kTest > 0) {
      const uint32_t w[4] = {word.x >> (2 * t), word.y >> (2 * t), word.z >> (2 * t),
                             word.w >> (2 * t)};
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = (w[nb / 4] >> (8 * (nb % 4) + (e & 1))) & 1u;
          if (kTest == 2) ok = ok && k0 + 8 * nb + 2 * t + (e & 1) <= row + 8 * (e >> 1);
          if (!ok) s[4 * nb + e] = kMasked;
        }
      }
    }
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0) * kScale);
    const float mn1 = fmaxf(m1, quad_max(mx1) * kScale);
    const float a0 = ex2_ftz(m0 - mn0), a1 = ex2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = ex2_ftz(fmaf(s[i], kScale, (i & 2) ? -mn1 : -mn0));
      if (kTest > 0 && s[i] == kMasked) x = 0.f;
      s[i] = x;
      if (i & 2) l1 += x; else l0 += x;
      o[i] *= (i & 2) ? a1 : a0;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }

  __device__ void softmax(float (&s)[64], uint4 word, int j, float (&o)[64], uint32_t (&p)[32],
                          int row, int t) {
    // the last tile is the diagonal one: q tile index == key tile index
    if (j == n_tiles - 1) online_tile<2>(s, word, j * kTile, q0 + row, o, p, t);
    else if (all_live(word)) online_tile<0>(s, word, j * kTile, q0 + row, o, p, t);
    else online_tile<1>(s, word, j * kTile, q0 + row, o, p, t);
  }

  __device__ void epilogue(const float (&o)[64], int row, int t) const {
    const int r0 = q0 + row, r1 = r0 + 8;
    store_rows(out, (((long)b * seq + r0) * n_heads + h) * kHeadDim,
               (((long)b * seq + r1) * n_heads + h) * kHeadDim, r0 < seq, r1 < seq, as_rows(o),
               quad_sum(l0), quad_sum(l1), t);
  }
};

__global__ void __launch_bounds__(kBlockThreads, 1)
gqa_causal_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ key_mask,
                  uint16_t* __restrict__ out, int seq, int n_heads, int n_kv) {
  const int q_tile = gridDim.z - 1 - blockIdx.z;   // heaviest first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  GqaCausalPolicy pol{&qmap, &kmap, &vmap,
                      key_mask ? key_mask + (long)b * seq : nullptr, out,
                      q_tile * kTile, h, h / (n_heads / n_kv), b, seq, n_heads, q_tile + 1,
                      kMasked, kMasked, 0.f, 0.f};
  attention_mainloop<GqaCausalPolicy>(pol);
}

}  // namespace

// q [B, S, N, 128], k/v [B, S, KV, 128], out [B, S, N, 128]: bf16, contiguous,
// 16-byte aligned (TMA), N % KV == 0.  key_mask [B, S] uint8 (1 = live) or null.
extern "C" int gqa_causal_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* key_mask, void* out, int batch,
                                         int seq, int heads, int kv_heads, void* stream) {
  if (batch == 0 || seq == 0 || heads == 0) return 0;
  const cuuint64_t row = kHeadDim * 2;
  const cuuint64_t qdims[4] = {kHeadDim, static_cast<cuuint64_t>(heads),
                               static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t kdims[4] = {kHeadDim, static_cast<cuuint64_t>(kv_heads),
                               static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t qstr[3] = {row, row * heads, row * heads * seq};
  const cuuint64_t kstr[3] = {row, row * kv_heads, row * kv_heads * seq};
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, 4, qdims, qstr, 2) || !make_map(&km, k, 4, kdims, kstr, 2) ||
      !make_map(&vm, v, 4, kdims, kstr, 2))
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      gqa_causal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(heads, batch, (seq + kTile - 1) / kTile);
  gqa_causal_kernel<<<grid, kBlockThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<const uint8_t*>(key_mask), static_cast<uint16_t*>(out), seq, heads,
      kv_heads);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of one block, for the report beside ptxas's.
extern "C" int gqa_causal_attention_smem_bytes() { return kSmemBytes; }
