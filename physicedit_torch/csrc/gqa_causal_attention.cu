// K2: causal grouped-query attention of the Qwen2.5-VL prefill and prompt
// encode, bf16, head_dim 128.
//
// Replaces physicedit_tpu/kernels/flash_attention.py::_gqa_causal_kernel
// (called through _gqa_causal_bnsd and gqa_causal_flash from
// models/qwen_vl.py::_prefill_attention).  Query head h reads K/V head
// h / (N / KV); K/V are never repeated.  Causality is by absolute position
// and a key padding mask excludes padded keys, so left- and right-padded
// batches both work.  Qwen has no q/k norm, so the logits are unbounded and
// the softmax keeps a running max (online softmax, in exp2 units).
// A query row with no live key (a left-pad row) has l == 0 and comes out as
// exactly 0; the caller discards such rows.
//
// What bounds it on an H100: the tensor cores once S is a few hundred
// (2 * 2 * B*N*S^2*D / 2 FLOP under the causal mask against
// (B*S*(N + 2*KV)*D) * 2 bytes).  Design: one block of 4 warps per (64-row q
// tile, q head, batch), reading the inputs in their [B, S, heads, D] layout
// with a row pitch (no transposes); K/V tiles of 64 keys staged in shared
// memory; bf16 mma.sync with fp32 accumulators; P kept in registers between
// the two products; tiles wholly above the causal diagonal are skipped.  Not
// done yet: sharing one K/V tile across the 7 q heads of a group, TMA,
// wgmma, a multi-stage copy pipeline.
#include "mma_bf16.cuh"

using namespace physicedit;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

__global__ void __launch_bounds__(kThreads)
gqa_causal_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                  const uint16_t* __restrict__ v, const uint8_t* __restrict__ key_mask,
                  uint16_t* __restrict__ out, int seq, int n_heads, int n_kv) {
  __shared__ __align__(16) uint16_t ks[kBlockK * kRowStride];
  __shared__ __align__(16) uint16_t vs[kBlockK * kRowStride];
  __shared__ uint8_t live[kBlockK];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const long b = blockIdx.z;
  const int kvh = h / (n_heads / n_kv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const long q_pitch = (long)n_heads * kHeadDim;
  const long kv_pitch = (long)n_kv * kHeadDim;
  const uint16_t* qb = q + (b * seq * n_heads + h) * kHeadDim;

  load_tile(ks, qb, q_pitch, q0, seq);
  __syncthreads();
  uint32_t qa[8][4];
  load_q_fragments(qa, ks, wr, g, t);
  __syncthreads();

  float acc[16][4];
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;
  float m_g = kMasked, m_g8 = kMasked;
  float l_g = 0.f, l_g8 = 0.f;

  const int rg = q0 + wr + g;
  const int rg8 = rg + 8;
  const float scale = kLog2e * rsqrtf((float)kHeadDim);
  const uint16_t* kb = k + (b * seq * n_kv + kvh) * kHeadDim;
  const uint16_t* vb = v + (b * seq * n_kv + kvh) * kHeadDim;
  const uint8_t* mb = key_mask ? key_mask + b * seq : nullptr;
  const int k_end = min(seq, q0 + kBlockQ);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    load_tile(ks, kb, kv_pitch, k0, seq);
    load_tile(vs, vb, kv_pitch, k0, seq);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      live[threadIdx.x] = key < seq && (mb == nullptr || mb[key] != 0);
    }
    __syncthreads();

    float s[8][4];
    qk_tile(s, qa, ks, g, t);
    float mx_g = kMasked, mx_g8 = kMasked;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? rg : rg8;
        const bool ok = live[col] && k0 + col <= row;
        const float x = ok ? s[j][e] * scale : kMasked;
        s[j][e] = x;
        if (e < 2) mx_g = fmaxf(mx_g, x); else mx_g8 = fmaxf(mx_g8, x);
      }
    }
    const float mn_g = fmaxf(m_g, quad_max(mx_g));
    const float mn_g8 = fmaxf(m_g8, quad_max(mx_g8));
    const float alpha_g = exp2f(m_g - mn_g);
    const float alpha_g8 = exp2f(m_g8 - mn_g8);
    m_g = mn_g;
    m_g8 = mn_g8;
    l_g *= alpha_g;
    l_g8 *= alpha_g8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x > 0.5f * kMasked ? exp2f(x - (e < 2 ? mn_g : mn_g8)) : 0.f;
        s[j][e] = p;
        if (e < 2) l_g += p; else l_g8 += p;
      }
    }
#pragma unroll
    for (int jd = 0; jd < 16; ++jd) {
      acc[jd][0] *= alpha_g;
      acc[jd][1] *= alpha_g;
      acc[jd][2] *= alpha_g8;
      acc[jd][3] *= alpha_g8;
    }
    pv_tile(acc, s, vs, g, t);
    __syncthreads();
  }

  l_g = quad_sum(l_g);
  l_g8 = quad_sum(l_g8);
  store_rows(out, ((b * seq + rg) * n_heads + h) * kHeadDim,
             ((b * seq + rg8) * n_heads + h) * kHeadDim,
             rg < seq, rg8 < seq, acc, l_g, l_g8, t);
}

}  // namespace

// q [B, S, N, 128], k/v [B, S, KV, 128], out [B, S, N, 128]: bf16, contiguous,
// N % KV == 0.  key_mask [B, S] uint8 (1 = live) or null.
extern "C" int gqa_causal_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* key_mask, void* out, int batch,
                                         int seq, int heads, int kv_heads, void* stream) {
  const dim3 grid((seq + kBlockQ - 1) / kBlockQ, heads, batch);
  gqa_causal_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint8_t*>(key_mask),
      static_cast<uint16_t*>(out), seq, heads, kv_heads);
  return static_cast<int>(cudaGetLastError());
}
