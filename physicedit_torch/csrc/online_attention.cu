// K10 / K10b: online-softmax attention (a running max), bf16, head_dim 128,
// with an optional head-shared 2-D bias.
//
// Replaces physicedit_tpu/kernels/flash_attention.py::_flash_kernel (K10,
// called through _flash_bnsd) and _flash_kernel_bias (K10b, through
// _flash_bnsd_bias), both entered through flash_attention_bnsd(variant=
// "online").  Unlike K1 and K7 it assumes nothing of the logits' size: it is
// the attention that stays right for unnormalised q and k.
//     x = fp32(q k^T) * scale (+ bias[b, row, key] * log2(e), one FMA)
//         with scale = log2(e) / sqrt(d) in fp32 and the bias in natural-log
//         units, so exp2(x) is the JAX kernel's exp(s / sqrt(d) + bias);
//     a key that is masked, or whose biased x is below -5e29 (a -1e30 bias),
//     takes no weight;
//     m = the running row max over each 128-key tile, p = exp2(x - m),
//     l = sum(p) (fp32), and the accumulator and l are rescaled by
//     exp2(m_old - m_new) at each tile;
//     out = (bf16(p) . v) / max(l, 1e-30).
// A query row with no live key has l == 0 and comes out as exactly 0 (the
// TPU kernel gives a mean of the masked values there; see ROADMAP's watch
// list).  Any S_q against any S_k (S_q > S_k too); ragged S_q and S_k are
// masked here.
//
// What bounds it on an H100: the tensor cores, as K1 (at B=2, N=24,
// S=8448: 1.75e12 FLOP, 1.77 ms at 989 TFLOP/s); K10b's bias adds 0.57 GB,
// 0.17 ms if read once from HBM, but each (head, q tile) block reads its
// own rows from L2, 24 x 0.57 GB a call, the traffic that bounds K7.
// Design: the Hopper mainloop of hopper_attention.cuh (one block per 128-row
// q tile, head and batch row; a producer warpgroup issuing TMA loads of Q,
// K and V into a 2-stage 128-byte-swizzled ring; two ping-ponged consumer
// warpgroups of 64 rows running both products as wgmma m64n128k16) with
// this file's Policy: K2's running max over K1's non-causal grid.  Per tile
// and row, a max over the thread's 32 scores and a quad max across the 4
// threads of a row, one ex2 for the rescale factor, a rescale of l and of
// the 64 accumulator registers (the P V product of the tile before has
// landed by then), and p = exp2(x - m) as one ex2.approx.ftz.  Without a
// bias the max is taken over the raw scores and scaled after (the scale is
// positive, and fp32 rounding keeps the order), so that x - m is one FFMA.
// With a bias x is formed first and the max taken over it, and every score
// is tested against -5e29 even on a tile whose keys are all live: a key the
// bias blocks is no masked key.  A -1e30 bias puts x at -1.44e30, below the
// running max's start (-1e30), where exp2(x - m) is 0 anyway, but a bias
// between about -6.9e29 and -3.5e29 blocks its key and leaves x above that
// start, and a row it blocks wholly would weigh each key by 1.  Only the
// key-mask test is skipped on an all-live tile.  K10b
// stages its bias rows as K7 does (BiasSlots: each consumer warp's 16 rows
// x 128 keys in shared memory, copied a phase ahead with cp.async, 16-byte
// copies where the pitch, stride and base allow, 4-byte ones otherwise), in
// natural-log units, folded here by one FMA; the head is the fastest grid
// index, so the 24 head-blocks of one (batch, q tile) read the same bias
// rows from L2.  Keys past S_k arrive as TMA's zeros and are dead in the
// liveness word; p below 2^-126 of the row max flushes to 0.
#include "hopper_attention.cuh"

using namespace physicedit;
using namespace physicedit::hopper;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

template <bool kHasBias>
struct OnlinePolicy {
  const CUtensorMap* qmap;
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  const uint8_t* mask;    // this batch row's [S_k] (1 = live), or null
  uint16_t* out;          // this (batch, head)'s [S_q, 128]
  BiasSlots bias;         // unused without the bias
  int q0, bh, sq, sk, n_tiles;
  float scale;
  float m0, m1, l0, l1;   // running max (exp2 units) and row-sum partials of the thread's rows

  __device__ void load_q(uint32_t dst, uint64_t* bar) const {
    tma_load_3d(dst, qmap, bar, 0, q0, bh);
    tma_load_3d(dst + kBoxBytes, qmap, bar, 64, q0, bh);
  }
  __device__ void load_k(uint32_t dst, int j, uint64_t* bar) const {
    tma_load_3d(dst, kmap, bar, 0, j * kTile, bh);
    tma_load_3d(dst + kBoxBytes, kmap, bar, 64, j * kTile, bh);
  }
  __device__ void load_v(uint32_t dst, int j, uint64_t* bar) const {
    tma_load_3d(dst, vmap, bar, 0, j * kTile, bh);
    tma_load_3d(dst + kBoxBytes, vmap, bar, 64, j * kTile, bh);
  }
  __device__ bool live(int key) const { return key < sk && (mask == nullptr || mask[key] != 0); }

  __device__ void begin(int row, int t) {
    if constexpr (kHasBias) bias.begin(q0 + row, t);
  }
  static constexpr uint32_t kExtraKBytes = 0;   // the bias rides its own cp.async
  __device__ void read_stage(int, int, float (&)[64]) const {}

  // One tile of the online softmax on the raw scores s: s becomes x (with a
  // bias) and a masked key kMasked; then the running max, the rescale of l
  // and o, p and the row sums, and P packed to bf16.  kTest: the key-mask
  // test (a tile whose 128 keys are all live skips it).
  template <bool kTest>
  __device__ __forceinline__ void online_tile(float (&s)[64], uint4 word, float (&o)[64],
                                              uint32_t (&p)[32], int t) {
    const uint32_t w[4] = {word.x >> (2 * t), word.y >> (2 * t), word.z >> (2 * t),
                           word.w >> (2 * t)};
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      float2 b0, b1;   // rows g and g + 8, keys 8 nb + 2t and + 1
      if constexpr (kHasBias) bias.read(nb, b0, b1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * nb + e];
        if constexpr (kHasBias) {
          const float2 b = e < 2 ? b0 : b1;
          x = fmaf((e & 1) ? b.y : b.x, kLog2e, __fmul_rn(x, scale));
        }
        if (kTest && !((w[nb / 4] >> (8 * (nb % 4) + (e & 1))) & 1u)) x = kMasked;
        s[4 * nb + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float mn0 = fmaxf(m0, kHasBias ? mx0 : mx0 * scale);
    const float mn1 = fmaxf(m1, kHasBias ? mx1 : mx1 * scale);
    const float a0 = ex2_ftz(m0 - mn0), a1 = ex2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const float x = s[i];
      const float mn = (i & 2) ? mn1 : mn0;
      float pr;
      if constexpr (kHasBias) {
        pr = x > 0.5f * kMasked ? ex2_ftz(x - mn) : 0.f;
      } else {
        pr = ex2_ftz(fmaf(x, scale, -mn));
        if (kTest && x == kMasked) pr = 0.f;
      }
      s[i] = pr;
      if (i & 2) l1 += pr; else l0 += pr;
      o[i] *= (i & 2) ? a1 : a0;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }

  __device__ void softmax(float (&s)[64], uint4 word, int j, float (&o)[64], uint32_t (&p)[32],
                          int, int t) {
    if constexpr (kHasBias) bias.wait();
    if (all_live(word)) online_tile<false>(s, word, o, p, t);
    else online_tile<true>(s, word, o, p, t);
    if constexpr (kHasBias) bias.release(j, n_tiles);
  }

  __device__ void epilogue(const float (&o)[64], int row, int t) const {
    const int r0 = q0 + row, r1 = r0 + 8;
    store_rows(out, (long)r0 * kHeadDim, (long)r1 * kHeadDim, r0 < sq, r1 < sq, as_rows(o),
               quad_sum(l0), quad_sum(l1), t);
  }
};

// The grid (launch_bias_kernel): (heads, q tiles, batch) with the bias,
// (q tiles, heads, batch) without.
template <bool kHasBias>
__global__ void __launch_bounds__(kBlockThreads, 1)
online_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
              long bias_batch_stride, long bias_row_pitch, int wide,
              const uint8_t* __restrict__ key_mask, uint16_t* __restrict__ out, int n_heads,
              int sq, int sk, float scale) {
  using Policy = OnlinePolicy<kHasBias>;
  const int head = kHasBias ? blockIdx.x : blockIdx.y;
  const int q_tile = kHasBias ? blockIdx.y : blockIdx.x;
  const int bh = blockIdx.z * n_heads + head;
  Policy pol{&qmap, &kmap, &vmap,
             key_mask ? key_mask + (long)blockIdx.z * sk : nullptr,
             out + (long)bh * sq * kHeadDim,
             BiasSlots{kHasBias ? bias + (long)blockIdx.z * bias_batch_stride : nullptr,
                       bias_row_pitch, wide != 0, sq, sk, 0, 0u, 0u},
             q_tile * kTile, bh, sq, sk, (sk + kTile - 1) / kTile, scale,
             kMasked, kMasked, 0.f, 0.f};
  attention_mainloop<Policy>(pol);
}

template <bool kHasBias>
int launch_kernel(const void* q, const void* k, const void* v, const float* bias,
                  long long batch_stride, long long row_pitch, const void* key_mask, void* out,
                  int batch, int heads, int sq, int sk, float scale, void* stream) {
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sk == 0)   // no key at all: every row is a row with no live key
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(batch) * heads * sq * kHeadDim * 2, st));
  return launch_bias_kernel<online_kernel<kHasBias>, kHasBias>(
      q, k, v, bias, batch_stride, row_pitch, key_mask, out, batch, heads, sq, sk, scale, st);
}

}  // namespace

// q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16, contiguous,
// 16-byte aligned (TMA).  key_mask [B, Sk] uint8 (1 = live) or null.
// scale = log2(e) / sqrt(128) in fp32.
extern "C" int online_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* key_mask, void* out, int batch, int heads,
                                     int sq, int sk, float scale, void* stream) {
  return launch_kernel<false>(q, k, v, nullptr, 0, 0, key_mask, out, batch, heads, sq, sk,
                              scale, stream);
}

// As online_attention_bf16, with a bias: fp32 in natural-log units, element
// (b, row, key) at bias[b * batch_stride + row * row_pitch + key].
extern "C" int online_attention_bias_bf16(const void* q, const void* k, const void* v,
                                          const void* bias, long long bias_batch_stride,
                                          long long bias_row_pitch, const void* key_mask,
                                          void* out, int batch, int heads, int sq, int sk,
                                          float scale, void* stream) {
  return launch_kernel<true>(q, k, v, static_cast<const float*>(bias), bias_batch_stride,
                             bias_row_pitch, key_mask, out, batch, heads, sq, sk, scale,
                             stream);
}

// The dynamic shared memory of one block, for the report beside ptxas's.
extern "C" int online_attention_smem_bytes() { return kSmemBytes; }
extern "C" int online_attention_bias_smem_bytes() { return kSmemBytes + kBiasSlotBytes; }
