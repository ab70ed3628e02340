// K7: fixed-max joint attention with a head-shared 2-D bias (EliGen entity
// masks), bf16, head_dim 128.
//
// Replaces physicedit_tpu/kernels/flash_attention.py::_fixedmax_kernel_bias2d
// (called through _fixedmax_bnsd_bias and flash_attention_bnsd when a bias is
// given, from models/dit.py).  It is K1 (fixedmax_attention.cu) with three
// changes of contract:
//     s = fp32(q k^T) * scale + bias[b, row, key]   (scale = log2(e) / sqrt(d),
//                                                    applied here in fp32)
//     p = exp2(min(s, 100))  for live keys, 0 for masked keys (clamp always on)
//     l = sum(p) (fp32),  out = (bf16(p) . v) / max(l, 1e-30)
// q is not pre-scaled; the bias is fp32 [B, S_q, S_k], shared by the heads and
// already multiplied by log2(e) (once per edit, by the pipeline).  Its rows
// are read with a row pitch and a batch stride, so the slim last block passes
// the rows of its base-image queries as a view, not a copy.  The multiply
// and the add are rounded apart (no FMA contraction), as the plain version
// rounds them.  A row whose keys are all blocked has l == 0 and comes out as
// exactly 0.
//
// K1' (physicedit_tpu/kernels/flash_attention.py::_fixedmax_kernel with
// prescaled=False, called through _fixedmax_bnsd) is this kernel with two
// compile-time switches: no bias (kHasBias = false: s = fp32(q k^T) * scale
// alone) and the clamp on or off (kClamp).  K7 is the instantiation with
// both on.
//
// Design: the Hopper mainloop of hopper_attention.cuh (one block per
// 128-row q tile, head and batch row: a producer warpgroup issuing TMA loads
// of Q, K and V into a 2-stage 128-byte-swizzled ring under mbarriers, two
// ping-ponged consumer warpgroups of 64 rows running both products as
// wgmma m64n128k16), with this file's Policy doing the scale multiply, the
// bias add, the clamp and ex2 in the consumer's fp32 S registers.
//
// Where the bias lives: shared memory, each consumer warp's own 8 KB (its
// 16 q rows x 128 keys of the tile, fp32), staged a phase ahead with
// cp.async by hopper_attention.cuh's BiasSlots (K10b shares it).  64 KB in
// all, on top of the mainloop's 165,888 B: 231,424 of the 232,448 B a block
// may use, so one tile and no second buffer.  Registers instead (the bias
// loaded between the products' commit and wait) would add 64 live floats to
// the consumer's o 64 + s 64 + p 32 under its 232-register cap.
//
// What bounds it on an H100: L2 traffic.  The products take 1.77 ms at B=2,
// N=24, S=8448 (1.75e12 FLOP at 989 TFLOP/s), and the bias adds 4 bytes per
// score against 512 FLOP per score.  Each (head, q tile) block reads its own
// bias rows, 24 x 571 MB = 13.7 GB from L2 a call, and streams its head's K
// and V, another 66 q tiles x 208 MB = 13.7 GB.  On an H100 80GB HBM3 at
// 700 W the call takes 4.6 ms where the bias-free instantiation takes 2.6 on
// the same inputs (chip_smoke.py): 27.4 GB at about 6 TB/s, the rate K1's
// 13.7 GB of K/V reads reach.  The grid puts the head on the fastest block
// index (the bias-free K1' keeps K1's order, q tile fastest), so the 24
// head-blocks of one (batch, q tile) run side by side and read the same bias
// rows, which the 50 MB L2 then serves from one HBM read.  Sharing one bias
// tile across heads in a thread-block cluster would cut the L2 traffic (not
// done).  Keys past S_k arrive as TMA's zeros and are zeroed by the liveness
// word, as in K1; p below 2^-126 flushes to 0 (ex2.approx.ftz), as in K1.
#include "hopper_attention.cuh"

using namespace physicedit;
using namespace physicedit::hopper;

namespace {

constexpr float kClampValue = 100.f;

template <bool kHasBias, bool kClampOn>
struct ScaledPolicy {
  const CUtensorMap* qmap;
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  const uint8_t* mask;    // this batch row's [S_k] (1 = live), or null
  uint16_t* out;          // this (batch, head)'s [S_q, 128]
  BiasSlots bias;         // unused without the bias
  int q0, bh, sq, sk, n_tiles;
  float scale;
  float l0, l1;           // row-sum partials of the thread's rows

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

  // p = exp2(min(s * scale + bias, 100)) where live, else 0; the row sums;
  // P packed to bf16.  A tile whose 128 keys are all live skips the liveness
  // test (kTest).
  template <bool kTest>
  __device__ __forceinline__ void exp_tile(float (&s)[64], uint4 word, uint32_t (&p)[32],
                                           int t) {
    const uint32_t w[4] = {word.x >> (2 * t), word.y >> (2 * t), word.z >> (2 * t),
                           word.w >> (2 * t)};
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
      float2 b0, b1;   // rows g and g + 8, keys 8 nb + 2t and + 1
      if constexpr (kHasBias) bias.read(nb, b0, b1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[4 * nb + e], scale);
        if constexpr (kHasBias) {
          const float2 b = e < 2 ? b0 : b1;
          x = __fadd_rn(x, (e & 1) ? b.y : b.x);
        }
        x = ex2_ftz(kClampOn ? fminf(x, kClampValue) : x);
        if (kTest && !((w[nb / 4] >> (8 * (nb % 4) + (e & 1))) & 1u)) x = 0.f;
        s[4 * nb + e] = x;
        if (e < 2) l0 += x; else l1 += x;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }

  __device__ void softmax(float (&s)[64], uint4 word, int j, float (&)[64], uint32_t (&p)[32],
                          int, int t) {
    if constexpr (kHasBias) bias.wait();
    if (all_live(word)) exp_tile<false>(s, word, p, t);
    else exp_tile<true>(s, word, p, t);
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
template <bool kHasBias, bool kClampOn>
__global__ void __launch_bounds__(kBlockThreads, 1)
fixedmax_bias_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const float* __restrict__ bias,
                     long bias_batch_stride, long bias_row_pitch, int wide,
                     const uint8_t* __restrict__ key_mask, uint16_t* __restrict__ out,
                     int n_heads, int sq, int sk, float scale) {
  using Policy = ScaledPolicy<kHasBias, kClampOn>;
  const int head = kHasBias ? blockIdx.x : blockIdx.y;
  const int q_tile = kHasBias ? blockIdx.y : blockIdx.x;
  const int bh = blockIdx.z * n_heads + head;
  Policy pol{&qmap, &kmap, &vmap,
             key_mask ? key_mask + (long)blockIdx.z * sk : nullptr,
             out + (long)bh * sq * kHeadDim,
             BiasSlots{kHasBias ? bias + (long)blockIdx.z * bias_batch_stride : nullptr,
                       bias_row_pitch, wide != 0, sq, sk, 0, 0u, 0u},
             q_tile * kTile, bh, sq, sk, (sk + kTile - 1) / kTile, scale, 0.f, 0.f};
  attention_mainloop<Policy>(pol);
}

template <bool kHasBias, bool kClampOn>
int launch_kernel(const void* q, const void* k, const void* v, const float* bias,
                  long long batch_stride, long long row_pitch, const void* key_mask, void* out,
                  int batch, int heads, int sq, int sk, float scale, void* stream) {
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bias_kernel<fixedmax_bias_kernel<kHasBias, kClampOn>, kHasBias>(
      q, k, v, bias, batch_stride, row_pitch, key_mask, out, batch, heads, sq, sk, scale,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16, contiguous,
// 16-byte aligned (TMA).  bias: fp32, element (b, row, key) at
// bias[b * batch_stride + row * row_pitch + key], already times log2(e).
// key_mask [B, Sk] uint8 (1 = live) or null.  scale = log2(e) / sqrt(128) in
// fp32.  Sq <= Sk.
extern "C" int fixedmax_attention_bias_bf16(const void* q, const void* k, const void* v,
                                            const void* bias, long long bias_batch_stride,
                                            long long bias_row_pitch, const void* key_mask,
                                            void* out, int batch, int heads, int sq, int sk,
                                            float scale, void* stream) {
  return launch_kernel<true, true>(q, k, v, static_cast<const float*>(bias), bias_batch_stride,
                                   bias_row_pitch, key_mask, out, batch, heads, sq, sk, scale,
                                   stream);
}

// K1': q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16,
// contiguous, 16-byte aligned (TMA).  No bias; q scaled in fp32 here (scale =
// log2(e) / sqrt(128)); the clamp on when clamp != 0.  key_mask [B, Sk] uint8
// (1 = live) or null.
extern "C" int fixedmax_attention_scaled_bf16(const void* q, const void* k, const void* v,
                                              const void* key_mask, void* out, int batch,
                                              int heads, int sq, int sk, int clamp,
                                              float scale, void* stream) {
  return clamp ? launch_kernel<false, true>(q, k, v, nullptr, 0, 0, key_mask, out, batch, heads,
                                            sq, sk, scale, stream)
               : launch_kernel<false, false>(q, k, v, nullptr, 0, 0, key_mask, out, batch,
                                             heads, sq, sk, scale, stream);
}

// The dynamic shared memory of one block, for the report beside ptxas's: K7
// (with the bias slots) and K1' scaled.
extern "C" int fixedmax_attention_bias_smem_bytes() { return kSmemBytes + kBiasSlotBytes; }
extern "C" int fixedmax_attention_scaled_smem_bytes() { return kSmemBytes; }
