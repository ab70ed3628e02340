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
//     m = the running row max, p = exp2(x - m), l = sum(p) (fp32), and the
//     accumulator and l are rescaled by exp2(m_old - m_new) at each tile;
//     out = (bf16(p) . v) / max(l, 1e-30).
// A query row with no live key has l == 0 and comes out as exactly 0 (the
// TPU kernel gives a mean of the masked values there; see ROADMAP's watch
// list).  S_q <= S_k is not required; ragged S_q and S_k are masked here.
//
// What bounds it on an H100: the tensor cores, as K1 (at B=2, N=24,
// S=8448: 1.75e12 FLOP, 1.77 ms at 989 TFLOP/s); K10b's bias adds 0.57 GB,
// 0.17 ms if read once.  Design: K1's structure (one block of 4 warps per
// 64-row q tile, head and batch; q in mma A fragments; K/V tiles of 64 keys
// staged in shared memory; bf16 mma.sync for both products; P kept in
// registers between them) with K2's running max: per tile a quad max over
// the 4 threads of a row, one exp2 for the rescale factor, and a rescale of
// the 64 accumulator registers.  K10b loads the bias of its two rows into
// registers before each tile's QK^T product, as K7 does (8-byte loads of a
// key pair where the pitch allows), reading the rows with a row pitch and a
// batch stride so a view needs no copy; the head is the fastest grid index,
// so the 24 head-blocks of one q tile read the same bias rows from L2.  Not
// done yet: TMA, wgmma, a multi-stage copy pipeline.
#include "mma_bf16.cuh"

using namespace physicedit;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;

template <bool kBias>
__global__ void __launch_bounds__(kThreads)
online_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
              const uint16_t* __restrict__ v, const float* __restrict__ bias,
              long bias_batch_stride, long bias_row_pitch,
              const uint8_t* __restrict__ key_mask, uint16_t* __restrict__ out,
              int n_heads, int sq, int sk, float scale) {
  __shared__ __align__(16) uint16_t ks[kBlockK * kRowStride];
  __shared__ __align__(16) uint16_t vs[kBlockK * kRowStride];
  __shared__ uint8_t live[kBlockK];

  const int q0 = blockIdx.y * kBlockQ;
  const long bh = (long)blockIdx.z * n_heads + blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const int rg = q0 + wr + g;
  const int rg8 = rg + 8;

  // Stage the q tile through the K buffer into registers.
  load_tile(ks, q + bh * sq * kHeadDim, kHeadDim, q0, sq);
  __syncthreads();
  uint32_t qa[8][4];
  load_q_fragments(qa, ks, wr, g, t);
  __syncthreads();

  float acc[16][4];
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;
  float m_g = kMasked, m_g8 = kMasked;
  float l_g = 0.f, l_g8 = 0.f;

  const uint16_t* kb = k + bh * sk * kHeadDim;
  const uint16_t* vb = v + bh * sk * kHeadDim;
  const uint8_t* mb = key_mask ? key_mask + (long)blockIdx.z * sk : nullptr;
  // the bias rows of this thread's two query rows (a row past S_q reads the
  // last row's values and is never written)
  const float* b_g = nullptr;
  const float* b_g8 = nullptr;
  bool pairs = false;
  if constexpr (kBias) {
    const float* bb = bias + (long)blockIdx.z * bias_batch_stride;
    b_g = bb + (long)min(rg, sq - 1) * bias_row_pitch;
    b_g8 = bb + (long)min(rg8, sq - 1) * bias_row_pitch;
    pairs = bias_row_pitch % 2 == 0 && bias_batch_stride % 2 == 0 &&
            reinterpret_cast<uintptr_t>(bias) % 8 == 0;
  }

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    // C fragment element (j, e) is row g (e < 2) or g + 8, key k0 + 8j + 2t + (e & 1)
    float bv[8][4];
    if constexpr (kBias) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        if (pairs && key + 1 < sk) {
          const float2 lo = __ldg(reinterpret_cast<const float2*>(b_g + key));
          const float2 hi = __ldg(reinterpret_cast<const float2*>(b_g8 + key));
          bv[j][0] = lo.x, bv[j][1] = lo.y, bv[j][2] = hi.x, bv[j][3] = hi.y;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = key + (e & 1);
            bv[j][e] = kk < sk ? __ldg((e < 2 ? b_g : b_g8) + kk) : 0.f;
          }
        }
      }
    }
    load_tile(ks, kb, kHeadDim, k0, sk);
    load_tile(vs, vb, kHeadDim, k0, sk);
    if (threadIdx.x < kBlockK) {
      const int key = k0 + threadIdx.x;
      live[threadIdx.x] = key < sk && (mb == nullptr || mb[key] != 0);
    }
    __syncthreads();

    float s[8][4];
    qk_tile(s, qa, ks, g, t);
    float mx_g = kMasked, mx_g8 = kMasked;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if constexpr (kBias) x = fmaf(bv[j][e], kLog2e, x);
        x = live[8 * j + 2 * t + (e & 1)] ? x : kMasked;
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
  store_rows(out, (bh * sq + rg) * kHeadDim, (bh * sq + rg8) * kHeadDim,
             rg < sq, rg8 < sq, acc, l_g, l_g8, t);
}

dim3 grid_of(int batch, int heads, int sq) {
  // the head fastest: the head-blocks of one (batch, q tile) share its bias rows in L2
  return dim3(heads, (sq + kBlockQ - 1) / kBlockQ, batch);
}

}  // namespace

// q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16, contiguous.
// key_mask [B, Sk] uint8 (1 = live) or null.  scale = log2(e) / sqrt(128) in fp32.
extern "C" int online_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* key_mask, void* out, int batch, int heads,
                                     int sq, int sk, float scale, void* stream) {
  online_kernel<false><<<grid_of(batch, heads, sq), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), nullptr, 0, 0, static_cast<const uint8_t*>(key_mask),
      static_cast<uint16_t*>(out), heads, sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}

// As online_attention_bf16, with a bias: fp32 in natural-log units, element
// (b, row, key) at bias[b * batch_stride + row * row_pitch + key].
extern "C" int online_attention_bias_bf16(const void* q, const void* k, const void* v,
                                          const void* bias, long long bias_batch_stride,
                                          long long bias_row_pitch, const void* key_mask,
                                          void* out, int batch, int heads, int sq, int sk,
                                          float scale, void* stream) {
  online_kernel<true><<<grid_of(batch, heads, sq), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const float*>(bias),
      static_cast<long>(bias_batch_stride), static_cast<long>(bias_row_pitch),
      static_cast<const uint8_t*>(key_mask), static_cast<uint16_t*>(out), heads, sq, sk,
      scale);
  return static_cast<int>(cudaGetLastError());
}
