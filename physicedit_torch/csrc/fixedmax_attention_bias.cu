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
// the rows of its base-image queries as a view, not a copy.  A row whose keys
// are all blocked has l == 0 and comes out as exactly 0.
//
// What bounds it on an H100: the tensor cores, as K1 (at B=2, N=24, S=8448:
// 1.75e12 FLOP, 1.77 ms at 989 TFLOP/s); the bias adds 0.57 GB, 0.17 ms of
// bytes if read once.  Design: K1's (64-row q tile in mma A fragments, K/V
// tiles of 64 keys staged in shared memory, P kept in registers between the
// two products), with the bias of the thread's two rows loaded from global
// memory into registers before each tile's QK^T product so the loads overlap
// it, as 8-byte loads of a key pair where the pitch allows (the bias tile is
// not staged in shared memory, where its loads would sit on the critical path
// of every tile).  The grid puts the head on the fastest-varying block
// index: the 24 head-blocks of one (batch, q-tile) run next to each other and
// read the same bias rows, which the 50 MB L2 then serves instead of HBM 24
// times.  The products' rounding is
// kept apart (no FMA contraction of the scale and the bias add), as the
// plain version rounds them.  Not done yet: TMA, wgmma, a multi-stage copy
// pipeline.
//
// K1' (physicedit_tpu/kernels/flash_attention.py::_fixedmax_kernel with
// prescaled=False, called through _fixedmax_bnsd) is this kernel with two
// compile-time switches: no bias (kHasBias = false: s = fp32(q k^T) * scale
// alone, no bias loads) and the clamp on or off (kClamp).  K7 is the
// instantiation with both on, the code it had before the switches.
#include "mma_bf16.cuh"

using namespace physicedit;

namespace {

constexpr float kClampValue = 100.f;

template <bool kHasBias, bool kClamp>
__global__ void __launch_bounds__(kThreads)
fixedmax_bias_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
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
  float l_g = 0.f, l_g8 = 0.f;

  const uint16_t* kb = k + bh * sk * kHeadDim;
  const uint16_t* vb = v + bh * sk * kHeadDim;
  const uint8_t* mb = key_mask ? key_mask + (long)blockIdx.z * sk : nullptr;
  // the bias rows of this thread's two query rows (a row past S_q reads the
  // last row's values and is never written)
  const float* b_g = nullptr;
  const float* b_g8 = nullptr;
  bool pairs = false;
  if constexpr (kHasBias) {
    const float* bb = bias + (long)blockIdx.z * bias_batch_stride;
    b_g = bb + (long)min(rg, sq - 1) * bias_row_pitch;
    b_g8 = bb + (long)min(rg8, sq - 1) * bias_row_pitch;
    // a thread's two keys (2t, 2t + 1) as one 8-byte load
    pairs = bias_row_pitch % 2 == 0 && bias_batch_stride % 2 == 0 &&
            reinterpret_cast<uintptr_t>(bias) % 8 == 0;
  }

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    // C fragment element (j, e) is row g (e < 2) or g + 8, key k0 + 8j + 2t + (e & 1)
    float bv[8][4];
    if constexpr (kHasBias) {
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
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(s[j][e], scale);
        if constexpr (kHasBias) x = __fadd_rn(x, bv[j][e]);
        if constexpr (kClamp) x = fminf(x, kClampValue);
        const float p = live[8 * j + 2 * t + (e & 1)] ? exp2f(x) : 0.f;
        s[j][e] = p;
        if (e < 2) l_g += p; else l_g8 += p;
      }
    }
    pv_tile(acc, s, vs, g, t);
    __syncthreads();
  }

  l_g = quad_sum(l_g);
  l_g8 = quad_sum(l_g8);
  store_rows(out, (bh * sq + rg) * kHeadDim, (bh * sq + rg8) * kHeadDim,
             rg < sq, rg8 < sq, acc, l_g, l_g8, t);
}

}  // namespace

// q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16, contiguous.
// bias: fp32, element (b, row, key) at bias[b * batch_stride + row * row_pitch
// + key], already times log2(e).  key_mask [B, Sk] uint8 (1 = live)
// or null.  scale = log2(e) / sqrt(128) in fp32.
extern "C" int fixedmax_attention_bias_bf16(const void* q, const void* k, const void* v,
                                            const void* bias, long long bias_batch_stride,
                                            long long bias_row_pitch, const void* key_mask,
                                            void* out, int batch, int heads, int sq, int sk,
                                            float scale, void* stream) {
  // the head fastest: the head-blocks of one (batch, q tile) share its bias rows in L2
  const dim3 grid(heads, (sq + kBlockQ - 1) / kBlockQ, batch);
  fixedmax_bias_kernel<true, true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const float*>(bias),
      static_cast<long>(bias_batch_stride), static_cast<long>(bias_row_pitch),
      static_cast<const uint8_t*>(key_mask), static_cast<uint16_t*>(out), heads, sq, sk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// K1': q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16,
// contiguous.  No bias; q scaled in fp32 here (scale = log2(e) / sqrt(128));
// the clamp on when clamp != 0.  key_mask [B, Sk] uint8 (1 = live) or null.
extern "C" int fixedmax_attention_scaled_bf16(const void* q, const void* k, const void* v,
                                              const void* key_mask, void* out, int batch,
                                              int heads, int sq, int sk, int clamp,
                                              float scale, void* stream) {
  const dim3 grid(heads, (sq + kBlockQ - 1) / kBlockQ, batch);
  const auto kernel = clamp ? fixedmax_bias_kernel<false, true>
                            : fixedmax_bias_kernel<false, false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), nullptr, 0, 0, static_cast<const uint8_t*>(key_mask),
      static_cast<uint16_t*>(out), heads, sq, sk, scale);
  return static_cast<int>(cudaGetLastError());
}
