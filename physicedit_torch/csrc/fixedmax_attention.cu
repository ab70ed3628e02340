// K1: fixed-max joint attention of the Qwen-Image DiT, bf16, head_dim 128.
//
// Replaces physicedit_tpu/kernels/flash_attention.py::_fixedmax_kernel_lse
// (called through _fixedmax_bnsd_lse and flash_attention_bnsd from
// models/dit.py).  The DiT RMS-norms q and k per head, so the logits are
// bounded and the softmax needs no running max:
//     p = exp2(min(q' k^T, 100))   for live keys, 0 for masked keys
//     l = sum(p) (fp32),  out = (bf16(p) . v) / max(l, 1e-30)
// where q' = q * log2(e) / sqrt(d) is applied by the wrapper in q's dtype.
// The clamp is a switch; a row whose keys are all masked has l == 0 and
// comes out as exactly 0.
//
// What bounds it on an H100: the tensor cores.  At the reference shape
// (B=2, N=24, S=8448, D=128) one call is 2 * 2 * B*N*S^2*D = 1.75e12 FLOP
// over 0.2 GB of q/k/v, about 8,000 FLOP per byte, far above the card's
// ~295 FLOP/byte ridge.  Design: the Hopper mainloop of hopper_attention.cuh
// (TMA into a swizzled K/V ring, wgmma.mma_async for both products, a
// producer warpgroup and two ping-ponged consumer warpgroups of 64 q rows)
// with this file's Policy, which keeps the softmax under the products' time:
// the clamp is a template switch, exp2 runs as one ex2.approx.ftz, and a tile
// whose 128 keys are all live skips the liveness test.  Without a running max
// there is no rescale of O and no cross-thread reduction inside the loop: l
// is reduced across the 4 threads of a row once, in the epilogue.  Keys past
// S_k arrive as TMA's zeros (exp2(0) = 1), so the liveness word, not the
// data, zeroes them.  Numerics: p below 2^-126 flushes to 0 where the plain
// version keeps it subnormal; both divide by max(l, 1e-30), so only a row
// whose every live logit is below -126 (far outside the DiT's RMS-normed
// range) differs, by at most S_k * 2^-126 / 1e-30 of max |v| (1e-4 at 8448
// keys).
#include "hopper_attention.cuh"

using namespace physicedit;
using namespace physicedit::hopper;

namespace {

constexpr float kClamp = 100.f;

// kClampOn: min(s, 100) before exp2 (the DiT's attn_clamp), a template switch
// so that the unclamped loop pays nothing for it.
template <bool kClampOn>
struct FixedMaxPolicy {
  const CUtensorMap* qmap;
  const CUtensorMap* kmap;
  const CUtensorMap* vmap;
  const uint8_t* mask;    // this batch row's [S_k] (1 = live), or null
  uint16_t* out;          // this (batch, head)'s [S_q, 128]
  float* l_out;           // this (batch, head)'s [S_q], or null
  int q0, bh, sq, sk, n_tiles;
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
  __device__ void begin(int, int) const {}
  static constexpr uint32_t kExtraKBytes = 0;
  __device__ void read_stage(int, int, float (&)[64]) const {}

  // p = exp2(min(s, 100)) where live, else 0; the row sums; P packed to bf16.
  // A tile whose 128 keys are all live skips the liveness test (kTest).
  template <bool kTest>
  __device__ __forceinline__ void exp_tile(float (&s)[64], uint4 word, uint32_t (&p)[32],
                                           int t) {
    const uint32_t w[4] = {word.x >> (2 * t), word.y >> (2 * t), word.z >> (2 * t),
                           word.w >> (2 * t)};
#pragma unroll
    for (int nb = 0; nb < 16; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = ex2_ftz(kClampOn ? fminf(s[4 * nb + e], kClamp) : s[4 * nb + e]);
        if (kTest && !((w[nb / 4] >> (8 * (nb % 4) + (e & 1))) & 1u)) x = 0.f;
        s[4 * nb + e] = x;
        if (e < 2) l0 += x; else l1 += x;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  }

  __device__ void softmax(float (&s)[64], uint4 word, int, float (&)[64], uint32_t (&p)[32], int,
                          int t) {
    if (all_live(word)) exp_tile<false>(s, word, p, t);
    else exp_tile<true>(s, word, p, t);
  }

  __device__ void epilogue(const float (&o)[64], int row, int t) const {
    const float lg = quad_sum(l0), lg8 = quad_sum(l1);
    const int r0 = q0 + row, r1 = r0 + 8;
    store_rows(out, (long)r0 * kHeadDim, (long)r1 * kHeadDim, r0 < sq, r1 < sq, as_rows(o), lg,
               lg8, t);
    if (l_out != nullptr && t == 0) {
      if (r0 < sq) l_out[r0] = lg;
      if (r1 < sq) l_out[r1] = lg8;
    }
  }
};

template <bool kClampOn>
__global__ void __launch_bounds__(kBlockThreads, 1)
fixedmax_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ key_mask,
                uint16_t* __restrict__ out, float* __restrict__ l_out, int n_heads, int sq,
                int sk) {
  using Policy = FixedMaxPolicy<kClampOn>;
  const int bh = blockIdx.z * n_heads + blockIdx.y;
  Policy pol{&qmap, &kmap, &vmap,
             key_mask ? key_mask + (long)blockIdx.z * sk : nullptr,
             out + (long)bh * sq * kHeadDim,
             l_out ? l_out + (long)bh * sq : nullptr,
             (int)blockIdx.x * kTile, bh, sq, sk, (sk + kTile - 1) / kTile, 0.f, 0.f};
  attention_mainloop<Policy>(pol);
}

template <bool kClampOn>
int launch_kernel(const void* q, const void* k, const void* v, const void* key_mask, void* out,
                  void* l, int batch, int heads, int sq, int sk, void* stream) {
  if (batch == 0 || heads == 0 || sq == 0) return 0;
  if (sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!make_bnsd_maps(&qm, &km, &vm, q, k, v, batch * heads, sq, sk))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fixedmax_kernel<kClampOn>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((sq + kTile - 1) / kTile, heads, batch);
  kernel<<<grid, kBlockThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<const uint8_t*>(key_mask), static_cast<uint16_t*>(out),
      static_cast<float*>(l), heads, sq, sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, N, Sq, 128], k/v [B, N, Sk, 128], out [B, N, Sq, 128]: bf16, contiguous,
// 16-byte aligned (TMA).  key_mask [B, Sk] uint8 (1 = live) or null; l [B, N, Sq]
// fp32 or null.
extern "C" int fixedmax_attention_bf16(const void* q, const void* k, const void* v,
                                       const void* key_mask, void* out, void* l,
                                       int batch, int heads, int sq, int sk, int clamp,
                                       void* stream) {
  return clamp ? launch_kernel<true>(q, k, v, key_mask, out, l, batch, heads, sq, sk, stream)
               : launch_kernel<false>(q, k, v, key_mask, out, l, batch, heads, sq, sk, stream);
}

// The dynamic shared memory of one block, for the report beside ptxas's.
extern "C" int fixedmax_attention_smem_bytes() { return kSmemBytes; }
