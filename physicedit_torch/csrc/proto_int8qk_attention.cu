// T4: fixed-max attention with an int8 QK^T, head_dim 128.
//
// Replaces tools/proto_attn_int8qk.py::fixedmax_int8qk (body _kernel), the
// Pallas prototype its measurement tool drives (the port of both is
// physicedit_torch/tools/proto_attn_int8qk.py).  q and k arrive quantized
// per row by the wrapper, q = qs * q8 and k = ks * k8 with int8 codes and fp32
// scales that carry sqrt(log2(e) / sqrt(d)) each; per key tile:
//     s  = q8 k8^T                                   exact int32
//     sf = fp32(s) * qs[row] * ks[key] + key_bias[b, key]   (each step rounded)
//     p  = exp2(min(sf, 100)),  l += p (fp32)
//     acc += bf16(p) . v (fp32)
// and out = acc / max(l, 1e-30) in bf16: no running max, as in K1.  S_q and
// S_k must be multiples of the 64-key tile (the wrapper raises otherwise;
// JAX leaves the rows past the last whole block unwritten).
//
// What bounds it on an H100: the tensor cores.  At B=2, N=24, S=8448 the QK^T
// is 8.8e11 int8 operations (0.443 ms at 1,979 TOP/s) and PV 8.8e11 bf16 FLOP
// (0.887 ms at 989 TFLOP/s): 1.330 ms, against 1.773 for K1's two bf16
// products.  Design: K1's loop (fixedmax_attention.cu): one block of 4 warps
// per 64-row q tile, the warp's 16 query rows as mma.sync A fragments in
// registers (int8: 16 registers, half of K1's), K tiles of 64 keys staged in
// shared memory as int8 (8 KB, half of bf16) beside the V tile, the key
// scales and the key bias (64 floats each).  QK^T is mma.sync m16n8k32 s8;
// its int32 C fragment has the (g, 2t) layout of the fp32 C fragment of
// m16n8k16, so P stays in registers as the A operand of the bf16 PV product,
// as in K1.  Not done: TMA, wgmma, a multi-stage copy pipeline.
#include "mma_bf16.cuh"
#include "mma_int8.cuh"

using namespace physicedit;

namespace {

constexpr float kClampValue = 100.f;
constexpr int kRowBytes = kHeadDim + 16;  // int8 bytes per smem row: a warp's
                                          // fragment loads hit 32 distinct banks

// Copy int8 rows [row0, row0 + 64) of a [rows, 128] matrix into smem with
// kRowBytes; 16 bytes per thread per step.
__device__ __forceinline__ void load_tile_i8(int8_t* smem, const int8_t* base, int row0) {
#pragma unroll
  for (int it = 0; it < (kBlockK * kHeadDim / 16) / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx >> 3;
    const int c = (idx & 7) * 16;
    *reinterpret_cast<int4*>(smem + r * kRowBytes + c) =
        *reinterpret_cast<const int4*>(base + (long)(row0 + r) * kHeadDim + c);
  }
}

__global__ void __launch_bounds__(kThreads)
int8qk_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
              const uint16_t* __restrict__ v, const float* __restrict__ q_scale,
              const float* __restrict__ k_scale, const float* __restrict__ key_bias,
              uint16_t* __restrict__ out, int n_heads, int sq, int sk) {
  __shared__ __align__(16) int8_t k8[kBlockK * kRowBytes];
  __shared__ __align__(16) uint16_t vs[kBlockK * kRowStride];
  __shared__ float ks_s[kBlockK];
  __shared__ float bias_s[kBlockK];

  const int q0 = blockIdx.x * kBlockQ;
  const long bh = (long)blockIdx.z * n_heads + blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;

  // Stage the q tile through the K buffer into registers: 4 chunks of 32 k.
  load_tile_i8(k8, q + bh * sq * kHeadDim, q0);
  __syncthreads();
  uint32_t qa[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int8_t* r0 = k8 + (wr + g) * kRowBytes + kc * 32 + 4 * t;
    const int8_t* r8 = r0 + 8 * kRowBytes;
    qa[kc][0] = *reinterpret_cast<const uint32_t*>(r0);
    qa[kc][1] = *reinterpret_cast<const uint32_t*>(r8);
    qa[kc][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
    qa[kc][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
  }
  __syncthreads();
  const int rg = q0 + wr + g;
  const float qs_g = q_scale[bh * sq + rg];
  const float qs_g8 = q_scale[bh * sq + rg + 8];

  float acc[16][4];
#pragma unroll
  for (int jd = 0; jd < 16; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;
  float l_g = 0.f, l_g8 = 0.f;

  const int8_t* kb = k + bh * sk * kHeadDim;
  const uint16_t* vb = v + bh * sk * kHeadDim;
  const float* ksb = k_scale + bh * sk;
  const float* bb = key_bias + (long)blockIdx.z * sk;

  for (int k0 = 0; k0 < sk; k0 += kBlockK) {
    load_tile_i8(k8, kb, k0);
    load_tile(vs, vb, kHeadDim, k0, sk);
    if (threadIdx.x < kBlockK) {
      ks_s[threadIdx.x] = ksb[k0 + threadIdx.x];
      bias_s[threadIdx.x] = bb[k0 + threadIdx.x];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int si[4] = {0, 0, 0, 0};
      const int8_t* krow = k8 + (8 * j + g) * kRowBytes + 4 * t;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kc * 32);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kc * 32 + 16);
        mma_s8_16832(si, qa[kc], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        float x = __fmul_rn(__fmul_rn(__int2float_rn(si[e]), e < 2 ? qs_g : qs_g8), ks_s[c]);
        x = __fadd_rn(x, bias_s[c]);
        const float p = exp2f(fminf(x, kClampValue));
        s[j][e] = p;
        if (e < 2) l_g += p; else l_g8 += p;
      }
    }
    pv_tile(acc, s, vs, g, t);
    __syncthreads();
  }

  l_g = quad_sum(l_g);
  l_g8 = quad_sum(l_g8);
  store_rows(out, (bh * sq + rg) * kHeadDim, (bh * sq + rg + 8) * kHeadDim, true, true, acc,
             l_g, l_g8, t);
}

}  // namespace

// q/k [B, N, S, 128] int8 codes, v [B, N, Sk, 128] bf16, q_scale [B, N, Sq] and
// k_scale [B, N, Sk] fp32 (each times sqrt(log2(e) / sqrt(128))), key_bias
// [B, Sk] fp32, out [B, N, Sq, 128] bf16; all contiguous; Sq % 64 == 0 and
// Sk % 64 == 0.
extern "C" int proto_int8qk_attention_bf16(const void* q, const void* k, const void* v,
                                           const void* q_scale, const void* k_scale,
                                           const void* key_bias, void* out, int batch,
                                           int heads, int sq, int sk, void* stream) {
  if (sq % kBlockQ != 0 || sk % kBlockK != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(sq / kBlockQ, heads, batch);
  int8qk_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const float*>(q_scale),
      static_cast<const float*>(k_scale), static_cast<const float*>(key_bias),
      static_cast<uint16_t*>(out), heads, sq, sk);
  return static_cast<int>(cudaGetLastError());
}
